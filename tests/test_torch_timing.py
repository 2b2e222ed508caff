"""The port's analytic timing model: its default hardware is the card the
port runs on (an H100 SXM5 80GB), and given the reference's hardware
constants it returns the reference's times exactly, so the serving parity
tests can pin both timelines to one clock. No file of the port carries
the reference's TPU constants."""
import dataclasses
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import timing as jtiming  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import timing as ttiming  # noqa: E402
from repro_torch.core.engine import InferenceServer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ["llama2-7b", "yi-9b"])
def test_reference_constants_give_reference_times(arch):
    hw = ttiming.Hardware(**dataclasses.asdict(jtiming.V5E))
    tm = ttiming.TimingModel(tget(arch), hw)
    ref = jtiming.TimingModel(jget(arch), jtiming.V5E)
    for n in (1, 128, 3000):
        assert tm.base_prefill_ms(n) == ref.base_prefill_ms(n)
        assert tm.chunk_prefill_ms(n, 512) == ref.chunk_prefill_ms(n, 512)
        assert tm.cpu_lora_prefill_ms(n, 64) == ref.cpu_lora_prefill_ms(n,
                                                                        64)
        assert tm.lora_prefill_gpu_ms(n, 16) == ref.lora_prefill_gpu_ms(n,
                                                                        16)
    for batch, ctx in ((1, 128), (8, 512), (32, 4096)):
        assert tm.base_decode_ms(batch, ctx) == ref.base_decode_ms(batch,
                                                                   ctx)
        assert tm.mixed_step_ms(batch, ctx, 64, 100) == \
            ref.mixed_step_ms(batch, ctx, 64, 100)
    for ranks in ([8], [8, 16, 64, 64], [4] * 32):
        for kernel in ("bgmv", "mbgmv"):
            assert tm.lora_decode_ms(ranks, kernel) == \
                ref.lora_decode_ms(ranks, kernel)
        assert tm.cpu_lora_decode_ms(ranks) == ref.cpu_lora_decode_ms(ranks)
    assert tm.load_ms(100 << 20) == ref.load_ms(100 << 20)


def test_default_hardware_is_the_h100():
    hw = ttiming.Hardware()
    assert hw == ttiming.H100
    assert hw.name == "h100-sxm5-80gb"
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_bytes) == (989e12, 3.35e12,
                                                        80e9)
    cfg = tget("llama2-7b")
    assert ttiming.TimingModel(cfg).hw == hw
    assert InferenceServer(cfg, numerics=False).tm.hw == hw
    # the card moves a decode step's weights ~4x faster than the
    # reference's timeline hardware
    tm = ttiming.TimingModel(cfg)
    ref = jtiming.TimingModel(jget("llama2-7b"))
    assert tm.base_decode_ms(8) < ref.base_decode_ms(8)


def test_port_carries_no_tpu_constants():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 20
    bad = [str(f.relative_to(ROOT)) for f in files
           if "v5e" in f.read_text().lower()]
    assert bad == []
