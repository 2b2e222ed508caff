"""The port's roofline utilities (repro_torch.roofline) against the
reference's: its three tests through both packages (the HLO collective
parser, the terms and their dominance at the reference's TPU v5e
constants passed in explicitly, the MODEL_FLOPS conventions), the H100
data-sheet defaults, and the counter of recorded collectives."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import roofline as jroof  # noqa: E402
from repro.configs.base import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro_torch import roofline as troof  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core.timing import H100  # noqa: E402

HLO = """
ENTRY %main {
  %ag = bf16[8,512,1024]{2,1,0} all-gather(%p0), replica_groups=...
  %ar.1 = f32[256,128]{1,0} all-reduce(%x), to_apply=%add
  %rs = bf16[4,64]{1,0} reduce-scatter(%y), dimensions={0}
  %a2a = (bf16[2,8]{1,0}, bf16[2,8]{1,0}) all-to-all(%a, %b)
  %cp = u8[1024]{0} collective-permute(%z), source_target_pairs=...
  %dot = f32[8,8]{1,0} dot(%q, %k)
}
"""
V5E = dict(peak=jroof.PEAK_FLOPS, bw=jroof.HBM_BW, link=jroof.LINK_BW)


def test_collective_bytes_parsing():
    got = troof.collective_bytes(HLO)
    assert got == jroof.collective_bytes(HLO)
    assert got["all-gather"] == 8 * 512 * 1024 * 2
    assert got["all-reduce"] == 256 * 128 * 4 * 2          # 2x factor
    assert got["reduce-scatter"] == 4 * 64 * 2
    assert got["all-to-all"] == 2 * (2 * 8 * 2)            # tuple: both elems
    assert got["collective-permute"] == 1024


def test_roofline_terms_dominance():
    for args in ((197e12, 0.0, 0.0, 256), (0.0, 819e9, 1e9, 1),
                 (0.0, 0.0, 50e9, 1), (3e12, 2e9, 4e8, 16)):
        assert troof.roofline_terms(*args, **V5E) == \
            jroof.roofline_terms(*args)
    t = troof.roofline_terms(197e12, 0.0, 0.0, 256, **V5E)
    assert t["dominant"] == "compute" and t["compute_s"] == pytest.approx(1.0)
    t = troof.roofline_terms(0.0, 819e9, 1e9, 1, **V5E)
    assert t["dominant"] == "memory" and t["memory_s"] == pytest.approx(1.0)
    t = troof.roofline_terms(0.0, 0.0, 50e9, 1, **V5E)
    assert t["dominant"] == "collective"
    assert t["collective_s"] == pytest.approx(1.0)
    t = troof.roofline_terms(0.0, 0.0, 100e9, 4, per_device=False, **V5E)
    assert t == jroof.roofline_terms(0.0, 0.0, 100e9, 4, per_device=False)


def test_model_flops_conventions():
    for arch in ("llama2-7b", "grok-1-314b", "dbrx-132b", "mamba2-130m",
                 "whisper-tiny"):
        for name, shape in INPUT_SHAPES.items():
            assert troof.model_flops(tget(arch), shape) == \
                jroof.model_flops(jget(arch), J_SHAPES[name])
    cfg = tget("llama2-7b")
    n = cfg.active_param_count()
    assert troof.model_flops(cfg, INPUT_SHAPES["train_4k"]) == \
        pytest.approx(6 * n * 256 * 4096)
    assert troof.model_flops(cfg, INPUT_SHAPES["prefill_32k"]) == \
        pytest.approx(2 * n * 32 * 32768)
    assert troof.model_flops(cfg, INPUT_SHAPES["decode_32k"]) == \
        pytest.approx(2 * n * 128)
    g = tget("grok-1-314b")            # MoE: active parameters
    assert troof.model_flops(g, INPUT_SHAPES["decode_32k"]) < \
        2 * g.param_count() * 128


def test_h100_defaults():
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == \
        (989e12, 3.35e12, 50e9)
    assert troof.PEAK_FLOPS == H100.peak_flops
    t = troof.roofline_terms(989e12, 3.35e12, 50e9, 8)
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0


def test_comm_bytes_counts_an_all_reduce_twice():
    got = troof.comm_bytes([("all-reduce", 100), ("all-to-all", 64),
                            ("all-gather", 8), ("all-reduce", 1)])
    assert got == {"all-gather": 8, "all-reduce": 202, "reduce-scatter": 0,
                   "all-to-all": 64, "collective-permute": 0}
