"""The rest of the decoder family through the port's InferenceServer on
the CPU against the reference's server: the same smoke config, weights,
adapters and staggered trace (test_torch_serving's), and every request's
greedy tokens equal. qwen2-72b (q/k/v bias), mistral-large-123b and
dbrx-132b (MoE: prefill routes each padded sequence, decode all
max_batch rows, frozen and empty ones too) under BGMV, grok-1-314b (MoE,
GeGLU) under MBGMV; mamba2-130m and recurrentgemma-2b on the dense plane
and phi-3-vision-4.2b on the paged plane (text-only requests, as the
reference's server sends), each under BGMV and MBGMV. Also the
reference's bucket-padding dependence of the recurrent families,
reproduced, and `--arch` on the serve CLI for every new config."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro.serving.request import Request as JReq  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.request import Request as TReq  # noqa: E402
from test_torch_serving import _pair, _tokens, _trace  # noqa: E402

NEW_ARCHS = ["llama2-13b", "llama2-70b", "qwen2-72b", "command-r-35b",
             "mistral-large-123b", "dbrx-132b", "grok-1-314b",
             "phi-3-vision-4.2b", "recurrentgemma-2b", "mamba2-130m"]


@pytest.mark.parametrize("arch,kernel,seed", [
    ("qwen2-72b", "bgmv", 5), ("mistral-large-123b", "bgmv", 6),
    ("dbrx-132b", "bgmv", 7), ("grok-1-314b", "mbgmv", 8)])
def test_family_server_tokens_match_reference(arch, kernel, seed):
    js, ts = _pair(kernel, arch=arch)
    trace = _trace(seed=seed)
    js.run([JReq(*t) for t in trace])
    ts.run([TReq(*t) for t in trace])
    assert _tokens(ts) == _tokens(js)
    assert ts.backend.transfer_stats["megasteps"] > 0
    assert all(len(s.generated) == s.req.max_new_tokens for s in ts.states)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_cli_takes_new_arch_on_cpu(arch, capsys):
    serve.main(["--smoke", "--arch", arch, "--device", "cpu", "--duration",
                "0.5", "--rps", "4", "--cache-slots", "64",
                "--n-adapters", "2"])
    out = capsys.readouterr().out
    assert "simulated serving metrics" in out
    n = int(out.split()[0])
    assert n > 0 and f"n                {n}" in out


@pytest.mark.parametrize("arch,memory", [
    ("mamba2-130m", "dense"), ("recurrentgemma-2b", "dense"),
    ("phi-3-vision-4.2b", "paged")])
@pytest.mark.parametrize("kernel", ["bgmv", "mbgmv"])
def test_recurrent_and_vlm_server_tokens_match_reference(arch, memory,
                                                         kernel):
    """The staggered trace (prompts of 4-15 tokens, ragged in each packed
    prefill; several longer than the hybrid smoke's 8-token window) on
    the plane `memory="auto"` picks, in both packages: every request's
    greedy tokens equal the reference's."""
    js, ts = _pair(kernel, arch=arch)
    assert ts.memory == js.memory == memory
    trace = _trace(seed=9)
    assert max(len(t[2]) for t in trace) > 8
    js.run([JReq(*t) for t in trace])
    ts.run([TReq(*t) for t in trace])
    assert _tokens(ts) == _tokens(js)
    assert all(len(s.generated) == s.req.max_new_tokens for s in ts.states)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_bucket_padding_layouts_match_reference(arch):
    """A 16-token prompt served alone (a 16-token bucket, no padding) and
    the same prompt beside a 30-token one (a 32-token bucket: 16 pad
    tokens of id 0 after it). In both packages the two layouts give
    different streams from the second token on, because the reference's
    `_mask_pad_slots` invalidates only the `pos` leaves of the packed
    prefill's caches: the recurrent state (SSM state and conv tail,
    RG-LRU h, the local-attention ring) keeps what the pad tokens wrote.
    That is a fault of the reference (ROADMAP.md section 3) which the
    port reproduces, since its yardstick is the reference's tokens: the
    port's stream equals the reference's in each layout."""
    rng = np.random.default_rng(11)
    short = rng.integers(1, 512, 16).astype(np.int32)
    long_ = rng.integers(1, 512, 30).astype(np.int32)
    streams = {}
    for layout, reqs in (("alone", [(0, "ad0", short, 8, 0.0)]),
                         ("beside", [(0, "ad0", short, 8, 0.0),
                                     (1, "ad1", long_, 8, 0.0)])):
        js, ts = _pair("bgmv", arch=arch)
        js.run([JReq(*r) for r in reqs])
        ts.run([TReq(*r) for r in reqs])
        assert _tokens(ts) == _tokens(js), layout
        streams[layout] = _tokens(ts)[0]
    assert streams["alone"][0] == streams["beside"][0]


def test_serve_cli_explains_why_whisper_is_not_served(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--arch", "whisper-tiny", "--device", "cpu"])
    assert "enc_embeds" in capsys.readouterr().err
