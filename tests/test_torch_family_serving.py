"""The rest of the decoder family through the port's InferenceServer on
the CPU against the reference's server: the same smoke config, weights,
adapters and staggered trace (test_torch_serving's), and every request's
greedy tokens equal. qwen2-72b (q/k/v bias), mistral-large-123b and
dbrx-132b (MoE: prefill routes each padded sequence, decode all
max_batch rows, frozen and empty ones too) under BGMV, grok-1-314b (MoE,
GeGLU) under MBGMV. Also `--arch` on the serve CLI for every new
config."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro.serving.request import Request as JReq  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.request import Request as TReq  # noqa: E402
from test_torch_serving import _pair, _tokens, _trace  # noqa: E402

NEW_ARCHS = ["llama2-13b", "llama2-70b", "qwen2-72b", "command-r-35b",
             "mistral-large-123b", "dbrx-132b", "grok-1-314b"]


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
