"""The port's serving path (repro_torch.core.engine.InferenceServer on the
CPU) against the reference's InferenceServer: same config
(llama2-7b-smoke), same weights, same adapters — both built in this one
process, so the hash-seeded adapter weights agree — and the same trace.
Token streams must be identical per request. Also the port's own
invariants (megastep = single steps, preemption resumes token-exact), the
import guard, and the entry points' device rules."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-sized ops: one intra-op thread avoids oversubscribing the cores the
# reference (XLA) and the other test workers share
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core.engine import InferenceServer as JServer  # noqa: E402
from repro.core.lora import AdapterSpec as JSpec  # noqa: E402
from repro.serving.request import Request as JReq  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core.engine import InferenceServer as TServer  # noqa: E402
from repro_torch.core.lora import AdapterSpec as TSpec  # noqa: E402
from repro_torch.models.weights import init_params, params_from_jax  # noqa: E402,E501
from repro_torch.serving.request import Request as TReq  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANKS = (8, 4, 2, 8)


def _pair(kernel="bgmv", ranks=RANKS, **kw):
    """A reference server and a port server with the same weights and
    adapters."""
    cj, ct = jget("llama2-7b").smoke(), tget("llama2-7b").smoke()
    kw = dict(mode="caraserve", kernel=kernel, max_batch=4, cache_slots=64,
              seed=0, **kw)
    js = JServer(cj, **kw)
    ts = TServer(ct, device="cpu",
                 params=params_from_jax(ct, jax.tree.map(np.asarray,
                                                         js.params),
                                         device="cpu"), **kw)
    for i, r in enumerate(ranks):
        js.register_adapter(JSpec(f"ad{i}", r, cj.name))
        ts.register_adapter(TSpec(f"ad{i}", r, ct.name))
    return js, ts


def _trace(n=6, seed=1, n_adapters=4):
    rng = np.random.default_rng(seed)
    return [(i, f"ad{i % n_adapters}",
             rng.integers(0, 512, int(rng.integers(4, 16))).astype(np.int32),
             int(rng.integers(3, 14)), float(i * 3)) for i in range(n)]


def _tokens(srv):
    return {s.req.rid: s.generated for s in srv.states}


@pytest.mark.parametrize("kernel", ["bgmv", "mbgmv"])
def test_server_tokens_match_reference(kernel):
    """Staggered arrivals over mixed-rank adapters: packed prefills,
    decode with rows joining and leaving (inactive rows carry slot -1),
    megasteps; every request's tokens equal the reference's."""
    js, ts = _pair(kernel)
    trace = _trace()
    js.run([JReq(*t) for t in trace])
    ts.run([TReq(*t) for t in trace])
    assert _tokens(ts) == _tokens(js)
    assert ts.backend.transfer_stats["megasteps"] > 0
    assert all(len(s.generated) == s.req.max_new_tokens for s in ts.states)


def _port(**kw):
    ct = tget("llama2-7b").smoke()
    ts = TServer(ct, mode="caraserve", max_batch=4, cache_slots=64, seed=0,
                 device="cpu", **kw)
    for i, r in enumerate(RANKS):
        ts.register_adapter(TSpec(f"ad{i}", r, ct.name))
    return ts


def test_megastep_equals_single_steps():
    trace = _trace(n=6, seed=3)
    fused, single = _port(megastep=8), _port(megastep=0)
    fused.run([TReq(*t) for t in trace])
    single.run([TReq(*t) for t in trace])
    assert fused.backend.transfer_stats["megasteps"] > 0
    assert single.backend.transfer_stats["megasteps"] == 0
    assert _tokens(fused) == _tokens(single)


def _oversub_trace(n=2, prompt_len=10, max_new=40, seed=7):
    rng = np.random.default_rng(seed)
    return [(i, "ad0", rng.integers(0, 512, prompt_len).astype(np.int32),
             max_new, 0.0) for i in range(n)]


@pytest.fixture(scope="module")
def roomy_reference():
    """The reference's uninterrupted run of the over-subscription trace
    (its own test_paged scenario), and the weights it ran with."""
    js, _ = _pair(ranks=(8,), memory="paged", page_size=32, total_pages=12)
    js.run([JReq(*t) for t in _oversub_trace()])
    return _tokens(js), jax.tree.map(np.asarray, js.params)


@pytest.mark.parametrize("policy", ["recompute", "swap"])
def test_preemption_resume_matches_uninterrupted_reference(roomy_reference,
                                                           policy):
    """A pool too small for both rows' growth preempts mid-decode; the
    resumed request (re-prefilled, or its pages swapped back) still emits
    exactly the reference's uninterrupted tokens."""
    want, tree = roomy_reference
    ct = tget("llama2-7b").smoke()
    ts = TServer(ct, mode="caraserve", max_batch=4, cache_slots=64, seed=0,
                 device="cpu", memory="paged", page_size=32, total_pages=4,
                 preempt=policy,
                 params=params_from_jax(ct, tree, device="cpu"))
    ts.register_adapter(TSpec("ad0", 8, ct.name))
    ts.run([TReq(*t) for t in _oversub_trace()])
    assert ts.preempt_stats["preemptions"] > 0
    key = "swapped_pages" if policy == "swap" else "recompute_tokens"
    assert ts.preempt_stats[key] > 0
    assert _tokens(ts) == want
    assert ts.allocator.owned_by("kv:") == []


def test_unported_options_raise():
    ct = tget("llama2-7b").smoke()
    for kw in ({"chunk_budget": 8}, {"memory": "dense"},
               {"pipeline": "perstep"}, {"temperature": 0.7}):
        with pytest.raises(NotImplementedError):
            TServer(ct, max_batch=2, cache_slots=64, device="cpu", **kw)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    from repro_torch.launch import serve
    ct = tget("llama2-7b").smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TServer(ct, max_batch=2, cache_slots=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--duration", "0.5"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(ct)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(ct, {})
    # a timing-only server touches no device
    TServer(ct, max_batch=2, numerics=False)


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--device", "cpu", "--duration", "1", "--rps",
                "4", "--cache-slots", "64", "--n-adapters", "2"])
    out = capsys.readouterr().out
    assert "simulated serving metrics" in out


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """chip_smoke.py prints no result and exits non-zero when the card is
    missing, and when it stands alone without the package."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, str(alone)], capture_output=True,
                       text=True, cwd=tmp_path, env=env, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
