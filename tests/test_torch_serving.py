"""The port's serving path (repro_torch.core.engine.InferenceServer on the
CPU) against the reference's InferenceServer: same config
(llama2-7b-smoke), same weights, same adapters — both built in this one
process, so the hash-seeded adapter weights agree — and the same trace.
Token streams must be identical per request. Also the port's own
invariants (megastep = single steps, preemption resumes token-exact), the
import guard, and the entry points' device rules. The port's server is
given the reference's timeline hardware (its V5E constants, passed in),
so both servers batch and megastep on identical simulated clocks."""
import ast
import dataclasses
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
from repro.core.timing import V5E  # noqa: E402
from repro.serving.request import Request as JReq  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core.engine import InferenceServer as TServer  # noqa: E402
from repro_torch.core.lora import AdapterSpec as TSpec  # noqa: E402
from repro_torch.core.timing import Hardware  # noqa: E402
from repro_torch.models.weights import init_params, params_from_jax  # noqa: E402,E501
from repro_torch.serving.request import Request as TReq  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANKS = (8, 4, 2, 8)
# the reference's timeline hardware, for the port's servers held to it
REF_HW = Hardware(**dataclasses.asdict(V5E))


def _pair(kernel="bgmv", ranks=RANKS, arch="llama2-7b", kv="",
          max_rank=None, **kw):
    """A reference server and a port server with the same weights,
    adapters and timeline hardware; kv="int8" quantizes both KV caches;
    `max_rank` pads both adapter pools to that rank."""
    cj, ct = jget(arch).smoke(), tget(arch).smoke()
    cj = dataclasses.replace(cj, kv_cache_dtype=kv)
    ct = dataclasses.replace(ct, kv_cache_dtype=kv)
    if max_rank is not None:
        cj = dataclasses.replace(cj, lora=dataclasses.replace(
            cj.lora, max_rank=max_rank))
        ct = dataclasses.replace(ct, lora=dataclasses.replace(
            ct.lora, max_rank=max_rank))
    kw = dict({"mode": "caraserve", "kernel": kernel, "max_batch": 4,
               "cache_slots": 64, "seed": 0}, **kw)
    js = JServer(cj, **kw)
    ts = TServer(ct, device="cpu", hw=REF_HW,
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


@pytest.mark.parametrize("kernel", ["bgmv", "mbgmv"])
def test_yi9b_server_tokens_match_reference(kernel):
    """yi-9b-smoke (GQA group 2, k/v LoRA deltas KV * hd wide) through the
    same staggered trace: every request's tokens equal the reference's."""
    js, ts = _pair(kernel, arch="yi-9b")
    trace = _trace(seed=2)
    js.run([JReq(*t) for t in trace])
    ts.run([TReq(*t) for t in trace])
    assert _tokens(ts) == _tokens(js)
    assert all(len(s.generated) == s.req.max_new_tokens for s in ts.states)


@pytest.mark.parametrize("kernel", ["bgmv", "mbgmv"])
def test_server_tokens_match_reference_at_max_rank_48(kernel):
    """A pool padded to max_rank 48, a multiple of 8 and no power-of-two
    multiple of it (the kernels take it since their rank reduction was
    generalised), with adapters of ranks up to 48: tokens equal the
    reference's."""
    js, ts = _pair(kernel, ranks=(48, 20, 8, 33), max_rank=48)
    assert ts.cfg.lora.max_rank == 48
    trace = _trace(seed=5)
    js.run([JReq(*t) for t in trace])
    ts.run([TReq(*t) for t in trace])
    assert _tokens(ts) == _tokens(js)
    assert all(len(s.generated) == s.req.max_new_tokens for s in ts.states)


def _long_trace(seed=4):
    """Prompts of 12-44 tokens (three above a 16-token chunk budget, the
    last chunk of each partial), staggered so chunks ride decode steps."""
    rng = np.random.default_rng(seed)
    return [(i, f"ad{i % 4}", rng.integers(0, 512, n).astype(np.int32), m,
             float(6 * i))
            for i, (n, m) in enumerate([(30, 8), (44, 6), (12, 9), (25, 7),
                                        (14, 5)])]


@pytest.mark.parametrize("arch", ["yi-9b", "llama2-7b"])
def test_chunked_server_tokens_match_reference_and_monolithic(arch):
    """chunk_budget 16 below the longest prompt: the port's chunked server
    gives the reference's chunked server's tokens and the port's own
    monolithic tokens (interference control changes the timeline, never
    the numerics)."""
    kw = dict(arch=arch, page_size=16, megastep=0)
    js, ts = _pair(chunk_budget=16, **kw)
    _, mono = _pair(**kw)
    trace = _long_trace()
    js.run([JReq(*t) for t in trace])
    ts.run([TReq(*t) for t in trace])
    mono.run([TReq(*t) for t in trace])
    assert ts.backend.transfer_stats["prefill_chunks"] > 0
    assert mono.backend.transfer_stats["prefill_chunks"] == 0
    assert _tokens(ts) == _tokens(js)
    assert _tokens(ts) == _tokens(mono)
    assert all(len(s.generated) == s.req.max_new_tokens for s in ts.states)


def _chunked_port_server(chunk_budget, prompt_len, max_new=2):
    """The reference test's server (llama2-7b-smoke, f32, cached mode,
    paged pool of 16-token pages) on the port, one request;
    chunk_budget=0 is the monolithic arm."""
    ct = tget("llama2-7b").smoke()
    ts = TServer(ct, mode="cached", max_batch=4, cache_slots=64, seed=0,
                 device="cpu", pipeline="fused", megastep=0,
                 memory="paged", page_size=16, chunk_budget=chunk_budget)
    ts.register_adapter(TSpec("ad0", 8, ct.name))
    prompt = np.random.default_rng(23).integers(0, ct.vocab, prompt_len)
    ts.run([TReq(0, "ad0", prompt.astype(np.int32), max_new, 0.0)])
    return ts


@pytest.mark.parametrize("prompt_len,n_chunks", [(24, 2), (61, 4)])
def test_chunked_prefill_kv_bitwise_matches_monolithic(prompt_len,
                                                       n_chunks):
    """The property of the reference's
    test_chunked_prefill_bitwise_matches_monolithic, held on the port: a
    prompt prefilled in 16-token chunks (the last one partial) leaves the
    same tokens and, gathered into position order, bitwise the same K/V
    in its pages as one monolithic prefill. One request per server, so
    its pages are never reused after it retires."""
    from repro_torch.serving.cache import gather_pages
    chunk = _chunked_port_server(16, prompt_len)
    mono = _chunked_port_server(0, prompt_len)
    assert chunk.backend.transfer_stats["prefill_chunks"] == n_chunks
    assert mono.backend.transfer_stats["prefill_chunks"] == 0
    (a,), (b,) = mono.states, chunk.states
    assert len(a.generated) == a.req.max_new_tokens
    assert a.generated == b.generated
    ga = gather_pages(mono.backend.cache, a.kv_pages)
    gb = gather_pages(chunk.backend.cache, b.kv_pages)
    assert torch.equal(ga["pos"], gb["pos"])
    assert int((ga["pos"][0] >= 0).sum()) >= prompt_len
    written = (ga["pos"] >= 0)[:, :, None, :, None]
    for leaf in ("k", "v"):
        assert torch.equal(torch.where(written, ga[leaf], 0),
                           torch.where(written, gb[leaf], 0)), leaf


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_half_prefilled_row_preempted_resumes_token_exact(policy):
    """A 48-token prompt in 16-token chunks is preempted after two chunks
    (swap keeps its chunk progress and restores the written pages;
    recompute restarts the prompt) and still emits exactly the tokens of
    an uninterrupted run."""
    def run(preempt_after):
        ct = tget("yi-9b").smoke()
        ts = TServer(ct, mode="cached", max_batch=4, cache_slots=64,
                     seed=0, device="cpu", memory="paged", page_size=16,
                     preempt=policy, chunk_budget=16)
        ts.register_adapter(TSpec("ad0", 8, ct.name))
        prompt = np.random.default_rng(9).integers(0, 512, 48)
        st = ts.submit(TReq(0, "ad0", prompt.astype(np.int32), 5, 0.0))
        for _ in range(preempt_after):
            ts.step()
        if preempt_after:
            assert st.phase == "prefill" and st.prefill_pos == 32
            ts._preempt(st)
            assert st.prefill_pos == (32 if policy == "swap" else 0)
        while ts.busy() or ts.queue:
            ts.step()
        ts.backend.flush_readback()
        assert st.prefill_pos == 48
        return st, ts

    want, _ = run(0)
    st, ts = run(2)
    assert st.preemptions == 1
    assert ts.preempt_stats[f"{policy}_preemptions"] == 1
    assert st.generated == want.generated
    assert len(st.generated) == 5


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
                 preempt=policy, hw=REF_HW,
                 params=params_from_jax(ct, tree, device="cpu"))
    ts.register_adapter(TSpec("ad0", 8, ct.name))
    ts.run([TReq(*t) for t in _oversub_trace()])
    assert ts.preempt_stats["preemptions"] > 0
    key = "swapped_pages" if policy == "swap" else "recompute_tokens"
    assert ts.preempt_stats[key] > 0
    assert _tokens(ts) == want
    assert ts.allocator.owned_by("kv:") == []


@pytest.mark.parametrize("kw", [{"memory": "dense"}, {"kv": "int8"},
                                {"pipeline": "perstep"},
                                {"temperature": 0.7},
                                {"temperature": 0.7, "memory": "dense"}],
                         ids=["dense", "int8", "perstep", "temperature",
                              "temperature-dense"])
def test_serving_options_construct_and_run(kw):
    """The dense plane, int8 KV (which `memory="auto"` puts on the dense
    plane, as the reference does), the per-step pipeline and temperature
    sampling: each server starts, serves the trace, and every request
    finishes with its tokens."""
    kw = dict(kw)
    ct = dataclasses.replace(tget("llama2-7b").smoke(),
                             kv_cache_dtype=kw.pop("kv", ""))
    ts = TServer(ct, max_batch=4, cache_slots=64, seed=0, device="cpu",
                 **kw)
    want = "dense" if ct.kv_cache_dtype or "memory" in kw \
        or "pipeline" in kw else "paged"
    assert ts.memory == want
    for i, r in enumerate(RANKS):
        ts.register_adapter(TSpec(f"ad{i}", r, ct.name))
    ts.run([TReq(*t) for t in _trace(n=4)])
    assert all(len(s.generated) == s.req.max_new_tokens for s in ts.states)


@pytest.mark.parametrize("kw", [{"pipeline": "perstep", "temperature": 0.7},
                                {"pipeline": "perstep", "memory": "paged"}],
                         ids=["perstep-temperature", "perstep-paged"])
def test_refused_combinations_raise_like_reference(kw):
    """The per-step baseline is greedy-only and rides the dense plane: the
    port refuses what the reference refuses, with a ValueError."""
    with pytest.raises(ValueError):
        JServer(jget("llama2-7b").smoke(), max_batch=2, cache_slots=64,
                **kw)
    with pytest.raises(ValueError):
        TServer(tget("llama2-7b").smoke(), max_batch=2, cache_slots=64,
                device="cpu", **kw)


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
