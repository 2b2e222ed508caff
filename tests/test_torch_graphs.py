"""The port's compiled decode step on the CPU: `core.graphs.StepGraphs`
(the counterpart of the reference's jitted, donated `decode` /
`megastep[K=k]`), the backend's step state written in place, and the
re-capture watch `analysis.retrace.RetraceSan` (ported from the
reference's `tests/test_sanitizers.py` RetraceSan cases, without JAX).

On the CPU nothing is captured, but every signature is taken and watched
as on the card: a buffer that moved would show here as a second build of
its key. The port's tokens with `graphs=True` are held to the
reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core.engine import InferenceServer as JServer  # noqa: E402
from repro.core.lora import AdapterSpec as JSpec  # noqa: E402
from repro.core.timing import V5E  # noqa: E402
from repro.serving.request import Request as JReq  # noqa: E402
from repro_torch.analysis import sanitizers  # noqa: E402
from repro_torch.analysis.retrace import RetraceError, RetraceSan  # noqa: E402,E501
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.engine import InferenceServer  # noqa: E402
from repro_torch.core.graphs import StepGraphs, leaves  # noqa: E402
from repro_torch.core.lora import AdapterSpec  # noqa: E402
from repro_torch.core.timing import Hardware  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

REF_HW = Hardware(**dataclasses.asdict(V5E))
PIPE = ("last_tok", "pos", "target", "active", "idx", "block_table")


def _addresses(be):
    """The address of every tensor the captured steps read, by name: the
    pipeline's buffers, the KV plane, the LoRA pool and the prefill's
    staging pool (a bucket's static inputs are checked as they appear)."""
    out = {f"pipe.{n}": getattr(be.pipe, n).data_ptr() for n in PIPE
           if getattr(be.pipe, n) is not None}
    out.update({f"cache[{i}]": t.data_ptr()
                for i, t in enumerate(leaves(be.cache))})
    out.update({f"pool[{i}]": t.data_ptr()
                for i, t in enumerate(leaves(be.pool.pool))})
    out.update({f"stage[{i}]": t.data_ptr()
                for i, t in enumerate(leaves(be.stage))})
    return out


def _server(memory="paged", **kw):
    cfg = get_config("llama2-7b").smoke()
    srv = InferenceServer(cfg, mode="caraserve", max_batch=4,
                          cache_slots=64, seed=0, device="cpu",
                          memory=memory, page_size=32, hw=REF_HW, **kw)
    for i, r in enumerate((8, 4, 2, 8)):
        srv.register_adapter(AdapterSpec(f"ad{i}", r, cfg.name))
    return srv


def _requests(cfg, n=6, seed=1):
    """Rows of 8-29 prompt tokens and 20-33 new ones, 3 ms apart: they
    cross page boundaries (a 6-page pool swaps) and stay in 64 slots."""
    rng = np.random.default_rng(seed)
    return [Request(i, f"ad{i % 4}",
                    rng.integers(0, cfg.vocab, int(rng.integers(8, 30))
                                 ).astype(np.int32),
                    int(rng.integers(20, 34)), 3.0 * i)
            for i in range(n)]


@pytest.mark.parametrize("memory,extra", [
    ("paged", dict(total_pages=6, preempt="swap")),
    ("dense", {}),
    ("paged", dict(chunk_budget=16))])
def test_step_buffers_keep_their_storage(memory, extra):
    """Every buffer the steps read keeps its address across decode,
    megastep, a refresh with a changed batch, prefill, prefill chunks,
    swap-in (paged) and adapter loads, the staging pool and each bucket's
    static inputs included; so every graph key (decode, megastep,
    prefill[...], prefill_chunk[...], prefill_chunk_final[...]) is built
    once."""
    srv = _server(memory, **extra)
    be = srv.backend
    want = _addresses(be)
    inputs = {}
    seen = []

    def watch(obj, name):
        fn = getattr(obj, name)

        def run(*a, **kw):
            out = fn(*a, **kw)
            assert _addresses(be) == want, f"{name} moved a buffer"
            for key, si in be.inputs.items():
                addr = [si.flat.data_ptr()] + [v.data_ptr()
                                               for v in si.views.values()]
                assert inputs.setdefault(key, addr) == addr, \
                    f"{name} moved the static inputs of {key}"
            seen.append(name)
            return out
        setattr(obj, name, run)

    for name in ("decode", "megastep", "prefill_admitted", "swap_in",
                 "prefill_chunk"):
        watch(be, name)
    watch(be.pipe, "refresh")
    for name in ("reserve", "insert"):
        watch(be.pool, name)
    h2d = []
    refresh = be.pipe.refresh

    def counted(*a, **kw):
        n = be.transfer_stats["h2d"]
        refresh(*a, **kw)
        h2d.append(be.transfer_stats["h2d"] > n)
    be.pipe.refresh = counted
    srv.run(_requests(srv.cfg))
    need = {"decode", "megastep", "prefill_admitted", "refresh", "reserve"}
    if extra.get("preempt"):
        need.add("swap_in")
        assert srv.preempt_stats["swap_preemptions"] > 0
    keys = set(be.graphs.entries)
    if extra.get("chunk_budget"):
        need.add("prefill_chunk")
        for kind in ("prefill_chunk[C=", "prefill_chunk_final[C="):
            assert any(k.startswith(kind) for k in keys), keys
    assert need <= set(seen), set(seen)
    assert sum(h2d) > 1                   # the batch changed, uploads ran
    assert {"decode"} < keys
    # the buckets and chunk widths changed too
    assert len([k for k in keys if k.startswith("prefill")]) > 1, keys
    assert all(e.builds == 1 for e in be.graphs.entries.values()), \
        be.graphs.stats()
    assert not any(g["eager"] for g in be.graphs.stats().values())
    assert all(len(st.generated) == st.req.max_new_tokens
               for st in srv.states)


def test_step_graphs_on_the_cpu_capture_nothing():
    g = StepGraphs(torch.device("cpu"))
    x = torch.ones(4)
    for _ in range(3):
        y = g.run("step", [x], lambda: x * 2)
    e = g.entries["step"]
    assert torch.equal(y, x * 2)
    assert (e.builds, e.calls, e.captures, e.replays) == (1, 3, 0, 0)
    assert not StepGraphs(torch.device("cpu"), capture=True).capture


# ----------------------------------------------------------- RetraceSan ----

def test_retrace_detects_shape_unstable_step():
    san, g = RetraceSan(), StepGraphs(torch.device("cpu"))
    x = torch.ones(4)
    g.run("step", [x], lambda: x * 2)
    san.observe("step", g.entries["step"])
    san.mark_steady()
    g.run("step", [x], lambda: x * 2)
    san.observe("step", g.entries["step"])
    san.assert_clean()                     # capture-stable: no violation
    y = torch.ones(5)                      # shape change -> re-capture
    g.run("step", [y], lambda: y * 2)
    san.observe("step", g.entries["step"])
    with pytest.raises(RetraceError, match="step"):
        san.assert_clean()
    san.reset()
    san.assert_clean()


def test_retrace_warmup_is_tolerated():
    san, g = RetraceSan(), StepGraphs(torch.device("cpu"))
    for n in (2, 3, 4):                    # warm-up builds before steady
        x = torch.ones(n)
        g.run("warm", [x], lambda: x + 1)
        san.observe("warm", g.entries["warm"])
    san.mark_steady()
    g.run("warm", [x], lambda: x + 1)
    san.observe("warm", g.entries["warm"])
    san.assert_clean()
    assert g.entries["warm"].builds == 3


def _retrace_server():
    cfg = get_config("llama2-7b").smoke()
    srv = InferenceServer(cfg, mode="cached", max_batch=4, cache_slots=64,
                          numerics=True, seed=0, pipeline="fused",
                          megastep=8, device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, 5 + i).astype(np.int32)
               for i in range(3)]
    for i in range(3):
        srv.register_adapter(AdapterSpec(f"ad{i}", rank=8,
                                         base_model=cfg.name))

    def reqs(rid0):
        return [Request(rid=rid0 + i, adapter_uid=f"ad{i}",
                        prompt=prompts[i], max_new_tokens=n, arrival_ms=0.0)
                for i, n in enumerate((9, 5, 7))]
    return srv, reqs


def test_retrace_steady_megastep_clean():
    """The megastep pipeline must be capture-stable: after a full warm-up
    run, replaying an identical workload builds no new signature."""
    with sanitizers.force(True):
        srv, reqs = _retrace_server()
        srv.run(reqs(0))
        san = srv.backend.retrace_san
        assert san is not None and srv.backend.transfer_stats["megasteps"]
        assert any(k.startswith("megastep[K=") for k in san._sizes)
        san.mark_steady()
        srv.run(reqs(10))
        san.assert_clean()


def test_retrace_catches_a_pool_leaf_rebound_after_steady():
    """A LoRA pool leaf rebound (not written in place) after steady state
    changes the step's signature: on the card a stale graph would read
    the old address; the watch raises."""
    with sanitizers.force(True):
        srv, reqs = _retrace_server()
        srv.run(reqs(0))
        san = srv.backend.retrace_san
        san.mark_steady()
        q = srv.backend.pool.pool["q"]
        q["a"] = q["a"].clone()
        srv.run(reqs(10))
        with pytest.raises(RetraceError, match="grew 1 -> 2"):
            san.assert_clean()


def test_retrace_catches_a_staging_pool_leaf_rebound_after_steady():
    """A leaf of the prefill's staging pool rebound after steady state
    changes every prefill key's signature: the watch raises, naming a
    prefill key."""
    with sanitizers.force(True):
        srv, reqs = _retrace_server()
        srv.run(reqs(0))
        san = srv.backend.retrace_san
        assert any(k.startswith("prefill[Nb=") for k in san._sizes)
        san.mark_steady()
        srv.run(reqs(10))
        san.assert_clean()
        q = srv.backend.stage["q"]
        q["a"] = q["a"].clone()
        srv.run(reqs(20))
        with pytest.raises(RetraceError, match=r"prefill\[Nb=.*grew 1 -> 2"):
            san.assert_clean()


def test_prefill_buckets_past_the_cap_run_eagerly_and_are_counted():
    """A bucket of more than `graph_tokens` tokens runs eagerly by the
    stated cap: its key builds nothing and counts its calls as eager;
    the tokens are the uncapped server's."""
    out = {}
    for cap in (10 ** 9, 16):
        srv = _server("paged")
        srv.backend.graph_tokens = cap
        srv.run(_requests(srv.cfg))
        out[cap] = ({s.req.rid: s.generated for s in srv.states},
                    srv.backend.graphs.stats())
    assert out[16][0] == out[10 ** 9][0]
    capped = {k: g for k, g in out[16][1].items()
              if k.startswith("prefill[")}
    big = [k for k in capped
           if np.prod([int(x.split("=")[1]) for x in
                       k[len("prefill["):-1].split(",")]) > 16]
    assert big and all(capped[k]["eager"] > 0 and capped[k]["builds"] == 0
                       for k in big), capped
    assert all(g["eager"] == 0 for k, g in capped.items() if k not in big)
    assert not any(g["eager"] for g in out[10 ** 9][1].values())


def test_retrace_is_off_without_the_sanitizers():
    with sanitizers.force(False):
        srv, _ = _retrace_server()
    assert srv.backend.retrace_san is None


# --------------------------------------------------- against the reference --

@pytest.mark.parametrize("kernel", ["bgmv", "mbgmv"])
def test_chunked_graphed_server_tokens_match_reference(kernel):
    """Chunked prefill through the chunk graphs (page ids padded to the
    block table's width, start and length as device scalars): the
    reference's tokens at llama2-7b-smoke in f32, every chunk key built
    once."""
    cj, ct = jget("llama2-7b").smoke(), get_config("llama2-7b").smoke()
    kw = dict(mode="caraserve", kernel=kernel, max_batch=4, cache_slots=64,
              seed=0, memory="paged", chunk_budget=16)
    js = JServer(cj, **kw)
    ts = InferenceServer(ct, device="cpu", hw=REF_HW, graphs=True,
                         params=params_from_jax(
                             ct, jax.tree.map(np.asarray, js.params),
                             device="cpu"), **kw)
    for i, r in enumerate((8, 4, 2, 8)):
        js.register_adapter(JSpec(f"ad{i}", r, cj.name))
        ts.register_adapter(AdapterSpec(f"ad{i}", r, ct.name))
    rng = np.random.default_rng(5)
    trace = [(i, f"ad{i % 4}",
              rng.integers(0, 512, int(rng.integers(10, 50))).astype(np.int32),
              int(rng.integers(3, 10)), float(i * 3)) for i in range(6)]
    js.run([JReq(*t) for t in trace])
    ts.run([Request(*t) for t in trace])
    assert {s.req.rid: s.generated for s in ts.states} == \
        {s.req.rid: s.generated for s in js.states}
    be = ts.backend
    assert be.transfer_stats["prefill_chunks"] > 0
    keys = set(be.graphs.entries)
    assert any(k.startswith("prefill_chunk_final[C=") for k in keys), keys
    assert all(e.builds == 1 for e in be.graphs.entries.values())


@pytest.mark.parametrize("kernel,memory", [("bgmv", "paged"),
                                           ("mbgmv", "paged"),
                                           ("bgmv", "dense")])
def test_graphed_server_tokens_match_reference(kernel, memory):
    """graphs=True (the default) on the CPU: the same weights, adapters
    and trace give the reference's tokens, through decode and megastep
    keys each built once."""
    cj, ct = jget("llama2-7b").smoke(), get_config("llama2-7b").smoke()
    kw = dict(mode="caraserve", kernel=kernel, max_batch=4, cache_slots=64,
              seed=0, memory=memory)
    js = JServer(cj, **kw)
    ts = InferenceServer(ct, device="cpu", hw=REF_HW, graphs=True,
                         params=params_from_jax(
                             ct, jax.tree.map(np.asarray, js.params),
                             device="cpu"), **kw)
    for i, r in enumerate((8, 4, 2, 8)):
        js.register_adapter(JSpec(f"ad{i}", r, cj.name))
        ts.register_adapter(AdapterSpec(f"ad{i}", r, ct.name))
    rng = np.random.default_rng(1)
    trace = [(i, f"ad{i % 4}",
              rng.integers(0, 512, int(rng.integers(4, 16))).astype(np.int32),
              int(rng.integers(3, 14)), float(i * 3)) for i in range(6)]
    js.run([JReq(*t) for t in trace])
    ts.run([Request(*t) for t in trace])
    assert {s.req.rid: s.generated for s in ts.states} == \
        {s.req.rid: s.generated for s in js.states}
    be = ts.backend
    assert be.transfer_stats["megasteps"] > 0
    assert all(e.builds == 1 for e in be.graphs.entries.values())
