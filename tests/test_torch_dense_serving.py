"""The port's server on the dense memory plane (bf16/f32 or int8 KV per
row) and on the per-step pipeline, against the reference's server and
against the port's own paged plane and fused pipeline: same config, same
weights, same adapters (built in one process), the same trace and the
reference's timeline hardware (see test_torch_serving.py). Token streams,
and where the planes share a clock their token timestamps, must be
identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.serving.request import Request as JReq  # noqa: E402
from repro_torch.serving.request import Request as TReq  # noqa: E402
from test_torch_serving import _pair, _tokens, _trace  # noqa: E402


def _times(srv):
    return {s.req.rid: s.token_times_ms for s in srv.states}


def _ring_trace(n=5, seed=6):
    """Staggered requests whose prompt + new tokens outrun a 24-slot row
    (their positions wrap the ring) beside short ones."""
    rng = np.random.default_rng(seed)
    return [(i, f"ad{i % 4}",
             rng.integers(0, 512, int(rng.integers(6, 20))).astype(np.int32),
             int(rng.integers(8, 24)), float(i * 3)) for i in range(n)]


def _run(srvs, trace):
    for srv in srvs:
        req = JReq if type(srv).__module__.startswith("repro.") else TReq
        srv.run([req(*t) for t in trace])
        assert all(len(s.generated) == s.req.max_new_tokens
                   for s in srv.states)


@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("kernel", ["bgmv", "mbgmv"])
@pytest.mark.parametrize("arch", ["llama2-7b", "yi-9b"])
def test_dense_server_tokens_match_reference(arch, kernel, kv):
    """memory="dense" with unquantized (f32) and int8 KV, 24-slot rows
    that the longer requests wrap: packed prefills into slab rows, fused
    decode and megasteps with rows joining and leaving; every request's
    tokens and timestamps equal the reference's."""
    js, ts = _pair(kernel, arch=arch, kv=kv, memory="dense",
                   cache_slots=24)
    assert ts.memory == "dense" and not ts.backend.paged
    trace = _ring_trace()
    assert any(len(p) + m > 24 for _, _, p, m, _ in trace)
    # each adapter's derived seed (make_adapter_weights: the hash is salted
    # per process), so that a failing case can be rebuilt
    seeds = {u: abs(hash((u, sp.seed))) % 2 ** 31
             for u, sp in ts.store.specs.items()}
    _run((js, ts), trace)
    assert ts.backend.transfer_stats["megasteps"] > 0
    assert _tokens(ts) == _tokens(js), f"adapter seeds {seeds}"
    assert _times(ts) == _times(js), f"adapter seeds {seeds}"


@pytest.mark.parametrize("kernel", ["bgmv", "mbgmv"])
@pytest.mark.parametrize("arch", ["llama2-7b", "yi-9b"])
def test_perstep_matches_fused_and_reference(arch, kernel):
    """pipeline="perstep" (host-built inputs, host sampling, synchronous
    readback) gives the tokens and token timestamps of the port's fused
    pipeline and of the reference's per-step server."""
    js, ts = _pair(kernel, arch=arch, pipeline="perstep", megastep=0)
    _, fused = _pair(kernel, arch=arch, memory="dense", megastep=0)
    assert ts.memory == "dense" and ts.backend.megastep_max == 0
    _run((js, ts, fused), _trace())
    assert ts.backend.transfer_stats["megasteps"] == 0
    assert _tokens(ts) == _tokens(js) == _tokens(fused)
    assert _times(ts) == _times(js) == _times(fused)


@pytest.mark.parametrize("page_size", [16, 32, 64])
def test_paged_plane_matches_dense_plane(page_size):
    """The paged plane (the paged attention path) gives the dense plane's
    tokens and timestamps at every page size that tiles the 64-slot row,
    as the reference's planes agree."""
    _, dense = _pair(memory="dense", megastep=0)
    _, paged = _pair(memory="paged", megastep=0, page_size=page_size)
    assert paged.backend.paged and not dense.backend.paged
    _run((dense, paged), _trace(seed=5))
    assert _tokens(paged) == _tokens(dense)
    assert _times(paged) == _times(dense)


@pytest.mark.parametrize("kv", ["", "int8"])
def test_dense_megastep_equals_single_steps(kv):
    """On the dense plane a K-step megastep equals K single steps: tokens,
    timestamps and every slab leaf bitwise."""
    _, mega = _pair(kv=kv, memory="dense", megastep=8, cache_slots=24)
    _, single = _pair(kv=kv, memory="dense", megastep=0, cache_slots=24)
    _run((mega, single), _ring_trace(seed=8))
    assert mega.backend.transfer_stats["megasteps"] > 0
    assert single.backend.transfer_stats["megasteps"] == 0
    assert _tokens(mega) == _tokens(single)
    assert _times(mega) == _times(single)
    for name, leaf in single.backend.cache.items():
        assert torch.equal(mega.backend.cache[name], leaf), name
