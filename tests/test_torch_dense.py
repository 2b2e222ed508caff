"""The port's dense KV plane (repro_torch.models.layers' dense cache, and
model.prefill / model.decode over it) against the reference's, in f32 at
smoke size: the same inputs, made with numpy from a seed, through both.

Tolerances: int8 payloads of a direct quantization are bitwise equal and
their scales within 1e-7 relative; f32 caches written from the same
inputs are equal. Through the model, logits and KV agree within
1e-5 x max(1, |ref|) per element (f32 in other matmul kernels and
summation orders); there the int8 payload may differ by one step where
the f32 input sits on a rounding boundary: at most 1, and such entries
are counted and bounded."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-sized ops: one intra-op thread avoids oversubscribing the cores the
# reference (XLA) and the other test workers share
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.param import split  # noqa: E402
from repro.serving import cache as jcache  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import lora as tlora  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving import cache as tcache  # noqa: E402

RTOL = 1e-5
# share of int8 payload entries allowed one step apart after the layers
INT8_FLIP_SHARE = 1e-3


def _t(a):
    """A writable torch copy (the port's caches are written in place)."""
    return torch.from_numpy(np.array(a))


def _close(got, want, what):
    """|got - want| <= RTOL * max(1, |want|) element-wise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    lim = RTOL * np.maximum(1.0, np.abs(want))
    bad = np.abs(got - want) > lim
    assert not bad.any(), (what, float(np.abs(got - want).max()))


def _cache_close(got, want, what):
    """Cache leaves: pos equal; f32 k/v and scales within RTOL; int8
    payloads at most one step apart on at most INT8_FLIP_SHARE of the
    entries. Returns the count of such entries."""
    assert sorted(got) == sorted(want), what
    flips = 0
    for name in want:
        g, w = got[name].numpy(), np.asarray(want[name])
        if name == "pos":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} pos")
        elif w.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1, (what, name, int(d.max()))
            flips += int((d > 0).sum())
            assert (d > 0).mean() <= INT8_FLIP_SHARE, (what, name,
                                                       int((d > 0).sum()))
        else:
            _close(g, w, f"{what} {name}")
    return flips


# ------------------------------------------------------ cache primitives ----

@pytest.mark.parametrize("shape,seed", [((2, 3, 16), 0), ((4, 2, 5, 32), 1),
                                        ((1, 1, 128), 2)])
def test_quantize_matches_reference(shape, seed):
    """Symmetric per-vector int8: payload bitwise, scale within 1e-7
    relative; one all-zero vector (scale floored at 1e-9) and one holding
    exact half steps (round half to even)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    x.reshape(-1, shape[-1])[0] = 0.0
    half = x.reshape(-1, shape[-1])[-1]
    half[:] = (np.arange(shape[-1]) % 5 - 2) * 0.5
    half[0] = 127.0          # scale 1: every .5 is a tie
    qj, sj = jlayers._quantize(jnp.asarray(x))
    qt, st = tlayers._quantize(_t(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-7, atol=0)
    dj = jlayers._dequantize(qj, sj, jnp.float32)
    dt = tlayers._dequantize(qt, st, torch.float32)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-7, atol=0)


def _caches(B, KV, S, hd, quant):
    return (jlayers.cache_init(B, KV, S, hd, jnp.float32, quantized=quant),
            tlayers.cache_init(B, KV, S, hd, torch.float32, quantized=quant))


def _leaves_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for name in want:
        w = np.asarray(want[name])
        if name.endswith("scale"):
            np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-7,
                                       atol=0, err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(got[name].numpy(), w,
                                          err_msg=f"{what} {name}")


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("L", [5, 8, 13, 21])
def test_cache_write_prefill_matches_reference(L, quant):
    """S = 8 slots: L < S fills a prefix, L = S fills the row, L > S keeps
    the last S tokens in ring order (slot(p) = p % S), L = 21 wrapping
    more than twice."""
    B, KV, S, hd = 2, 3, 8, 16
    rng = np.random.default_rng(L)
    k = rng.normal(size=(B, L, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, L, KV, hd)).astype(np.float32)
    positions = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L))
    cj, ct = _caches(B, KV, S, hd, quant)
    want = jlayers.cache_write_prefill(cj, jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(positions))
    got = tlayers.cache_write_prefill(ct, _t(k), _t(v), _t(positions))
    _leaves_equal(got, want, f"L={L}")
    if L > S:
        assert (got["pos"].numpy() % S == np.arange(S)).all()


@pytest.mark.parametrize("quant", [False, True])
def test_cache_write_token_matches_reference(quant):
    """Six single-token writes over 3 rows of an S = 4 ring, one row frozen
    by the write mask every other step: each row's slot is pos % S, and a
    frozen row's leaves stay bitwise as they were."""
    B, KV, S, hd = 3, 2, 4, 8
    rng = np.random.default_rng(5)
    cj, ct = _caches(B, KV, S, hd, quant)
    pos = np.array([0, 2, 5], np.int32)
    for step in range(6):
        kt = rng.normal(size=(B, 1, KV, hd)).astype(np.float32)
        vt = rng.normal(size=(B, 1, KV, hd)).astype(np.float32)
        wm = np.array([True, step % 2 == 0, True])
        before = {n: t.clone() for n, t in ct.items()}
        cj = jlayers.cache_write_token(cj, jnp.asarray(kt), jnp.asarray(vt),
                                       jnp.asarray(pos),
                                       write_mask=jnp.asarray(wm))
        tlayers.cache_write_token(ct, _t(kt), _t(vt), _t(pos),
                                  write_mask=_t(wm))
        _leaves_equal(ct, cj, f"step {step}")
        if not wm[1]:
            for n in ct:
                assert torch.equal(ct[n][1], before[n][1]), (step, n)
        pos = np.where(wm, pos + 1, pos)
    assert pos.max() > S            # the ring wrapped


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 1)])
def test_attn_decode_matches_reference(H, KV):
    """GQA groups 1 and 8 over a cache with empty slots (pos -1) and slots
    past the query's position."""
    B, S, hd = 3, 10, 16
    rng = np.random.default_rng(H + KV)
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    ck = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    cv = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    cpos = np.full((B, S), -1, np.int32)
    cpos[0, :4] = np.arange(4)
    cpos[1] = np.arange(S) + 3
    cpos[2, ::2] = np.arange(0, S, 2)
    pos = np.array([3, 9, 6], np.int32)
    want = jlayers.attn_decode(*map(jnp.asarray, (q, ck, cv, cpos, pos)))
    got = tlayers.attn_decode(*map(_t, (q, ck, cv, cpos, pos)))
    _close(got.numpy(), want, "attn_decode")


# ----------------------------------------------------------------- model ----

RANKS = (8, 5, 2)


def _both(arch):
    cj, ct = jget(arch).smoke(), tget(arch).smoke()
    pj = split(jmodel.init_params(cj, jax.random.PRNGKey(0)))[0]
    pt = params_from_jax(ct, jax.tree.map(np.asarray, pj), device="cpu")
    pool_j = jlora.pool_init(cj, n_slots=len(RANKS))
    pool_t = tlora.pool_init(ct, len(RANKS), "cpu")
    for s, r in enumerate(RANKS):
        wj = jlora.make_adapter_weights(cj, jlora.AdapterSpec(f"d{s}", r,
                                                              cj.name))
        wt = tlora.make_adapter_weights(ct, tlora.AdapterSpec(f"d{s}", r,
                                                              ct.name))
        pool_j = jlora.pool_insert(pool_j, cj, wj, s, r)
        tlora.pool_insert(pool_t, ct, wt, s, r)
    return cj, ct, pj, pt, pool_j, pool_t


def _adapter_seeds(uids, seed=0):
    """Each adapter's derived seed, abs(hash((uid, seed))) % 2**31 as
    make_adapter_weights draws it. Python salts the hash per process, so a
    failure message that carries these lets the case be rebuilt."""
    return {u: abs(hash((u, seed))) % 2 ** 31 for u in uids}


@pytest.fixture(scope="module")
def models():
    return {arch: _both(arch) for arch in ("llama2-7b", "yi-9b")}


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("arch,mode", [("llama2-7b", "bgmv"),
                                       ("yi-9b", "mbgmv")])
def test_prefill_and_two_dense_decode_steps_match_reference(models, arch,
                                                            mode, kv, ring):
    """model.prefill into the dense row caches (12 tokens into 16 slots, or
    into 8: the ring), then two model.decode steps over them with one row
    frozen by the write mask in the second and one row without an
    adapter: logits and every cache leaf agree with the reference's. With
    int8 KV each decode step starts from the reference's cache: an int8
    entry one step apart (an f32 input on a rounding boundary) moves the
    next layer's scores by a whole quantization step, far past the f32
    tolerance, so each step is held to the reference on equal inputs."""
    cj, ct, pj, pt, pool_j, pool_t = models[arch]
    cj = dataclasses.replace(cj, kv_cache_dtype=kv)
    ct = dataclasses.replace(ct, kv_cache_dtype=kv)
    seeds = f"adapter seeds {_adapter_seeds(f'd{s}' for s in range(3))}"
    B, L = 3, 12
    S = 8 if ring else 16
    rng = np.random.default_rng(21 + S)
    toks = rng.integers(0, cj.vocab, (B, L + 2)).astype(np.int32)
    idx = np.array([0, 2, -1], np.int32)
    lj = {"pool": pool_j, "idx": jnp.asarray(idx), "mode": mode}
    lt = {"pool": pool_t, "idx": _t(idx), "mode": mode}
    logits_j, cache_j = jmodel.prefill(
        cj, pj, {"tokens": jnp.asarray(toks[:, :L])}, lora=lj,
        cache_slots=S, last_only=True)
    logits_t, cache_t = tmodel.prefill(
        ct, pt, {"tokens": _t(toks[:, :L])}, lora=lt, cache_slots=S,
        last_only=True)
    _close(logits_t.numpy(), logits_j, f"prefill logits, {seeds}")
    flips = _cache_close(cache_t, cache_j, f"prefill cache, {seeds}")
    for step in range(2):
        if kv == "int8":
            cache_t = {n: _t(c) for n, c in cache_j.items()}
        pos = np.full((B,), L + step, np.int32)
        wm = np.array([True, step == 0, True])
        tok = toks[:, L + step:L + step + 1]
        logits_j, cache_j = jmodel.decode(
            cj, pj, cache_j, jnp.asarray(tok), jnp.asarray(pos), lora=lj,
            write_mask=jnp.asarray(wm))
        logits_t, cache_t = tmodel.decode(
            ct, pt, cache_t, _t(tok), _t(pos), lora=lt, write_mask=_t(wm))
        _close(logits_t.numpy(), logits_j,
               f"decode {step} logits, {seeds}")
        flips += _cache_close(cache_t, cache_j,
                              f"decode {step} cache, {seeds}")
    assert kv == "int8" or flips == 0, seeds
    if ring:
        assert int(cache_t["pos"].max()) == L + 1 > S


def test_cache_abstract_int8_leaves():
    """int8 KV: the payload is int8 and the f32 scales ride beside it,
    matching the reference's abstract cache leaf for leaf."""
    for kv in ("", "int8"):
        cj = dataclasses.replace(jget("yi-9b").smoke(), kv_cache_dtype=kv)
        ct = dataclasses.replace(tget("yi-9b").smoke(), kv_cache_dtype=kv)
        want = jmodel.cache_abstract(cj, 2, 24)
        got = tmodel.cache_abstract(ct, 2, 24)
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert tuple(got[name].shape) == w.shape, name
            assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name


@pytest.mark.parametrize("depth", [16, 8])
def test_slab_row_helpers_match_reference(depth):
    """zeros_like_batched / scatter_rows / scatter_row / gather_row: rows
    scattered into a slab of stale contents (a padding entry pointing past
    the slab is dropped) equal the reference's slab. The port's row caches
    may be shallower than the row (depth 8 of 16): the rest of the row is
    cleared, as the reference's full-depth row caches leave it."""
    cj = dataclasses.replace(jget("yi-9b").smoke(), kv_cache_dtype="int8")
    ct = dataclasses.replace(tget("yi-9b").smoke(), kv_cache_dtype="int8")
    S, rows = 16, [3, 0, 4]                     # 4 = max_batch: dropped
    rng = np.random.default_rng(depth)
    want = jcache.zeros_like_batched(jmodel.cache_abstract(cj, 1, S), 4)
    got = tcache.zeros_like_batched(tmodel.cache_abstract(ct, 1, S), 4,
                                    "cpu")
    _leaves_equal(got, want, "zeros")
    stale = {n: rng.integers(-3, 100, w.shape).astype(w.dtype)
             for n, w in want.items()}
    full, shallow = {}, {}
    for n, w in want.items():
        x = rng.integers(-3, 100, (w.shape[0], 3) + w.shape[2:]
                         ).astype(w.dtype)
        ax = 2 if n == "pos" else 3             # the slot axis
        past = [slice(None)] * x.ndim
        past[ax] = slice(depth, None)
        x[tuple(past)] = -1 if n == "pos" else 0
        full[n] = x
        shallow[n] = _t(x.take(np.arange(depth), axis=ax))
    want = jcache.scatter_rows({n: jnp.asarray(x) for n, x in stale.items()},
                               {n: jnp.asarray(x) for n, x in full.items()},
                               jnp.asarray(rows))
    got = {n: _t(x) for n, x in stale.items()}
    tcache.scatter_rows(got, shallow, rows)
    _leaves_equal(got, want, "scatter_rows")
    one = tcache.gather_row(got, 0)
    _leaves_equal(one, jcache.gather_row(want, 0), "gather_row")
    tcache.scatter_row(got, {n: x.clone() for n, x in one.items()}, 1)
    _leaves_equal(tcache.gather_row(got, 1), jcache.gather_row(want, 0),
                  "scatter_row")
