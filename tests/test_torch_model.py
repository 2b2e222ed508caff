"""The port's dense model (repro_torch.models) against the reference's
(repro.models) on llama2-7b-smoke: the same weights (the reference's
parameter tree through `params_from_jax`), the same adapters (one process,
so the hash-seeded adapter weights agree) and the same inputs, made with
numpy. Logits and caches agree within rtol = atol = 1e-4 (f32, other
matmul kernels and summation orders); greedy tokens must be identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-sized ops: one intra-op thread avoids oversubscribing the cores the
# reference (XLA) and the other test workers share
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
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
from repro_torch.models.weights import init_params, params_from_jax  # noqa: E402
from repro_torch.serving import cache as tcache  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
RANKS = (8, 5, 2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _both(arch):
    cj = jget(arch).smoke()
    ct = tget(arch).smoke()
    pj = split(jmodel.init_params(cj, jax.random.PRNGKey(0)))[0]
    pt = params_from_jax(ct, jax.tree.map(np.asarray, pj), device="cpu")
    pool_j = jlora.pool_init(cj, n_slots=len(RANKS))
    pool_t = tlora.pool_init(ct, len(RANKS), "cpu")
    for s, r in enumerate(RANKS):
        wj = jlora.make_adapter_weights(cj, jlora.AdapterSpec(f"m{s}", r,
                                                              cj.name))
        wt = tlora.make_adapter_weights(ct, tlora.AdapterSpec(f"m{s}", r,
                                                              ct.name))
        for tgt in wj:
            for ab in ("a", "b"):
                np.testing.assert_array_equal(wt[tgt][ab].numpy(),
                                              wj[tgt][ab])
        pool_j = jlora.pool_insert(pool_j, cj, wj, s, r)
        tlora.pool_insert(pool_t, ct, wt, s, r)
    return cj, ct, pj, pt, pool_j, pool_t


@pytest.fixture(scope="module")
def both():
    return _both("llama2-7b")


@pytest.fixture(scope="module")
def both_yi():
    """yi-9b-smoke: 4 query heads over 2 KV heads (GQA group 2)."""
    return _both("yi-9b")


def _lora(both, mode, idx):
    _, _, _, _, pool_j, pool_t = both
    if mode is None:
        return None, None
    idx = np.asarray(idx, np.int32)
    return ({"pool": pool_j, "idx": jnp.asarray(idx), "mode": mode},
            {"pool": pool_t, "idx": _t(idx), "mode": mode})


def test_params_layout_matches_reference(both):
    _params_layout(both)


def test_yi9b_params_layout_matches_reference(both_yi):
    """GQA shapes: wk/wv (d, KV, hd) with KV < H, from the seeded init and
    from the reference's tree."""
    _params_layout(both_yi)
    cj, _, _, pt, _, _ = both_yi
    assert tuple(pt.blocks[0].attn.wk.w.shape) == (cj.d_model,
                                                   cj.n_kv_heads, cj.hd)


def _params_layout(both):
    cj, ct, pj, pt, _, _ = both
    own = init_params(ct, seed=0, device="cpu")
    blk = pj["blocks"]
    assert tuple(own.embed.shape) == pj["embed"].shape
    assert tuple(own.lm_head.w.shape) == pj["lm_head"]["w"].shape
    assert len(own.blocks) == cj.n_layers
    b0 = own.blocks[0]
    for name in ("wq", "wk", "wv", "wo"):
        assert tuple(getattr(b0.attn, name).w.shape) == \
            blk["attn"][name]["w"].shape[1:]
    for name in ("w1", "w2", "w3"):
        assert tuple(getattr(b0.mlp, name).w.shape) == \
            blk["mlp"][name]["w"].shape[1:]
    np.testing.assert_array_equal(pt.blocks[1].attn.wo.w.numpy(),
                                  np.asarray(blk["attn"]["wo"]["w"][1]))


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_reference_config_loads_in_the_port(arch):
    """Every config of the reference loads in the port with the
    reference's fields (its dtype as a torch dtype), and so does its
    smoke variant."""
    for cj, ct in ((jget(arch), tget(arch)),
                   (jget(arch).smoke(), tget(arch).smoke())):
        fj = dataclasses.asdict(cj)
        ft = dataclasses.asdict(ct)
        assert ft == fj
        assert ct.torch_dtype == getattr(torch, cj.dtype)
        assert ct.hd == cj.hd
        assert ct.param_count() == cj.param_count()


def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    want = np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos)))
    got = tlayers.rope(_t(x), _t(pos)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _paged_pool(seed, P=6, KV=2, ps=4, hd=8):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(P, KV, ps, hd)).astype(np.float32)
    v = rng.normal(size=(P, KV, ps, hd)).astype(np.float32)
    pos = np.full((P, ps), -1, np.int32)
    pos[0, :3] = [0, 1, 2]
    pos[1, :] = [4, 5, 6, 7]
    pos[2, :] = [0, 1, 2, 3]
    pos[4, :2] = [0, 1]
    return {"k": k, "v": v, "pos": pos}


def _with_sink(pool):
    """The port's per-layer pool: the reference's pages plus the sink."""
    out = {}
    for name, a in pool.items():
        pad = np.full((1,) + a.shape[1:], -1 if name == "pos" else 0,
                      a.dtype)
        out[name] = _t(np.concatenate([a, pad]))
    return out


def test_cache_write_token_paged_matches_reference():
    pool = _paged_pool(1)
    rng = np.random.default_rng(2)
    bt = np.array([[2, 1], [0, -1], [4, -1]], np.int32)
    pos = np.array([6, 3, 2], np.int32)
    kt = rng.normal(size=(3, 1, 2, 8)).astype(np.float32)
    vt = rng.normal(size=(3, 1, 2, 8)).astype(np.float32)
    wm = np.array([True, True, False])
    want = jlayers.cache_write_token_paged(
        {n: jnp.asarray(a) for n, a in pool.items()}, jnp.asarray(kt),
        jnp.asarray(vt), jnp.asarray(pos), jnp.asarray(bt),
        write_mask=jnp.asarray(wm))
    got = tlayers.cache_write_token_paged(
        _with_sink(pool), _t(kt), _t(vt), _t(pos), _t(bt),
        write_mask=_t(wm))
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[name].numpy()[:-1],
                                      np.asarray(want[name]))


def test_paged_attn_decode_matches_reference():
    pool = _paged_pool(3)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 1, 4, 8)).astype(np.float32)
    bt = np.array([[2, 1], [0, -1], [-1, -1]], np.int32)
    pos = np.array([6, 2, 0], np.int32)
    want = np.asarray(jlayers.paged_attn_decode(
        jnp.asarray(q), {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(bt), jnp.asarray(pos)))
    got = tlayers.paged_attn_decode(_t(q), _with_sink(pool), _t(bt),
                                    _t(pos)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv", None])
def test_prefill_and_three_decode_steps_match_reference(both, mode):
    """Packed prefill with a last-position gather, the page scatter of its
    row caches, then three paged decode steps (one row frozen by its write
    mask after the first, one row without an adapter)."""
    _prefill_and_decode(both, mode)


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv", None])
def test_yi9b_prefill_and_three_decode_steps_match_reference(both_yi, mode):
    """The same on yi-9b-smoke, where every prefill and decode attention
    runs at GQA group 2 and the k/v LoRA deltas are KV * hd wide."""
    assert both_yi[1].n_heads == 2 * both_yi[1].n_kv_heads
    _prefill_and_decode(both_yi, mode)


def _prefill_and_decode(both, mode):
    cj, ct, pj, pt, _, _ = both
    B, L, S, ps, P = 3, 12, 16, 4, 12
    W = S // ps
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cj.vocab, (B, L)).astype(np.int32)
    lens = np.array([12, 7, 3], np.int32)
    lj, lt = _lora(both, mode, [0, 2, -1])
    logits_j, rc_j = jmodel.prefill(
        cj, pj, {"tokens": jnp.asarray(toks)}, lora=lj, cache_slots=S,
        last_pos=jnp.asarray(lens - 1))
    logits_t, rc_t = tmodel.prefill(
        ct, pt, {"tokens": _t(toks)}, lora=lt, cache_slots=S,
        last_pos=_t(lens - 1))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(rc_t[name].numpy(),
                                   np.asarray(rc_j[name]), **TOL)
    # pad slots invalid, then scatter into pages: row 0 -> [0, 1, 2],
    # row 1 -> [3, 4] (+ page 5 for its decode growth), row 2 -> [6]
    live = np.arange(S)[None, None] < lens[None, :, None]
    rc_j = dict(rc_j, pos=jnp.where(live, rc_j["pos"], -1))
    rc_t["pos"] = torch.where(_t(live), rc_t["pos"], -1)
    page_ids = np.array([[0, 1, 2, -1], [3, 4, -1, -1], [6, -1, -1, -1]],
                        np.int32)
    pool_j = jcache.scatter_pages(
        jcache.zeros_paged(jmodel.cache_abstract(cj, 1, S), P, ps),
        rc_j, jnp.asarray(page_ids))
    pool_t = tcache.scatter_pages(
        tcache.zeros_paged(tmodel.cache_abstract(ct, 1, S), P, ps),
        rc_t, page_ids)
    bt = np.array([[0, 1, 2, 7], [3, 4, 5, -1], [6, -1, -1, -1]], np.int32)
    tok = np.asarray(logits_j[:, 0].argmax(-1)).astype(np.int32)
    assert np.array_equal(tok, logits_t[:, 0].argmax(-1).numpy())
    pos = lens.copy()
    for step in range(3):
        wm = np.array([True, True, step == 0])
        lj_, pool_j = jmodel.decode(
            cj, pj, pool_j, jnp.asarray(tok[:, None]), jnp.asarray(pos),
            lora=lj, write_mask=jnp.asarray(wm), block_table=jnp.asarray(bt))
        lt_, pool_t = tmodel.decode(
            ct, pt, pool_t, _t(tok[:, None]), _t(pos), lora=lt,
            write_mask=_t(wm), block_table=_t(bt))
        np.testing.assert_allclose(lt_.numpy(), np.asarray(lj_), **TOL)
        nxt = np.asarray(lj_[:, -1].argmax(-1)).astype(np.int32)
        assert np.array_equal(nxt, lt_[:, -1].argmax(-1).numpy()), step
        tok = np.where(wm, nxt, tok)
        pos = np.where(wm, pos + 1, pos)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(pool_t[name].numpy()[:, :P],
                                   np.asarray(pool_j[name]), **TOL)
    for row in range(B):
        gj = jcache.gather_pages(pool_j, jnp.asarray(bt[row]))
        gt = tcache.gather_pages(pool_t, bt[row])
        for name in ("k", "v", "pos"):
            np.testing.assert_allclose(gt[name].numpy(),
                                       np.asarray(gj[name]), **TOL)


def test_attn_prefill_direct_and_chunked_match_reference():
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 20, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
    for window in (None, 6):
        want = np.asarray(jlayers.attn_prefill(
            *map(jnp.asarray, (q, k, v)), window=window))
        direct = tlayers.attn_prefill(*map(_t, (q, k, v)), window=window)
        chunked = tlayers.attn_chunked(*map(_t, (q, k, v)), window=window,
                                       block=8)
        np.testing.assert_allclose(direct.numpy(), want, **TOL)
        np.testing.assert_allclose(chunked.numpy(), want, **TOL)


def _chunk_pool(cfg, model_lib, cache_lib, S, ps, P):
    return cache_lib.zeros_paged(model_lib.cache_abstract(cfg, 1, S), P, ps)


@pytest.mark.parametrize("arch,mode", [("yi-9b", "bgmv"),
                                       ("yi-9b", "mbgmv"),
                                       ("llama2-7b", "bgmv")])
def test_prefill_chunk_matches_reference(both, both_yi, arch, mode):
    """A 23-token prompt in chunks of 8 (the last padded from 7) through the
    row's pages, scattered in block-table order over non-adjacent page ids:
    after every chunk the row's KV (gathered dense) agrees with the
    reference's returned view within TOL and its positions are equal (pad
    slots stay -1); the final chunk's logits agree with the reference's
    and with the port's own monolithic prefill of the whole prompt."""
    cj, ct, pj, pt, _, _ = both_yi if arch == "yi-9b" else both
    S, ps, P, L, C = 32, 4, 12, 23, 8
    ids = np.array([5, 2, 9, 0, 7, 11, 3, 1], np.int32)     # W = S // ps
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cj.vocab, L).astype(np.int32)
    lj, lt = _lora(both_yi if arch == "yi-9b" else both, mode, [1])
    pool_j = _chunk_pool(cj, jmodel, jcache, S, ps, P)
    pool_t = _chunk_pool(ct, tmodel, tcache, S, ps, P)
    for start in range(0, L, C):
        clen = min(C, L - start)
        last = start + clen == L
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :clen] = toks[start:start + clen]
        view = jcache.gather_pages(pool_j, jnp.asarray(ids))
        logits_j, view = jmodel.prefill_chunk(
            cj, pj, jnp.asarray(chunk), jnp.asarray(start, jnp.int32),
            jnp.asarray(clen, jnp.int32), view, lora=lj, last=last)
        pool_j = jcache.scatter_pages(pool_j, view,
                                      jnp.asarray(ids)[None])
        claimed = ids[:-(-(start + clen) // ps)]
        logits_t = tmodel.prefill_chunk(ct, pt, _t(chunk), start, clen,
                                        pool_t, _t(claimed), lora=lt,
                                        last=last)
        got = tcache.gather_pages(pool_t, ids)
        np.testing.assert_array_equal(got["pos"].numpy(),
                                      np.asarray(view["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(view[name]), **TOL)
        assert (logits_t is None) == (not last)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    mono, _ = tmodel.prefill(ct, pt, {"tokens": _t(toks[None])}, lora=lt,
                             last_only=True)
    np.testing.assert_allclose(logits_t.numpy(), mono.numpy(), **TOL)
