"""mamba2 (the Mamba-2 SSD block, arXiv:2405.21060) in the port against
the reference, at the smoke size in f32: the chunked SSD scan at a length
that is no multiple of its chunk, the decode step, one block's prefill
and step with LoRA on in_proj / out_proj, and the model's packed prefill
(logits at each row's last position, the stacked state and conv caches)
followed by decode steps with a frozen row. The same weights (the
reference's tree through `params_from_jax`), adapters and numpy-made
inputs; blocks within 1e-5 of the largest reference value (f32: other
summation orders), the model within atol = rtol = 1e-4, greedy tokens
identical. Also the reference's own decode-consistency property
(tests/test_decode_consistency.py) through the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.core import lora as tlora  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from test_torch_model import TOL, _both, _lora, _t  # noqa: E402

REL = 1e-5          # block-level: max |port - ref| <= REL * max |ref|


def close(got, want, rel=REL):
    """max |got - want| <= rel * max |want|, on every leaf of a tree."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], rel)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, rel)
        return
    g = got.detach().float().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= rel * scale, (err, scale)


def allclose_tree(got, want, **tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            allclose_tree(got[k], want[k], **tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            allclose_tree(g, w, **tol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **tol)


@pytest.fixture(scope="module")
def mamba():
    return _both("mamba2-130m")


def _ssd_inputs(rng, b, l, h, p, g, n):
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    B = rng.normal(size=(b, l, g, n)).astype(np.float32)
    C = rng.normal(size=(b, l, g, n)).astype(np.float32)
    D = rng.normal(size=(h,)).astype(np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("l,g", [(21, 1), (8, 2), (5, 1)])
def test_ssd_chunked_matches_reference(l, g):
    """Chunk 8: 21 tokens pad the last chunk, 8 fill one, 5 are a single
    short chunk; g=2 repeats each B/C group over two heads."""
    args = _ssd_inputs(np.random.default_rng(l), 2, l, 4, 16, g, 16)
    yj, sj = jssm.ssd_chunked(*map(jnp.asarray, args), 8)
    yt, st = tssm.ssd_chunked(*map(_t, args), 8)
    close(yt, yj)
    close(st, sj)


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(3)
    x, dt, A, B, C, D = _ssd_inputs(rng, 3, 1, 4, 16, 2, 16)
    state = rng.normal(size=(3, 4, 16, 16)).astype(np.float32)
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D, state)
    yj, sj = jssm.ssd_step(*map(jnp.asarray, args))
    yt, st = tssm.ssd_step(*map(_t, args))
    close(yt, yj)
    close(st, sj)


def _layer_lora(both, mode, idx, layer=0):
    """(reference kwargs, port kwargs) of one layer's LoRA slice."""
    lj, lt = _lora(both, mode, idx)
    pj, pt = lj["pool"], lt["pool"]
    kj = {"lora_layer": {t: {"a": pj[t]["a"][layer], "b": pj[t]["b"][layer]}
                         for t in pj if t != "ranks"},
          "lora_idx": lj["idx"], "lora_ranks": pj["ranks"],
          "lora_mode": mode}
    kt = {"lora_layer": {t: {"a": pt[t]["a"][layer], "b": pt[t]["b"][layer]}
                         for t in pt if t != "ranks"},
          "lora_idx": lt["idx"], "lora_ranks": pt["ranks"],
          "lora_mode": mode}
    return kj, kt


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
def test_ssm_block_apply_and_step_match_reference(mamba, mode):
    """One block over 11 tokens (chunk 8) with LoRA on in_proj and
    out_proj (rows on slots 0, 2 and none), then one decode step from the
    block's own cache."""
    cj, ct, pj, pt, _, _ = mamba
    p0 = jax.tree.map(lambda v: v[0], pj["blocks"])
    kj, kt = _layer_lora(mamba, mode, [0, 2, -1])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 11, cj.d_model)).astype(np.float32)
    yj, cj_ = jssm.ssm_block_apply(cj, p0, jnp.asarray(x), **kj)
    yt, ct_ = tssm.ssm_block_apply(ct, pt.blocks[0], _t(x), **kt)
    close(yt, yj)
    close(ct_, cj_)
    xt = rng.normal(size=(3, 1, cj.d_model)).astype(np.float32)
    sj, nj = jssm.ssm_block_step(cj, p0, jnp.asarray(xt), cj_, **kj)
    st, nt = tssm.ssm_block_step(ct, pt.blocks[0], _t(xt), ct_, **kt)
    close(st, sj)
    close(nt, nj)


def test_ssm_lora_targets_and_bytes_match_reference(mamba):
    """in_proj (d -> 2 d_in + 2 N + H) and out_proj (d_in -> d), and the
    adapter's upload size, as the reference computes them."""
    from repro.configs.base import get_config as jget
    from repro.core import lora as jlora
    from repro_torch.configs.base import get_config as tget
    for cfg_j, cfg_t in ((mamba[0], mamba[1]),
                         (jget("mamba2-130m"), tget("mamba2-130m"))):
        for tgt in ("in_proj", "out_proj"):
            assert tlora.lora_target_dims(cfg_t, tgt) == \
                jlora.lora_target_dims(cfg_j, tgt)
        assert tlora.AdapterSpec("a", 16, "m").nbytes(cfg_t) == \
            jlora.AdapterSpec("a", 16, "m").nbytes(cfg_j)
    assert tlora.lora_target_dims(tget("mamba2-130m"), "in_proj") == \
        (768, 3352)


def dense_prefill_decode(both, mode, S=16, steps=3, extra=None):
    """Packed prefill of 3 ragged rows (12, 7 and 3 tokens; LoRA slots 0,
    2 and none) with row caches of S slots, then `steps` decode steps over
    those caches with row 2 frozen after the first: logits, greedy tokens
    and every cache leaf equal the reference's. `extra`: more batch
    entries (numpy) for both models."""
    cj, ct, pj, pt, _, _ = both
    B, L = 3, 12
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cj.vocab, (B, L)).astype(np.int32)
    lens = np.array([12, 7, 3], np.int32)
    lj, lt = _lora(both, mode, [0, 2, -1])
    bj = {"tokens": jnp.asarray(toks)}
    bt = {"tokens": _t(toks)}
    off = 0
    for k, v in (extra or {}).items():
        bj[k], bt[k] = jnp.asarray(v), _t(v)
        off = v.shape[1]
    logits_j, cache_j = jmodel.prefill(
        cj, pj, bj, lora=lj, cache_slots=S,
        last_pos=jnp.asarray(off + lens - 1))
    logits_t, cache_t = tmodel.prefill(
        ct, pt, bt, lora=lt, cache_slots=S, last_pos=_t(off + lens - 1))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    allclose_tree(cache_t, cache_j, **TOL)
    tok = np.asarray(logits_j[:, 0].argmax(-1)).astype(np.int32)
    assert np.array_equal(tok, logits_t[:, 0].argmax(-1).numpy())
    pos = off + lens
    for step in range(steps):
        wm = np.array([True, True, step == 0])
        lj_, cache_j = jmodel.decode(
            cj, pj, cache_j, jnp.asarray(tok[:, None]), jnp.asarray(pos),
            lora=lj, write_mask=jnp.asarray(wm))
        lt_, cache_t = tmodel.decode(
            ct, pt, cache_t, _t(tok[:, None]), _t(pos), lora=lt,
            write_mask=_t(wm))
        np.testing.assert_allclose(lt_.numpy(), np.asarray(lj_), **TOL)
        nxt = np.asarray(lj_[:, -1].argmax(-1)).astype(np.int32)
        assert np.array_equal(nxt, lt_[:, -1].argmax(-1).numpy()), step
        tok = np.where(wm, nxt, tok)
        pos = np.where(wm, pos + 1, pos)
    allclose_tree(cache_t, cache_j, **TOL)


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
def test_mamba2_prefill_and_decode_match_reference(mamba, mode):
    dense_prefill_decode(mamba, mode)


def test_mamba2_full_prefill_logits_match_reference(mamba):
    """Every position's logits of an unpadded 19-token prefill (three
    chunks of 8, the last short), tied embeddings for the unembed."""
    cj, ct, pj, pt, _, _ = mamba
    toks = np.random.default_rng(3).integers(0, cj.vocab, (2, 19))
    toks = toks.astype(np.int32)
    lj, lt = _lora(mamba, "bgmv", [1, 0])
    want, _ = jmodel.prefill(cj, pj, {"tokens": jnp.asarray(toks)}, lora=lj)
    got, _ = tmodel.prefill(ct, pt, {"tokens": _t(toks)}, lora=lt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def decode_consistency(cfg, params, batch_extra=None, offset=0, B=2, L=10,
                       extra=3, seed=1):
    """The reference's own property through the port: prefill of L tokens
    with a cache, then `extra` decode steps, each step's logits within
    1e-4 of the full prefill's at that position (relative to its max)."""
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, L + extra)),
                           dtype=torch.int32)

    def batch(t):
        return {"tokens": t, **(batch_extra or {})}

    with torch.no_grad():
        full, _ = tmodel.prefill(cfg, params, batch(toks))
        logits, cache = tmodel.prefill(cfg, params, batch(toks[:, :L]),
                                       cache_slots=L + 8)
        last = logits[:, -1]
        for step in range(extra):
            want = full[:, offset + L + step - 1]
            err = float((last - want).abs().max()) \
                / (float(want.abs().max()) + 1e-9)
            assert err < 1e-4, (cfg.name, step, err)
            pos = torch.full((B,), offset + L + step, dtype=torch.int32)
            last, cache = tmodel.decode(cfg, params, cache,
                                        toks[:, L + step][:, None], pos)
            last = last[:, -1]


def test_mamba2_decode_consistency_through_the_port(mamba):
    decode_consistency(mamba[1], mamba[3])
