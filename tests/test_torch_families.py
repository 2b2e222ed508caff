"""The rest of the decoder family in the port against the reference, at
the smoke size in f32: llama2-13b (MHA), llama2-70b, qwen2-72b (q/k/v
bias), command-r-35b, mistral-large-123b (the GQA group of the full
config is 12; the smoke one keeps the reference's smoke shapes),
dbrx-132b (MoE, SwiGLU experts), grok-1-314b (MoE, GeGLU experts) and
phi-3-vision-4.2b (the VLM: stubbed patch embeddings before the tokens).
The same weights (the reference's tree through `params_from_jax`), the
same adapters and inputs made with numpy; logits and caches within
atol = rtol = 1e-4, greedy tokens identical. Also the sliding window
(`window=`) on prefill and on dense and paged decode, and the four layer
variants of the other families (layernorm, learned positions, tied
embeddings, the plain gelu MLP) on the decoder-only stack."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serving import cache as jcache  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.weights import init_params, params_from_jax  # noqa: E402,E501
from repro_torch.serving import cache as tcache  # noqa: E402
from test_torch_model import TOL, _both, _lora, _prefill_and_decode, _t  # noqa: E402,E501

ARCHS = ["llama2-13b", "llama2-70b", "qwen2-72b", "command-r-35b",
         "mistral-large-123b", "dbrx-132b", "grok-1-314b",
         "phi-3-vision-4.2b"]


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    return _both(request.param)


def _leaves(tree, prefix=""):
    """{dotted name: shape} of the reference's value tree (stacked layer
    axis dropped) or of one port block's parameters."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def test_family_params_layout_matches_reference(fam):
    """The seeded init has the reference's leaves and shapes: q/k/v biases
    (qwen2), the MoE router and the (E, d, f) / (E, f, d) experts."""
    cj, ct, pj, _, _, _ = fam
    own = init_params(ct, seed=0, device="cpu")
    want = {n: s[1:] for n, s in _leaves(pj["blocks"]).items()}
    got = {n: tuple(p.shape)
           for n, p in own.blocks[0].named_parameters()}
    assert got == want
    assert ("attn.wq.b" in got) == cj.qkv_bias
    assert ("moe.router.w" in got) == (cj.moe is not None)
    assert len(own.blocks) == cj.n_layers


def test_family_prefill_and_paged_decode_match_reference(fam):
    """Packed prefill (logits at each row's last position, row caches),
    the page scatter, then three paged decode steps with a frozen row and
    a row without an adapter: logits, tokens and pages equal the
    reference's."""
    _prefill_and_decode(fam, "bgmv")


def test_family_full_prefill_logits_match_reference(fam):
    """Every position's logits of an unpadded prefill (MoE: one routing
    group per sequence)."""
    cj, ct, pj, pt, _, _ = fam
    toks = np.random.default_rng(3).integers(0, cj.vocab, (2, 20))
    toks = toks.astype(np.int32)
    lj, lt = _lora(fam, "mbgmv", [1, 0])
    want, _ = jmodel.prefill(cj, pj, {"tokens": jnp.asarray(toks)}, lora=lj)
    got, _ = tmodel.prefill(ct, pt, {"tokens": _t(toks)}, lora=lt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_qkv_bias_nonzero_matches_reference():
    """qwen2-72b-smoke with random non-zero q/k/v biases (the reference's
    init gives zeros, which cannot tell a dropped or misplaced bias):
    packed prefill, the page scatter, three paged decode steps and every
    position's prefill logits equal the reference's, and differ from
    those with zero biases."""
    cj, ct, pj0, pt0, pool_j, pool_t = _both("qwen2-72b")
    rng = np.random.default_rng(13)
    attn = dict(pj0["blocks"]["attn"])
    for name in ("wq", "wk", "wv"):
        b = attn[name]["b"]
        attn[name] = dict(attn[name], b=jnp.asarray(
            rng.normal(0.0, 0.5, b.shape).astype(b.dtype)))
    pj = dict(pj0, blocks=dict(pj0["blocks"], attn=attn))
    pt = params_from_jax(ct, jax.tree.map(np.asarray, pj), device="cpu")
    fam = (cj, ct, pj, pt, pool_j, pool_t)
    _prefill_and_decode(fam, "bgmv")
    toks = np.random.default_rng(4).integers(0, cj.vocab, (2, 20))
    toks = toks.astype(np.int32)
    lj, lt = _lora(fam, "bgmv", [2, 0])
    want, _ = jmodel.prefill(cj, pj, {"tokens": jnp.asarray(toks)}, lora=lj)
    got, _ = tmodel.prefill(ct, pt, {"tokens": _t(toks)}, lora=lt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    zero, _ = tmodel.prefill(ct, pt0, {"tokens": _t(toks)}, lora=lt)
    assert float((zero - got).abs().max()) > 1e-2


# ------------------------------------------------------ sliding window ----

@pytest.fixture(scope="module")
def yi():
    return _both("yi-9b")


def test_window_prefill_and_decode_match_reference(yi):
    """yi-9b-smoke at L 24 > its window 16 (the counterpart of
    tests/test_models_smoke.py's sliding-window test): windowed prefill
    logits and caches, then a windowed decode step over the dense cache
    and over the paged pool (the plain gather path, as the reference's),
    all equal to the reference's and unlike full attention's."""
    cj, ct, pj, pt, _, _ = yi
    win = cj.sliding_window
    B, L, ps, P = 2, 24, 8, 8
    assert L > win
    toks = np.random.default_rng(5).integers(0, cj.vocab, (B, L))
    toks = toks.astype(np.int32)
    lj, lt = _lora(yi, "bgmv", [0, 2])
    want, rc_j = jmodel.prefill(cj, pj, {"tokens": jnp.asarray(toks)},
                                lora=lj, cache_slots=32, window=win)
    got, rc_t = tmodel.prefill(ct, pt, {"tokens": _t(toks)}, lora=lt,
                               cache_slots=32, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    full, _ = tmodel.prefill(ct, pt, {"tokens": _t(toks)}, lora=lt)
    assert float((full - got)[:, win:].abs().max()) > 1e-2
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(rc_t[name].numpy(),
                                   np.asarray(rc_j[name]), **TOL)

    tok = np.asarray(want[:, -1].argmax(-1)).astype(np.int32)[:, None]
    pos = np.full((B,), L, np.int32)
    dense_j, _ = jmodel.decode(cj, pj, rc_j, jnp.asarray(tok),
                               jnp.asarray(pos), lora=lj, window=win)
    dense_t, _ = tmodel.decode(ct, pt, {n: c.clone() for n, c in
                                        rc_t.items()},
                               _t(tok), _t(pos), lora=lt, window=win)
    np.testing.assert_allclose(dense_t.numpy(), np.asarray(dense_j), **TOL)

    ids = np.arange(B * 4, dtype=np.int32).reshape(B, 4)      # 32 slots
    pool_j = jcache.scatter_pages(
        jcache.zeros_paged(jmodel.cache_abstract(cj, 1, 32), P, ps),
        rc_j, jnp.asarray(ids))
    pool_t = tcache.scatter_pages(
        tcache.zeros_paged(tmodel.cache_abstract(ct, 1, 32), P, ps),
        {n: rc_t[n] for n in ("k", "v", "pos")}, ids)
    paged_j, _ = jmodel.decode(cj, pj, pool_j, jnp.asarray(tok),
                               jnp.asarray(pos), lora=lj, window=win,
                               block_table=jnp.asarray(ids))
    paged_t, _ = tmodel.decode(ct, pt, pool_t, _t(tok), _t(pos), lora=lt,
                               window=win, block_table=_t(ids))
    np.testing.assert_allclose(paged_t.numpy(), np.asarray(paged_j), **TOL)
    np.testing.assert_allclose(paged_t.numpy(), dense_t.numpy(), **TOL)
    unwin, _ = tmodel.decode(ct, pt, pool_t, _t(tok), _t(pos), lora=lt,
                             block_table=_t(ids))
    assert float((unwin - paged_t).abs().max()) > 1e-2


def test_windowed_prefill_chunk_equals_windowed_prefill(yi):
    """A chunked prefill with a window gives the windowed monolithic
    prefill's last logits (the mask is by absolute positions either
    way)."""
    _, ct, _, pt, _, _ = yi
    win, S, ps, C, L = ct.sliding_window, 32, 4, 8, 27
    toks = np.random.default_rng(6).integers(0, ct.vocab, L).astype(np.int32)
    pool = tcache.zeros_paged(tmodel.cache_abstract(ct, 1, S), 10, ps)
    ids = np.arange(S // ps, dtype=np.int32)
    for start in range(0, L, C):
        clen = min(C, L - start)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :clen] = toks[start:start + clen]
        out = tmodel.prefill_chunk(ct, pt, _t(chunk), start, clen, pool,
                                   _t(ids[:-(-(start + clen) // ps)]),
                                   last=start + clen == L, window=win)
    mono, _ = tmodel.prefill(ct, pt, {"tokens": _t(toks[None])},
                             last_only=True, window=win)
    np.testing.assert_allclose(out.numpy(), mono.numpy(), **TOL)


def test_decode_window_matches_reference():
    for arch in ARCHS + ["yi-9b", "llama2-7b"]:
        for L in (4096, 65536, 65537, 524288):
            assert tmodel.decode_window(tget(arch), L) == \
                jmodel.decode_window(jget(arch), L)
            assert tmodel.decode_cache_slots(tget(arch), L) == \
                jmodel.decode_cache_slots(jget(arch), L)


def test_moe_chunked_prefill_refused():
    """MoE capacity routing depends on the batch: the model refuses
    chunks, as the reference's does."""
    for arch in ARCHS:
        assert tmodel.supports_chunked_prefill(tget(arch)) == \
            jmodel.supports_chunked_prefill(jget(arch))
    cfg = tget("dbrx-132b").smoke()
    with pytest.raises(ValueError, match="chunked prefill unsupported"):
        tmodel.prefill_chunk(cfg, None, None, 0, 1, None, None)


VARIANTS = {"layernorm": {"norm": "layernorm"},
            "learned_positions": {"pos": "learned"},
            "tied_embeddings": {"tie_embeddings": True},
            "gelu_mlp": {"mlp_act": "gelu"}}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_layer_variant_initialises_and_matches_reference(variant):
    """Each layer variant of the other families on llama2-13b-smoke: the
    seeded init has the reference's leaves (layernorm biases, no lm_head
    when tied, no w3 in the plain MLP), and every position's prefill
    logits with LoRA equal the reference's."""
    from repro.models.param import split
    kw = VARIANTS[variant]
    cj = dataclasses.replace(jget("llama2-13b").smoke(), **kw)
    ct = dataclasses.replace(tget("llama2-13b").smoke(), **kw)
    pj = split(jmodel.init_params(cj, jax.random.PRNGKey(1)))[0]
    pt = params_from_jax(ct, jax.tree.map(np.asarray, pj), device="cpu")
    own = init_params(ct, 0, "cpu")
    assert {n: tuple(p.shape) for n, p in own.named_parameters()
            if not n.startswith("blocks.") or n.startswith("blocks.0.")} \
        == {n: tuple(p.shape) for n, p in pt.named_parameters()
            if not n.startswith("blocks.") or n.startswith("blocks.0.")}
    assert ("lm_head" in pj) == (own.lm_head is not None)
    toks = np.random.default_rng(6).integers(0, cj.vocab, (2, 14))
    toks = toks.astype(np.int32)
    want, _ = jmodel.prefill(cj, pj, {"tokens": jnp.asarray(toks)})
    got, _ = tmodel.prefill(ct, pt, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------- phi-3-vision ----

@pytest.fixture(scope="module")
def phi():
    return _both("phi-3-vision-4.2b")


def _patches(cfg, B, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.n_prefix_tokens,
                            cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
def test_vlm_prefix_prefill_matches_reference(phi, mode):
    """prefix_embeds (4 patch embeddings a row) before 9 tokens: every
    position's logits and the row caches (prefix positions included)
    equal the reference's."""
    cj, ct, pj, pt, _, _ = phi
    toks = np.random.default_rng(2).integers(0, cj.vocab, (2, 9))
    toks = toks.astype(np.int32)
    pre = _patches(cj, 2)
    lj, lt = _lora(phi, mode, [1, -1])
    want, cw = jmodel.prefill(cj, pj, {"tokens": jnp.asarray(toks),
                                       "prefix_embeds": jnp.asarray(pre)},
                              lora=lj, cache_slots=16)
    got, cg = tmodel.prefill(ct, pt, {"tokens": _t(toks),
                                      "prefix_embeds": _t(pre)},
                             lora=lt, cache_slots=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(cg[name].numpy(), np.asarray(cw[name]),
                                   **TOL)


def test_vlm_decode_consistency_through_the_port(phi):
    from test_torch_ssm import decode_consistency
    ct, pt = phi[1], phi[3]
    decode_consistency(ct, pt, {"prefix_embeds": _t(_patches(ct, 2, 5))},
                       offset=ct.n_prefix_tokens)
