"""whisper (encoder-decoder, arXiv:2212.04356) in the port against the
reference, at the smoke size in f32 (2 + 2 layers, layernorm, learned
positions, q/k/v biases, the plain gelu MLP): the encoder, one decoder
block's prefill and decode step (self-attention with LoRA, cross-
attention over the encoder's cached K/V), and the model API's prefill and
greedy decode with LoRA q/k/v. The same weights, adapters and numpy-made
inputs; blocks within 1e-5 of the largest reference value, the model
within atol = rtol = 1e-4, greedy tokens identical. Also the reference's
decode-consistency property through the port, and the serving engine's
refusal (neither package's server can pass the encoder input)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import encdec as jencdec  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from test_torch_model import TOL, _both, _lora, _t  # noqa: E402
from test_torch_ssm import (_layer_lora, allclose_tree, close,  # noqa: E402
                            decode_consistency)


@pytest.fixture(scope="module")
def whisper():
    return _both("whisper-tiny")


def _frames(cfg, B, seed=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def test_encoder_matches_reference(whisper):
    cj, ct, pj, pt, _, _ = whisper
    enc = _frames(cj, 3)
    close(tencdec.encode(ct, pt, _t(enc)),
          jencdec.encode(cj, pj, jnp.asarray(enc)))


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
def test_decoder_block_prefill_and_step_match_reference(whisper, mode):
    """Decoder block 1 over 9 tokens (self cache of 12 slots written at
    prefill, cross K/V from the encoder), then one decode step at
    position 9 that reads both caches."""
    from repro.models.layers import cache_init as jcache_init
    from repro_torch.models.layers import cache_init as tcache_init
    cj, ct, pj, pt, _, _ = whisper
    kj, kt = _layer_lora(whisper, mode, [1, -1], layer=1)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, cj.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, cj.enc_seq, cj.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    c0j = {"self": jcache_init(2, cj.n_kv_heads, 12, cj.hd, jnp.float32),
           "cross": None}
    c0t = {"self": tcache_init(2, ct.n_kv_heads, 12, ct.hd, torch.float32),
           "cross": None}
    yj, cj_ = jencdec._dec_block(cj, pj["dec_blocks"][1], jnp.asarray(x),
                                 jnp.asarray(pos), jnp.asarray(enc),
                                 cache=c0j, decode=False, **kj)
    yt, ct_ = tencdec._dec_block(ct, pt.dec_blocks[1], _t(x), _t(pos),
                                 _t(enc), cache=c0t, decode=False,
                                 lora_live=None, **kt)
    close(yt, yj)
    close(ct_, cj_)
    xt = rng.normal(size=(2, 1, cj.d_model)).astype(np.float32)
    p9 = np.full((2,), 9, np.int32)
    sj, nj = jencdec._dec_block(cj, pj["dec_blocks"][1], jnp.asarray(xt),
                                jnp.asarray(p9), None, cache=cj_,
                                decode=True, **kj)
    st, nt = tencdec._dec_block(ct, pt.dec_blocks[1], _t(xt), _t(p9), None,
                                cache=ct_, decode=True, lora_live=None,
                                **kt)
    close(st, sj)
    close(nt, nj)


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
def test_whisper_prefill_and_greedy_decode_match_reference(whisper, mode):
    """model.prefill / model.decode, as a caller of the model API drives
    whisper: 3 rows of 10 tokens, LoRA slots 0, 2 and none, then 5 greedy
    tokens; logits, tokens and the caches equal the reference's."""
    cj, ct, pj, pt, _, _ = whisper
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cj.vocab, (3, 10)).astype(np.int32)
    enc = _frames(cj, 3)
    lj, lt = _lora(whisper, mode, [0, 2, -1])
    logits_j, cache_j = jmodel.prefill(
        cj, pj, {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(enc)},
        lora=lj, cache_slots=16, last_only=True)
    logits_t, cache_t = tmodel.prefill(
        ct, pt, {"tokens": _t(toks), "enc_embeds": _t(enc)}, lora=lt,
        cache_slots=16, last_only=True)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    allclose_tree(cache_t, cache_j, **TOL)
    tok = np.asarray(logits_j[:, -1].argmax(-1)).astype(np.int32)
    for step in range(5):
        pos = np.full((3,), 10 + step, np.int32)
        lj_, cache_j = jmodel.decode(cj, pj, cache_j,
                                     jnp.asarray(tok[:, None]),
                                     jnp.asarray(pos), lora=lj)
        lt_, cache_t = tmodel.decode(ct, pt, cache_t, _t(tok[:, None]),
                                     _t(pos), lora=lt)
        np.testing.assert_allclose(lt_.numpy(), np.asarray(lj_), **TOL)
        nxt = np.asarray(lj_[:, -1].argmax(-1)).astype(np.int32)
        assert np.array_equal(nxt, lt_[:, -1].argmax(-1).numpy()), step
        tok = nxt
    allclose_tree(cache_t, cache_j, **TOL)


def test_whisper_decode_consistency_through_the_port(whisper):
    ct, pt = whisper[1], whisper[3]
    decode_consistency(ct, pt, {"enc_embeds": _t(_frames(ct, 2, seed=5))})


def test_whisper_model_api_refusals_match_reference(whisper):
    ct = whisper[1]
    assert tmodel.supports_last_pos(ct) is False
    assert tmodel.supports_write_mask(ct) is False
    assert tmodel.supports_paged(ct) is False
    with pytest.raises(ValueError, match="last_pos"):
        tmodel.prefill(ct, whisper[3], {"tokens": None},
                       last_pos=torch.zeros(1))
    with pytest.raises(ValueError, match="write_mask"):
        tmodel.decode(ct, whisper[3], [], None, None,
                      write_mask=torch.ones(1, dtype=torch.bool))


def test_server_refuses_whisper_naming_the_encoder_input():
    """The reference's server fails with a KeyError at the first prefill
    (its batch carries tokens only); the port's refuses at construction."""
    from repro_torch.core.engine import InferenceServer
    with pytest.raises(ValueError, match="enc_embeds"):
        InferenceServer(tget("whisper-tiny").smoke(), device="cpu",
                        cache_slots=64)
