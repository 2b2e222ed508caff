"""recurrentgemma (the Griffin hybrid, arXiv:2402.19427) in the port
against the reference, at the smoke size in f32 (3 layers: RG-LRU,
RG-LRU, local attention with a window of 8, MQA): the RG-LRU block's
prefill (the reference's associative scan, the port's doubling scan) and
decode step, and the model's packed prefill past the window (the local
attention's ring wraps) followed by decode steps with a frozen row,
LoRA on the attention layer's q/k/v. The same weights, adapters and
numpy-made inputs; blocks within 1e-5 of the largest reference value,
the model within atol = rtol = 1e-4, greedy tokens identical. Also the
reference's decode-consistency property through the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import model as jmodel  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from test_torch_model import _both, _t  # noqa: E402
from test_torch_ssm import (close, decode_consistency,  # noqa: E402
                            dense_prefill_decode)


@pytest.fixture(scope="module")
def rg():
    return _both("recurrentgemma-2b")


def test_linear_scan_matches_associative_scan():
    """h_t = a_t h_{t-1} + b_t over 37 steps (no power of two) against the
    reference's lax.associative_scan with its combine."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.0, 1.0, (2, 37, 5)).astype(np.float32)
    b = rng.normal(size=(2, 37, 5)).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    close(trglru.linear_scan(_t(a), _t(b)), want)


@pytest.mark.parametrize("L", [1, 2, 13])
def test_rglru_block_apply_and_step_match_reference(rg, L):
    """One RG-LRU block over L tokens (fewer than the conv's 3-token tail
    at L 1 and 2), then one decode step from its cache."""
    cj, ct, pj, pt, _, _ = rg
    rng = np.random.default_rng(L)
    x = rng.normal(size=(2, L, cj.d_model)).astype(np.float32)
    yj, cj_ = jrglru.rglru_block_apply(cj, pj["blocks"][0], jnp.asarray(x))
    yt, ct_ = trglru.rglru_block_apply(ct, pt.blocks[0], _t(x))
    close(yt, yj)
    close(ct_, cj_)
    xt = rng.normal(size=(2, 1, cj.d_model)).astype(np.float32)
    sj, nj = jrglru.rglru_block_step(cj, pj["blocks"][0], jnp.asarray(xt),
                                     cj_)
    st, nt = trglru.rglru_block_step(ct, pt.blocks[0], _t(xt), ct_)
    close(st, sj)
    close(nt, nj)


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
def test_hybrid_prefill_and_decode_match_reference(rg, mode):
    """12-token prompts against an 8-token window: the attention layer's
    8-slot ring holds the last 8 positions, rolled; decode wraps it."""
    dense_prefill_decode(rg, mode, S=16, steps=4)


def test_hybrid_cache_abstract_matches_reference(rg):
    cj, ct = rg[0], rg[1]
    want = jmodel.cache_abstract(cj, 2, 20)
    got = tmodel.cache_abstract(ct, 2, 20)
    assert len(got) == len(want) == cj.n_layers
    for g, w in zip(got, want):
        assert {k: tuple(v.shape) for k, v in g.items()} == \
            {k: tuple(v.shape) for k, v in w.items()}


def test_hybrid_refuses_the_paged_plane(rg):
    cj, ct = rg[0], rg[1]
    assert tmodel.supports_paged(ct) == jmodel.supports_paged(cj) is False
    assert tmodel.supports_chunked_prefill(ct) is False
    with pytest.raises(ValueError, match="paged cache unsupported"):
        tmodel.decode(ct, rg[3], [], torch.zeros(1, 1, dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32),
                      block_table=torch.zeros(1, 1, dtype=torch.int32))


def test_hybrid_decode_consistency_through_the_port(rg):
    decode_consistency(rg[1], rg[3])
