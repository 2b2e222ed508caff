"""The port's MoE layer (repro_torch.models.moe) against the reference's
(repro.models.moe.moe_apply) at the smoke configs of dbrx-132b and
grok-1-314b (4 experts, top-2) and their own capacity factor 1.25, with
tokens dropped; the GeGLU activation against jax.nn.gelu; top-k ties; and
the refusal of chunked prefill, and a moe_ep config without a mesh. f32, atol = rtol =
1e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core.engine import InferenceServer as JServer  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.param import split  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core.engine import InferenceServer as TServer  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import gate_act  # noqa: E402
from repro_torch.models.param import Dense  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
MOE_ARCHS = ["dbrx-132b", "grok-1-314b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer(arch, seed=0):
    cj, ct = jget(arch).smoke(), tget(arch).smoke()
    pj = split(jmoe.moe_init(cj, jax.random.PRNGKey(seed)))[0]
    pt = tmoe.MoE(*(Dense(_t(pj[n]["w"])) for n in
                    ("router", "w1", "w2", "w3")))
    return cj, ct, pj, pt


def _tokens(B, T, d, seed, spread):
    """Tokens near one shared direction (`spread` scales the rest), so the
    router sends many of them to the same experts and some overflow."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, 1, d))
    return (base + spread * rng.normal(size=(B, T, d))).astype(np.float32)


def _drop_count(cfg, gate_idx, S):
    """Assignments past their expert's capacity, from the reference's own
    top-k indices (G, S, k): the port's count is held to this."""
    E, C = cfg.moe.n_experts, tmoe.capacity(cfg, S)
    oh = np.eye(E, dtype=np.int64)[np.asarray(gate_idx)]
    oh = oh.reshape(oh.shape[0], -1, E)
    pos = ((np.cumsum(oh, 1) - oh) * oh).sum(-1)
    return int((pos >= C).sum())


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("B,T", [(3, 16), (16, 1)],
                         ids=["prefill-by-sequence", "decode-global"])
def test_moe_layer_matches_reference_with_drops(arch, B, T):
    """Prefill routes each sequence as its own group, decode all B rows as
    one; at capacity factor 1.25 some assignments overflow and are
    dropped. Output and aux loss equal the reference's, and the port's
    drop count equals the count from the reference's routing."""
    cj, ct, pj, pt = _layer(arch)
    assert ct.moe.capacity_factor == 1.25
    x = _tokens(B, T, ct.d_model, seed=B + T, spread=0.5)
    want, aux_j = jmoe.moe_apply(cj, pj, jnp.asarray(x))
    with tmoe.record_routing() as routes:
        got, aux_t = tmoe.moe_apply(ct, pt, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)
    G, S = (B, T) if T > 1 else (1, B)
    xg = jnp.asarray(x).reshape(G, S, -1)
    probs = jax.nn.softmax(xg @ pj["router"]["w"], axis=-1)
    _, idx = jax.lax.top_k(probs, ct.moe.top_k)
    want_drops = _drop_count(ct, idx, S)
    assert len(routes) == 1 and int(routes[0]["dropped"]) == want_drops
    np.testing.assert_array_equal(routes[0]["idx"].numpy(), np.asarray(idx))
    assert int((~routes[0]["keep"]).sum()) == want_drops
    assert 0 < want_drops < G * S * ct.moe.top_k


def test_capacity_matches_reference_formula():
    for arch in MOE_ARCHS:
        for smoke in (False, True):
            cfg = tget(arch).smoke() if smoke else tget(arch)
            E, k, cf = cfg.moe.n_experts, cfg.moe.top_k, \
                cfg.moe.capacity_factor
            for S in (1, 3, 8, 16, 100, 256, 2048):
                c = max(int(S * k * cf / E + 0.999), k)
                assert tmoe.capacity(cfg, S) == -(-c // 4) * 4


def test_top_k_breaks_ties_to_the_lower_index():
    """Rows with equal probabilities: the port's top-k picks what
    jax.lax.top_k picks (the lower expert index first)."""
    p = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                  [0.3, 0.2, 0.3, 0.2], [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        vj, ij = jax.lax.top_k(jnp.asarray(p), k)
        vt, it = tmoe.top_k(_t(p), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_geglu_matches_jax_gelu():
    """GeGLU is jax.nn.gelu (the tanh approximation) times the gate; the
    exact-erf gelu differs from it by far more than the tolerance here,
    so this pins the approximation."""
    rng = np.random.default_rng(1)
    a = (4 * rng.normal(size=(64, 32))).astype(np.float32)
    b = rng.normal(size=(64, 32)).astype(np.float32)
    cfg = tget("grok-1-314b").smoke()
    assert cfg.mlp_act == "geglu"
    want = np.asarray(jax.nn.gelu(jnp.asarray(a)) * jnp.asarray(b))
    got = gate_act(cfg, _t(a), _t(b)).numpy()
    # f32 tanh in two libraries: a few ulp apart in the far tails
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    erf = (torch.nn.functional.gelu(_t(a)) * _t(b)).numpy()
    assert np.abs(erf - want).max() > 1e-4
    silu = gate_act(tget("dbrx-132b").smoke(), _t(a), _t(b)).numpy()
    np.testing.assert_allclose(
        silu, np.asarray(jax.nn.silu(jnp.asarray(a)) * jnp.asarray(b)),
        atol=1e-5, rtol=1e-5)


def test_moe_chunk_budget_raises_as_reference():
    """chunk_budget > 0 on a MoE config: both servers refuse it."""
    kw = dict(mode="caraserve", max_batch=4, cache_slots=64, seed=0,
              chunk_budget=16)
    with pytest.raises(ValueError, match="chunked") as ej:
        JServer(jget("dbrx-132b").smoke(), **kw)
    with pytest.raises(ValueError, match="chunked") as et:
        TServer(tget("dbrx-132b").smoke(), device="cpu", **kw)
    assert str(et.value) == str(ej.value)


def test_moe_ep_is_not_ported():
    """Expert parallelism is ported (models/moe_ep.py, held to the
    reference in test_torch_moe_ep.py); without a mesh a moe_ep config
    computes the default path's function over its EP-native weights, as
    the reference's does (one f-slice an expert: moe_ep_shards 1)."""
    kw = dict(moe_ep=True, moe_ep_shards=1)
    cj = dataclasses.replace(jget("dbrx-132b").smoke(), **kw)
    ct = dataclasses.replace(tget("dbrx-132b").smoke(), **kw)
    pj = split(jmoe.moe_init(cj, jax.random.PRNGKey(5)))[0]
    pt = tmoe.MoE(*(Dense(_t(pj[n]["w"])) for n in
                    ("router", "w1", "w2", "w3")))
    x = _tokens(2, 12, ct.d_model, seed=6, spread=0.5)
    want, _ = jmoe.moe_apply(cj, pj, jnp.asarray(x))
    got, _ = tmoe.moe_apply(ct, pt, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("flag", ["moe_2d_ff", "moe_gather_weights"])
def test_layout_flags_compute_the_same_function(flag):
    """moe_2d_ff and moe_gather_weights change only the reference's
    sharding: the port computes the default path's function, and so does
    the reference."""
    cj, ct, pj, pt = _layer("grok-1-314b", seed=3)
    x = _tokens(2, 12, ct.d_model, seed=4, spread=0.5)
    cjf = dataclasses.replace(cj, **{flag: True})
    ctf = dataclasses.replace(ct, **{flag: True})
    want, _ = jmoe.moe_apply(cjf, pj, jnp.asarray(x))
    got, _ = tmoe.moe_apply(ctf, pt, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
