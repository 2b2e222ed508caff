"""The port's kernel modules (repro_torch.kernels) against the reference's
Pallas kernels, run in interpret mode on the CPU as the reference's own
tests run them. On a CPU tensor each wrapper takes its plain PyTorch
version, so these tests hold the plain versions — what the CUDA kernels
are checked against on the card — to the TPU kernels' function. f32
throughout, atol = rtol = 1e-5: the same arithmetic in another summation
order. The CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-sized ops: one intra-op thread avoids oversubscribing the cores the
# reference (XLA) and the other test workers share
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import bgmv as jbgmv  # noqa: E402
from repro.kernels import mbgmv as jmbgmv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.paged import paged_attention as jpaged  # noqa: E402
from repro_torch.kernels import bgmv, build, mbgmv, ops, paged, ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------ paged attention ----

def _paged_case(seed, B, H, KV, hd, ps, P, W):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(P, KV, ps, hd)).astype(np.float32)
    v = rng.normal(size=(P, KV, ps, hd)).astype(np.float32)
    pp = np.full((P, ps), -1, np.int32)
    bt = np.full((B, W), -1, np.int32)
    pos = np.zeros((B,), np.int32)
    free = list(range(P))
    for b in range(B):
        n = int(rng.integers(1, W + 1))
        used = int(rng.integers(1, n * ps + 1))
        pos[b] = used - 1
        for j in range(n):
            pg = free.pop()
            bt[b, j] = pg
            filled = np.arange(ps) + j * ps
            pp[pg] = np.where(filled < used, filled, -1)
    return q, k, v, pp, bt, pos


def _edge_case(seed, B, H, KV, hd, ps, P, W):
    """An all-unclaimed row, a pos=0 row and a claimed-but-empty page, as
    the reference's conformance sweep builds them."""
    q, k, v, pp, bt, pos = _paged_case(seed, B, H, KV, hd, ps, P, W)
    bt[0] = -1
    pos[0] = 0
    if B > 1:
        pos[1] = 0
    last = B - 1
    if W > 1 and bt[last, 1] < 0:
        free = set(range(P)) - set(bt[bt >= 0].tolist())
        bt[last, 1] = free.pop()
    if bt[last, 1] >= 0:
        pp[bt[last, 1]] = -1
    return q, k, v, pp, bt, pos


def _both_paged(args):
    want = np.asarray(jpaged(*map(jnp.asarray, args)))
    got = paged.paged_attention(*map(_t, args)).numpy()
    return got, want


@pytest.mark.parametrize("ps", [8, 32])
@pytest.mark.parametrize("W", [2, 5])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("B", [1, 4])
def test_paged_attention_conformance_sweep(ps, W, group, B):
    KV = 2
    H, hd, P = KV * group, 16, W * B + 2
    args = _edge_case(ps * 1000 + W * 100 + group * 10 + B, B, H, KV, hd,
                      ps, P, W)
    got, want = _both_paged(args)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[0], np.zeros_like(got[0]))


@pytest.mark.parametrize("B,H,KV,hd,ps,P,W", [
    (4, 8, 4, 32, 16, 12, 4),
    (2, 4, 4, 64, 32, 6, 2),
    (3, 8, 2, 16, 8, 24, 5),
])
def test_paged_attention_matches_pallas(B, H, KV, hd, ps, P, W):
    got, want = _both_paged(_paged_case(B * H + ps, B, H, KV, hd, ps, P, W))
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_attention_ignores_foreign_pages():
    """NaN in every page a row does not own leaves that row's output
    unchanged; with large finite garbage the Pallas kernel agrees too."""
    q, k, v, pp, bt, pos = _paged_case(5, 3, 4, 2, 16, 8, 12, 3)
    base = paged.paged_attention(*map(_t, (q, k, v, pp, bt, pos))).numpy()
    for b in range(3):
        own = bt[b][bt[b] >= 0]
        foreign = np.setdiff1d(np.arange(12), own)
        k2, v2, pp2 = k.copy(), v.copy(), pp.copy()
        k2[foreign], v2[foreign], pp2[foreign] = np.nan, np.nan, 0
        got = paged.paged_attention(
            *map(_t, (q, k2, v2, pp2, bt, pos))).numpy()
        np.testing.assert_array_equal(got[b], base[b])
    k3 = k.copy()
    k3[bt[0, 0]] *= 100.0
    got, want = _both_paged((q, k3, v, pp, bt, pos))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[1:], base[1:], **TOL)


def test_paged_attention_shape_validation():
    q, k, v, pp, bt, pos = map(_t, _paged_case(0, 2, 4, 2, 8, 8, 6, 2))
    for bad in ((q[:, :3], k, v, pp, bt, pos), (q, k, v[:, :, :4], pp, bt,
                                                  pos),
                (q, k, v, pp[:, :4], bt, pos), (q, k, v, pp, bt[:1], pos),
                (q, k, v, pp, bt, pos[:1])):
        with pytest.raises(ValueError):
            paged.paged_attention(*bad)


# ----------------------------------------------------------------- LoRA ----

def _lora_pool(seed, slots, d_in, d_out, r_max, ranks):
    rng = np.random.default_rng(seed)
    a = np.zeros((slots, d_in, r_max), np.float32)
    b = np.zeros((slots, r_max, d_out), np.float32)
    for s, r in enumerate(ranks):
        a[s, :, :r] = rng.normal(size=(d_in, r)) * d_in ** -0.5
        b[s, :r] = rng.normal(size=(r, d_out)) * r ** -0.5
    return a, b, rng


@pytest.mark.parametrize("B,d_in,d_out,r_max", [(5, 256, 128, 16),
                                                (8, 128, 384, 8)])
def test_bgmv_shrink_expand_match_pallas(B, d_in, d_out, r_max):
    a, b, rng = _lora_pool(B, 4, d_in, d_out, r_max, [r_max, 3, 1, r_max])
    x = rng.normal(size=(B, d_in)).astype(np.float32)
    idx = rng.integers(-1, 4, B).astype(np.int32)
    idx[0] = -1
    y_want = np.asarray(jbgmv.bgmv_shrink(jnp.asarray(x), jnp.asarray(a),
                                          jnp.asarray(idx)))
    y = bgmv.bgmv_shrink(_t(x), _t(a), _t(idx))
    np.testing.assert_allclose(y.numpy(), y_want, **TOL)
    o_want = np.asarray(jbgmv.bgmv_expand(jnp.asarray(y_want),
                                          jnp.asarray(b), jnp.asarray(idx)))
    o = bgmv.bgmv_expand(y, _t(b), _t(idx))
    np.testing.assert_allclose(o.numpy(), o_want, **TOL)
    assert np.all(o.numpy()[0] == 0)
    full = np.asarray(jbgmv.bgmv(jnp.asarray(x), jnp.asarray(a),
                                 jnp.asarray(b), jnp.asarray(idx)))
    np.testing.assert_allclose(
        ops.lora_delta(_t(x), _t(a), _t(b), _t(idx)).numpy(), full, **TOL)


@pytest.mark.parametrize("rank_block", [4, 8])
def test_mbgmv_shrink_expand_match_pallas(rank_block):
    ranks = [16, 5, 8, 1]
    a, b, rng = _lora_pool(rank_block, 4, 128, 256, 16, ranks)
    # junk past each rank: MBGMV must not read it
    a[1, :, 8:] = 7.0
    x = rng.normal(size=(6, 128)).astype(np.float32)
    idx = np.array([0, 1, 2, 3, -1, 1], np.int32)
    ranks_np = np.asarray(ranks, np.int32)
    jargs = (jnp.asarray(idx), jnp.asarray(ranks_np))
    y_want = np.asarray(jmbgmv.mbgmv_shrink(jnp.asarray(x), jnp.asarray(a),
                                            *jargs, rank_block=rank_block))
    y = mbgmv.mbgmv_shrink(_t(x), _t(a), _t(idx), _t(ranks_np),
                           rank_block=rank_block)
    np.testing.assert_allclose(y.numpy(), y_want, **TOL)
    o_want = np.asarray(jmbgmv.mbgmv_expand(
        jnp.asarray(y_want), jnp.asarray(b), *jargs, rank_block=rank_block))
    o = mbgmv.mbgmv_expand(y, _t(b), _t(idx), _t(ranks_np),
                           rank_block=rank_block)
    np.testing.assert_allclose(o.numpy(), o_want, **TOL)
    live = ref.mbgmv_live(_t(idx), _t(ranks_np), rank_block).numpy()
    for row in range(6):
        assert np.all(y.numpy()[row, live[row]:] == 0)


@pytest.mark.parametrize("name", ["bgmv_shrink_ref", "bgmv_expand_ref",
                                  "bgmv_ref", "mbgmv_shrink_ref",
                                  "mbgmv_expand_ref", "mbgmv_ref"])
def test_named_plain_versions_match_reference_oracles(name):
    """ref.py's BGMV/MBGMV plain versions against the reference's jnp
    oracles of the same name (junk past a rank: MBGMV masks it)."""
    from repro.kernels import ref as jref
    ranks = [16, 5, 8, 1]
    a, b, rng = _lora_pool(11, 4, 64, 96, 16, ranks)
    a[1, :, 8:] = 3.0
    b[3, 4:] = -2.0
    x = rng.normal(size=(6, 64)).astype(np.float32)
    y = rng.normal(size=(6, 16)).astype(np.float32)
    idx = np.array([0, 1, 2, 3, -1, 1], np.int32)
    r = np.asarray(ranks, np.int32)
    arg = {"bgmv_shrink_ref": (x, a, idx), "bgmv_expand_ref": (y, b, idx),
           "bgmv_ref": (x, a, b, idx),
           "mbgmv_shrink_ref": (x, a, idx, r),
           "mbgmv_expand_ref": (y, b, idx, r),
           "mbgmv_ref": (x, a, b, idx, r)}[name]
    kw = {"rank_block": 4} if name.startswith("mbgmv") else {}
    want = np.asarray(getattr(jref, name)(*map(jnp.asarray, arg), **kw))
    got = getattr(ref, name)(*map(_t, arg), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_lora_delta_modes_agree_heterogeneous_ranks():
    """The public dispatcher: bgmv and mbgmv agree with the reference's
    dispatcher (and each other) on a zero-padded pool of mixed ranks."""
    ranks = [16, 8, 3, 1, 12]
    a, b, rng = _lora_pool(3, 5, 256, 128, 16, ranks)
    x = (rng.normal(size=(7, 256)) * 0.1).astype(np.float32)
    idx = np.array([0, 1, 2, 3, 4, -1, 2], np.int32)
    ranks_np = np.asarray(ranks, np.int32)
    want = np.asarray(jops.lora_delta(jnp.asarray(x), jnp.asarray(a),
                                      jnp.asarray(b), jnp.asarray(idx),
                                      mode="ref"))
    for mode, kw in (("bgmv", {}), ("mbgmv", {"ranks": _t(ranks_np)}),
                     ("mbgmv", {"ranks": _t(ranks_np), "rank_block": 8})):
        got = ops.lora_delta(_t(x), _t(a), _t(b), _t(idx), mode=mode, **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError):
        ops.lora_delta(_t(x), _t(a), _t(b), _t(idx), mode="mbgmv")
    with pytest.raises(ValueError):
        ops.lora_delta(_t(x), _t(a), _t(b), _t(idx), mode="sgmv")


def test_lora_wrappers_shape_validation():
    a, b, rng = _lora_pool(0, 3, 64, 32, 8, [8, 4, 2])
    x = _t(rng.normal(size=(4, 64)).astype(np.float32))
    idx = torch.zeros(4, dtype=torch.int32)
    live = torch.full((4,), 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        bgmv.lora_shrink(x[:, :32], _t(a), idx, live)        # d_in
    with pytest.raises(ValueError):
        bgmv.lora_shrink(x, _t(a), idx[:3], live)            # idx rows
    y = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        bgmv.lora_expand(y[:, :4], _t(b), idx, live)         # rank
    with pytest.raises(ValueError):
        bgmv.lora_expand(y.double(), _t(b), idx, live)       # dtype
    with pytest.raises(ValueError):
        mbgmv.mbgmv_shrink(x, _t(a), idx, torch.zeros(2, dtype=torch.int32),
                           rank_block=4)                     # ranks
    with pytest.raises(ValueError):
        mbgmv.mbgmv_shrink(x, _t(a), idx, torch.zeros(3, dtype=torch.int32),
                           rank_block=3)                     # r_max % rb


def test_cpu_tensors_never_build_or_count(monkeypatch):
    """A CPU tensor takes the plain version only because it lies on the
    CPU: the CUDA library is never built or loaded, no launch is
    counted."""
    def refuse():
        raise AssertionError("CPU call tried to build the CUDA kernels")
    monkeypatch.setattr(build, "library", refuse)
    before = (paged.paged_attention.launches, bgmv.lora_shrink.launches,
              bgmv.lora_expand.launches)
    q, k, v, pp, bt, pos = map(_t, _paged_case(1, 2, 4, 2, 8, 8, 6, 2))
    paged.paged_attention(q, k, v, pp, bt, pos)
    a, b, rng = _lora_pool(1, 2, 32, 16, 4, [4, 2])
    ops.lora_delta(_t(rng.normal(size=(3, 32)).astype(np.float32)), _t(a),
                   _t(b), torch.tensor([0, -1, 1], dtype=torch.int32))
    assert before == (paged.paged_attention.launches,
                      bgmv.lora_shrink.launches, bgmv.lora_expand.launches)
