"""The port's kernel modules (repro_torch.kernels) against the reference's
Pallas kernels, run in interpret mode on the CPU as the reference's own
tests run them. On a CPU tensor each wrapper takes its plain PyTorch
version, so these tests hold the plain versions — what the CUDA kernels
are checked against on the card — to the TPU kernels' function. f32
throughout, atol = rtol = 1e-5: the same arithmetic in another summation
order. The CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import collections
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
    # r_max 8 holds no whole rank block of 3: taken, live widths clamped
    # to the pool (the TPU kernels' whole-block rule is not the port's)
    ranks = torch.tensor([8, 4, 2], dtype=torch.int32)
    torch.testing.assert_close(
        mbgmv.mbgmv_shrink(x, _t(a), idx, ranks, rank_block=3),
        ref.mbgmv_shrink_ref(x, _t(a), idx, ranks, 3), rtol=0, atol=0)


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


# ------------------------------------- LoRA shrink at prefill layouts ----

def _segmented_idx(rows, seg, slots):
    """Prefill's layout: each row's slot repeated over a run of `seg`
    rows (core/lora.lora_apply repeats it T times), runs cycling through
    -1 (no adapter) and every slot; the last run is ragged."""
    return (np.arange(rows) // seg % (slots + 1) - 1).astype(np.int32)


@pytest.mark.parametrize("seg", [1, 17, 32, 64, 4096])
@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
def test_shrink_segmented_rows_match_pallas(mode, seg):
    """The plain shrink (what the row-tile kernel is held to on the card)
    against the Pallas kernels at segment boundaries inside and across
    64/128-row tiles, whole tiles of idx -1 rows, a ragged last tile, and
    ranks 8/16/32/64 (junk past each rank: MBGMV never reads it)."""
    ranks = [8, 16, 32, 64]
    a, _, rng = _lora_pool(seg, 4, 32, 8, 64, ranks)
    a[0, :, 16:] = 5.0
    rows = min(5 * max(seg, 64), 2 * seg) + 77
    x = rng.normal(size=(rows, 32)).astype(np.float32)
    idx = _segmented_idx(rows, seg, 4)
    r_np = np.asarray(ranks, np.int32)
    if mode == "bgmv":
        a[0, :, 16:] = 0.0               # BGMV reads every column
        want = jbgmv.bgmv_shrink(jnp.asarray(x), jnp.asarray(a),
                                 jnp.asarray(idx))
        got = bgmv.bgmv_shrink(_t(x), _t(a), _t(idx))
    else:
        want = jmbgmv.mbgmv_shrink(jnp.asarray(x), jnp.asarray(a),
                                   jnp.asarray(idx), jnp.asarray(r_np),
                                   rank_block=16)
        got = mbgmv.mbgmv_shrink(_t(x), _t(a), _t(idx), _t(r_np),
                                 rank_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[idx < 0] == 0)


_SMS = 132                               # the H100 SXM's SM count


def _shrink_walk(plan, rows, d_in, r_max, slots, idx, live, x=None, a=None):
    """csrc/lora.cu's persistent wgmma shrink (lora_shrink_wgmma_kernel),
    emulated as its producer hands out the walk and its consumers sum it:
    cluster c takes the tiles `bgmv.shrink_walk` gives it; a tile's rows
    get their slots (-1: no adapter) and live widths, its distinct slots
    in order of their first row, two to a pass, each pass per 64 rank
    columns below both slots' widest live widths (rounded up to 8; past
    one of them, the two go one at a time), a stage per 64-wide box of
    each block's d slice, x's box read once for the stage's slots and A's
    box once for each of them; a pass past every live width and a tile
    with no adapter are items with no stage. With x and a, each block's
    stage products are added in f32 stage by stage, the blocks' partials
    in rank order, columns past nc or a row's live width zeroed, as the
    kernel does. Returns y (NaN where never written), the writes of each
    (row, column), the (row0, slot, c0) of each cluster's slot passes,
    and each block's loads as (cluster, part) -> {"x": [(row0, c0, kt)],
    "a": [(row0, slot, c0, kt)]}."""
    tile, split, d_chunk = plan.tile, plan.split, plan.d_chunk
    y = np.full((rows, r_max), np.nan, np.float32)
    writes = np.zeros((rows, r_max), int)
    passes, loads = [], {}
    per = tile // split
    for c, tiles in enumerate(bgmv.shrink_walk(rows, plan)):
        cl_passes = []
        blocks = []                                  # per block: lo, hi, nk
        for p in range(split):
            lo, hi = p * d_chunk, min(d_in, (p + 1) * d_chunk)
            blocks.append((lo, hi, -(-(hi - lo) // bgmv.TILE_D)
                           if hi > lo else 0))
            loads[(c, p)] = {"x": [], "a": []}
        for row0 in tiles:
            rr = np.arange(row0, min(row0 + tile, rows))
            sl = np.where((idx[rr] >= 0) & (idx[rr] < slots), idx[rr], -1)
            lv = np.where(sl >= 0, np.clip(live[rr], 0, r_max), 0)
            writes[rr[sl < 0]] += 1                  # zero rows, by owners
            y[rr[sl < 0]] = 0.0
            order = list(dict.fromkeys(int(v) for v in sl if v >= 0))
            ncols = {s: -(-int(lv[sl == s].max()) // 8) * 8 for s in order}

            def one(group, c0):
                """A pass of the slots `group` (one or two) over columns c0:
                each block streams x's boxes once for them and A's boxes
                once for each; a slot past its live widths only writes
                zeros."""
                cc = min(64, r_max - c0)
                for s in group:
                    mine = rr[sl == s]
                    writes[mine, c0:c0 + cc] += 1
                    if ncols[s] - c0 <= 0:
                        y[mine, c0:c0 + cc] = 0.0
                group = [s for s in group if ncols[s] - c0 > 0]
                if not group:
                    return
                totals = {s: np.zeros(((sl == s).sum(), 64), np.float32)
                          for s in group}
                for s in group:
                    cl_passes.append((row0, s, c0))
                for p, (lo, hi, nk) in enumerate(blocks):
                    accs = {s: np.zeros_like(totals[s]) for s in group}
                    for kt in range(nk):             # stage by stage in f32
                        loads[(c, p)]["x"].append((row0, c0, kt))
                        d0 = lo + kt * bgmv.TILE_D
                        d1 = min(hi, d0 + bgmv.TILE_D)
                        for s in group:
                            loads[(c, p)]["a"].append((row0, s, c0, kt))
                            if x is None:
                                continue
                            w = np.zeros((d1 - d0, 64), np.float32)
                            w[:, :cc] = a[s, d0:d1, c0:c0 + cc]
                            accs[s] = accs[s] + (x[rr[sl == s], d0:d1] @ w
                                                 ).astype(np.float32)
                    for s in group:                  # rank order
                        totals[s] = totals[s] + accs[s]
                if x is None:
                    return
                cols = np.arange(64)[None]
                for s in group:
                    mine = rr[sl == s]
                    keep = (cols < ncols[s] - c0) & (
                        c0 + cols < live[mine][:, None])
                    y[mine, c0:c0 + cc] = np.where(keep, totals[s],
                                                   0.0)[:, :cc]

            for j in range(0, len(order), 2):
                two = order[j:j + 2]                 # slots two to a pass
                for c0 in range(0, r_max, 64):
                    if len(two) == 2 and min(ncols[s] for s in two) > c0:
                        one(two, c0)
                    else:                            # one at a time
                        for s in two:
                            one([s], c0)
        passes.append(cl_passes)
        # every row of a tile has one owner: part (row - row0) // per
        assert per * split == tile
    return y, writes, passes, loads


def _shrink_layouts(rows, slots, seed):
    """idx layouts a row-tile launch takes: slots at random (idx -1 among
    them), runs of 17 and of 32 rows a slot (tiles of two slots), every
    row at one slot (training, the chunk), runs of 4,096 (the prefill)."""
    rng = np.random.default_rng(seed)
    return {"random": rng.integers(-1, slots, rows).astype(np.int32),
            "runs of 17": _segmented_idx(rows, 17, slots),
            "runs of 32": _segmented_idx(rows, 32, slots),
            "one slot": np.full(rows, slots - 1, np.int32),
            "runs of 4096": (np.arange(rows) // 4096 % slots).astype(
                np.int32)}


@pytest.mark.parametrize("rows", [
    bgmv.DECODE_MAX_ROWS + 1, 65, 129, 512, 4096, 128 * _SMS - 1,
    128 * _SMS, 128 * (_SMS - 1) + 1, 128 * _SMS + 1, 32768])
@pytest.mark.parametrize("d_in", [4096, 520, 8])
@pytest.mark.parametrize("slots", [1, 8, 300])
def test_shrink_plan_covers_each_row_once(rows, d_in, slots):
    """The row-tile launch plans computed on the host from shapes alone
    (above DECODE_MAX_ROWS; the decode plan has its own tests below).
    bf16 at a d_in that is a multiple of 8: the persistent wgmma kernel,
    SHRINK_ROWS-row tiles walked by clusters of `split` d slices (whole
    TILE_D boxes, at least MIN_SLICE_D past one, covering d_in once, none
    empty), no more clusters than the card holds at once or than the
    tiles, every cluster some tiles; the least tiles x (stages + a
    reduction) a block; at the card's room (H100_CLUSTER_ROOM) and at a
    smaller one. Its walk emulated (`_shrink_walk`)
    at random, runs of 17 and 32, one slot and runs of 4,096: every (row,
    column) of y written exactly once, every distinct slot of every tile
    visited in row order, and in every block each box of the block's d
    slice of x read once for two slots of a tile (k slots: ceil(k / 2)
    times) and of A once for each slot. The cp.async kernel's plan (f32)
    as before: tiles
    of 128 rows where they alone fill every SM, else 64, one block per
    (tile, distinct slot) times `split` over d, as many as give no SM a
    second block, every row written by exactly one block."""
    small = {1: 100, 2: 40, 4: 12, 8: 4}         # a smaller card's room
    for rm in (bgmv.H100_CLUSTER_ROOM, small):
        plan = bgmv.shrink_plan(rows, d_in, slots, _SMS, 64,
                                torch.bfloat16, rm)
        tiles = -(-rows // bgmv.SHRINK_ROWS)
        split = plan.split
        assert plan.tile == bgmv.SHRINK_ROWS and plan.per_tile == 0
        assert split in (1, 2, 4, 8) and plan.grid % split == 0
        clusters = plan.grid // split
        assert 1 <= clusters <= min(rm[split], tiles)
        assert split == 1 or d_in >= 2 * split * bgmv.MIN_SLICE_D
        assert plan.d_chunk % bgmv.TILE_D == 0
        d_hits = np.zeros(d_in, int)
        for part in range(split):             # each block's d slice
            lo = part * plan.d_chunk
            assert lo < d_in                   # no block without d
            d_hits[lo:min(d_in, lo + plan.d_chunk)] += 1
        assert np.all(d_hits == 1)

        def cost(k):
            dc = -(-(-(-d_in // k)) // bgmv.TILE_D) * bgmv.TILE_D
            g = max(1, min(rm[k], tiles))
            return -(-tiles // g) * (dc // bgmv.TILE_D + (
                bgmv.SHRINK_EXCHANGE if k > 1 else 1))
        fits = [k for k in (1, 2, 4, 8)
                if k == 1 or d_in >= 2 * k * bgmv.MIN_SLICE_D]
        assert cost(split) == min(map(cost, fits))
        assert split == min(k for k in fits if cost(k) == cost(split))
        walk = bgmv.shrink_walk(rows, plan)
        assert len(walk) == clusters and all(walk)   # every cluster works
        assert sorted(r for w in walk for r in w) == list(
            range(0, rows, bgmv.SHRINK_ROWS))
        if d_in == 4096 and rm is bgmv.H100_CLUSTER_ROOM:
            if rows == 512:                    # the chunk: one tile each
                assert (split, clusters) == (8, 8)
            if rows == 4096:                   # training: one tile each
                assert (split, clusters) == (2, 64)
            if rows == 32768:                  # the prefill: 4 tiles each
                assert (split, clusters) == (1, 132)
    plan = bgmv.shrink_plan(rows, d_in, slots, _SMS, 64, torch.bfloat16,
                            bgmv.H100_CLUSTER_ROOM)
    rng = np.random.default_rng(rows + slots)
    for name, idx in _shrink_layouts(rows, slots, rows + d_in).items():
        live = np.where(idx >= 0, rng.integers(1, 65, rows), 0)
        if name == "one slot":
            live[:] = 64
        _, writes, passes, loads = _shrink_walk(plan, rows, d_in, 64, slots,
                                                idx, live)
        assert np.all(writes == 1), name
        for c, tiles in enumerate(bgmv.shrink_walk(rows, plan)):
            for row0 in tiles:                 # every slot of every tile
                t = idx[row0:row0 + plan.tile]
                want = list(dict.fromkeys(int(v) for v in t
                                          if 0 <= v < slots))
                got = [s for r0, s, _ in passes[c] if r0 == row0]
                assert got == want, (name, c, row0)
            for p in range(plan.split):        # each block's loads
                nk = len(range(p * plan.d_chunk, min(
                    d_in, (p + 1) * plan.d_chunk), bgmv.TILE_D))
                got_x = collections.Counter(loads[(c, p)]["x"])
                want_x = collections.Counter()
                for row0 in tiles:             # every live width >= 1
                    k = len(dict.fromkeys(
                        int(v) for v in idx[row0:row0 + plan.tile]
                        if 0 <= v < slots))
                    for kt in range(nk):
                        want_x[(row0, 0, kt)] = -(-k // 2)
                assert got_x == want_x, (name, c, p)
                got_a = collections.Counter(loads[(c, p)]["a"])
                assert got_a == collections.Counter(
                    (r0, s, c0, kt) for r0, s, c0 in passes[c]
                    for kt in range(nk)), (name, c, p)
    # the cp.async tile kernel's plan (f32), unchanged
    plan = bgmv.shrink_plan(rows, d_in, slots, _SMS, 64, torch.float32,
                            bgmv.H100_CLUSTER_ROOM)
    big = -(-rows // 128) >= _SMS
    assert plan.tile == (128 if big else 64)
    assert plan.tile in bgmv.TILE_ROWS
    assert plan.per_tile == min(slots, plan.tile)
    n_tiles = -(-rows // plan.tile)
    split = plan.split
    assert split in (1, 2, 4, 8) and split <= bgmv.MAX_TILE_SPLIT
    assert plan.grid == n_tiles * plan.per_tile * split
    assert n_tiles * split <= max(n_tiles, _SMS)     # one block an SM
    if 2 * n_tiles > _SMS:
        assert split == 1                 # tiles that fill half the card
    else:                                 # the most that fit it once
        assert split == bgmv.MAX_TILE_SPLIT \
            or 2 * n_tiles * split > _SMS \
            or d_in < 2 * split * bgmv.MIN_SLICE_D
    if split > 1:
        assert -(-d_in // split) >= bgmv.MIN_SLICE_D // 2
    assert plan.d_chunk % bgmv.TILE_D == 0
    d_hits = np.zeros(d_in, int)
    for part in range(split):             # the kernel's d slice of a block
        lo = part * plan.d_chunk
        d_hits[lo:min(d_in, lo + plan.d_chunk)] += 1
    assert np.all(d_hits == 1)
    per = plan.tile // split              # rows a part writes
    for idx in (rng.integers(-1, slots, rows),
                _segmented_idx(rows, 17, slots),
                np.full(rows, slots - 1, np.int32)):
        hits = np.zeros(rows, int)
        for t in range(n_tiles):          # the kernel's blocks (t, k, part)
            lo = t * plan.tile
            tile = idx[lo:lo + plan.tile]
            firsts = list(dict.fromkeys(int(i) for i in tile if i >= 0))
            assert len(firsts) <= plan.per_tile
            for k in range(plan.per_tile):
                for part in range(split):
                    mine = np.zeros(len(tile), bool)
                    mine[part * per:(part + 1) * per] = True
                    if k < len(firsts):
                        hits[lo + np.flatnonzero(mine & (tile == firsts[k]))
                             ] += 1
                    if k == 0 and part == 0:
                        hits[lo + np.flatnonzero(tile < 0)] += 1
        assert np.all(hits == 1)


@pytest.mark.parametrize("rows,d_in,slots,layout,r_max", [
    (300, 1024, 4, "runs of 17", 16), (512, 4096, 8, "one slot", 16),
    (130, 520, 2, "runs of 64", 16), (300, 1024, 8, "random", 64),
    (2048 + 37, 512, 8, "runs of 32", 64), (4096, 2048, 1, "one slot", 64),
    (8192 + 77, 256, 8, "runs of 4096", 64), (1100, 256, 300, "random", 16),
    (300, 512, 4, "runs of 17", 128), (4133, 1024, 1, "one slot", 24)])
def test_split_shrink_rank_order_sum_matches_plain_and_pallas(rows, d_in,
                                                              slots, layout,
                                                              r_max):
    """The persistent wgmma kernel's arithmetic, emulated in numpy
    (`_shrink_walk`): each block of a cluster adds x[the tile's rows of the
    slot, a 64-wide box of its d slice] @ A[s][that box, 64 columns] into
    an f32 total stage by stage, the cluster adds the blocks' totals in
    rank order and zeros the columns past each row's live width. That
    equals the plain shrink (`ref.lora_shrink_ref`, what the kernel is
    held to on the card) within f32's 1e-5, and the Pallas bgmv_shrink in
    interpret mode, at plans of 1 to 8 d slices (a cluster); at runs of 17
    and 32 rows (tiles of several slots), one slot (the chunk, training at
    a narrower d_in), runs of 4,096 (the prefill's layout), 300 slots,
    r_max 128 (two column passes a tile) and 24, and a partial tile."""
    ranks = ([r_max, r_max // 2] * slots)[:slots]
    a, _, rng = _lora_pool(rows + r_max, slots, d_in, 8, r_max, ranks)
    x = rng.normal(size=(rows, d_in)).astype(np.float32)
    idx = {"runs of 64": _segmented_idx(rows, 64, slots),
           **_shrink_layouts(rows, slots, rows)}[layout]
    idx[0] = slots - 1                    # every layout holds a slot
    live = ref.bgmv_live(_t(idx), r_max).numpy()
    plan = bgmv.shrink_plan(rows, d_in, slots, _SMS, r_max, torch.bfloat16,
                            bgmv.H100_CLUSTER_ROOM)
    assert plan.tile == bgmv.SHRINK_ROWS and plan.per_tile == 0
    got, writes, _, _ = _shrink_walk(plan, rows, d_in, r_max, slots, idx,
                                     live, x, a)
    assert np.all(writes == 1)
    want = ref.lora_shrink_ref(_t(x), _t(a), _t(idx), _t(live)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    pallas = jbgmv.bgmv_shrink(jnp.asarray(x), jnp.asarray(a),
                               jnp.asarray(idx))
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


# ------------------------------------------------ LoRA decode plans ----

def _decode_groups(idx, live, slots, rows, r_max):
    """The decode kernels' prologue (csrc/lora.cu: decode_group): the rows'
    distinct slots in order of their first row, each with its rows (in
    row order) and its widest live width rounded up to 8; and the rows
    without an adapter."""
    sl = [int(i) if 0 <= i < slots else -1 for i in idx[:rows]]
    groups = []
    for s in dict.fromkeys(v for v in sl if v >= 0):
        mine = [r for r in range(rows) if sl[r] == s]
        wide = max(max(0, min(int(live[r]), r_max)) for r in mine)
        groups.append((s, mine, -(-wide // 8) * 8))
    return groups, [r for r in range(rows) if sl[r] < 0]


def _decode_layouts(rows, slots, r_max, seed):
    """idx and live layouts a decode batch takes: slots at random (idx -1
    among them) with random live widths, runs of 17 rows a slot, every row
    at one slot, no row adapted."""
    rng = np.random.default_rng(seed)
    lives = rng.integers(0, r_max + 1, rows)
    return [(rng.integers(-1, slots, rows), lives),
            (_segmented_idx(rows, 17, slots), np.full(rows, r_max)),
            (np.full(rows, slots - 1), lives),
            (np.full(rows, -1), np.zeros(rows, int))]


@pytest.mark.parametrize("rows", [1, 8, 17, 33, 63, bgmv.DECODE_MAX_ROWS])
@pytest.mark.parametrize("d_in", [8, 520, 4096, 4100])
@pytest.mark.parametrize("r_max", [8, 64, 1024])
def test_decode_shrink_plan_reads_each_slot_slice_once(rows, d_in, r_max):
    """The decode shrink's plan (up to DECODE_MAX_ROWS rows) and its
    blocks as csrc/lora.cu's lora_shrink_decode_kernel walks them: block
    (part, g, k) takes the k-th distinct slot (`_decode_groups`), rank
    columns [16 g, 16 g + 16) (DECODE_SHRINK_COLS) and d [part * d_chunk,
    ...), split blocks a cluster: the most of 1, 2, 4, 8 that give each
    at least DECODE_SLICE_D of d, d_chunk in whole 16-wide k-steps covering d_in
    once. At 1 to 64 rows, d_in tails and r_max up to 1,024, at random
    slots and live widths and at runs of rows a slot: every (row, rank
    column) of y written by exactly one block (the slot's rows by the
    cluster's part p, a 1 / split share; rows without an adapter by the
    blocks of k = 0, part 0), every (slot, d, column below the slot's
    widest live width) of A read by exactly one block and no column past
    it, and every block's x rows those of its slot."""
    for slots in (1, 8, 300):
        plan = bgmv.shrink_plan(rows, d_in, slots, _SMS, r_max,
                                torch.bfloat16, bgmv.H100_CLUSTER_ROOM)
        split, d_chunk = plan.split, plan.d_chunk
        assert plan.tile == 0 and split in (1, 2, 4, 8)
        assert split == 1 or d_in >= split * bgmv.DECODE_SLICE_D
        assert split == bgmv.MAX_TILE_SPLIT \
            or d_in < 2 * split * bgmv.DECODE_SLICE_D
        assert d_chunk % 16 == 0 and (split - 1) * d_chunk < d_in \
            <= split * d_chunk
        groups = bgmv.col_groups(r_max)
        per = max(1, min(slots, rows))
        assert plan.per_tile == per
        assert plan.grid == per * split * groups
        for idx, live in _decode_layouts(rows, slots, r_max,
                                         rows + d_in + r_max):
            firsts, zero_rows = _decode_groups(idx, live, slots, rows,
                                               r_max)
            assert len(firsts) <= per
            writes = np.zeros((rows, r_max), int)
            reads = {s: np.zeros((d_in, r_max), int) for s, _, _ in firsts}
            for k in range(per):
                for g in range(groups):
                    c0 = g * bgmv.DECODE_SHRINK_COLS
                    cw = min(bgmv.DECODE_SHRINK_COLS, r_max - c0)
                    for part in range(split):
                        if k == 0 and part == 0:
                            writes[zero_rows, c0:c0 + cw] += 1
                        if k >= len(firsts):
                            continue
                        s, mine, ncol = firsts[k]
                        nc = min(cw, ncol - c0)
                        if nc <= 0:
                            if part == 0:
                                writes[mine, c0:c0 + cw] += 1
                            continue
                        lo, hi = part * d_chunk, min(d_in, (part + 1)
                                                     * d_chunk)
                        reads[s][lo:hi, c0:c0 + nc] += 1
                        share = -(-len(mine) // split)
                        writes[mine[part * share:(part + 1) * share],
                               c0:c0 + cw] += 1
            assert np.all(writes == 1)
            for s, _, ncol in firsts:
                assert np.all(reads[s][:, :ncol] == 1)
                assert np.all(reads[s][:, ncol:] == 0)


@pytest.mark.parametrize("rows,d_in,slots", [(8, 4096, 8), (64, 1024, 4),
                                             (17, 4100, 12), (1, 520, 8)])
def test_decode_shrink_rank_order_sum_matches_plain_and_pallas(rows, d_in,
                                                               slots):
    """The decode shrink's arithmetic, emulated in numpy: the cluster's
    block `part` sums x[the slot's rows, its d slice] @ A[s][its d slice]
    in f32, the parts' partials are added in rank order and the columns
    past each row's live width zeroed. That equals the plain shrink (what
    the kernel is held to on the card) within f32's 1e-5, and the Pallas
    bgmv_shrink in interpret mode."""
    ranks = [16, 8] * (slots // 2)
    a, _, rng = _lora_pool(rows + d_in, slots, d_in, 8, 16, ranks)
    x = rng.normal(size=(rows, d_in)).astype(np.float32)
    idx = rng.integers(-1, min(slots, 8), rows).astype(np.int32)
    live = ref.bgmv_live(_t(idx), 16).numpy()
    plan = bgmv.shrink_plan(rows, d_in, slots, _SMS, 16, torch.bfloat16,
                            bgmv.H100_CLUSTER_ROOM)
    assert plan.tile == 0
    got = np.zeros((rows, 16), np.float32)
    firsts, _ = _decode_groups(idx, live, slots, rows, 16)
    for s, mine, _ in firsts:
        total = np.zeros((len(mine), 16), np.float32)
        for p in range(plan.split):        # rank order
            sl = slice(p * plan.d_chunk, (p + 1) * plan.d_chunk)
            total = total + (x[mine, sl] @ a[s, sl]).astype(np.float32)
        total[np.arange(16)[None] >= live[mine][:, None]] = 0.0
        got[mine] = total
    want = ref.lora_shrink_ref(_t(x), _t(a), _t(idx), _t(live)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    pallas = jbgmv.bgmv_shrink(jnp.asarray(x), jnp.asarray(a),
                               jnp.asarray(idx))
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("rows", [1, 8, 33, bgmv.DECODE_MAX_ROWS])
@pytest.mark.parametrize("d_out", [8, 136, 4096, 4100])
@pytest.mark.parametrize("r_max", [8, 64, 1024])
def test_decode_expand_plan_writes_each_output_once(rows, d_out, r_max):
    """The decode expand (expand_plan 0, up to DECODE_MAX_ROWS rows) as
    csrc/lora.cu's lora_expand_decode_kernel walks it: block (row, j)
    writes output columns [j * DECODE_EXPAND_COLS, ...) of its row, lane
    l of a warp 8 of them, warp w summing live rank rows w, w +
    RANK_SPLIT, ... At 1 to 64 rows, d_out tails and r_max up to 1,024,
    at random slots and live widths and at runs of rows a slot: every
    (row, column) of out written by exactly one block (rows without an
    adapter as zeros), and every live rank row of a row's slot summed by
    exactly one warp for each of the row's columns, none past the row's
    live width."""
    for dt in (torch.bfloat16, torch.float32):
        assert bgmv.expand_plan(rows, d_out, _SMS, dt) == (0, 0)
    cols, split = bgmv.DECODE_EXPAND_COLS, bgmv.RANK_SPLIT
    assert cols == 32 * 8                 # a lane's 8 columns, 32 lanes
    for slots in (1, 8, 300):
        for idx, live in _decode_layouts(rows, slots, r_max,
                                         rows + d_out + r_max):
            writes = np.zeros((rows, d_out), int)
            for row in range(rows):
                s = int(idx[row])
                lv = max(0, min(int(live[row]), r_max)) \
                    if 0 <= s < slots else 0
                used = np.zeros((r_max, d_out), int)
                for j in range(-(-d_out // cols)):
                    n0 = j * cols
                    writes[row, n0:n0 + cols] += 1
                    for w in range(split):    # warp w's rank rows
                        used[w:lv:split, n0:n0 + cols] += 1
                assert np.all(used[:lv] == 1)
                assert np.all(used[lv:] == 0)
            assert np.all(writes == 1)


def test_expand_takes_f32_y_rounded_as_cast():
    """lora_expand of an f32 y rounds it to B's dtype first, as
    `y.to(b.dtype)` does (the decode kernel rounds as it loads): bitwise
    the expand of the cast y, in bf16 and f32; `ops.lora_delta` passes the
    shrink's f32 y on, with the same numbers as an explicit cast; y of
    another dtype raises."""
    a, b, rng = _lora_pool(7, 4, 64, 48, 16, [16, 8, 16, 8])
    idx = _t(np.array([0, 3, -1, 1, 0, 2], np.int32))
    y = _t(rng.normal(size=(6, 16)).astype(np.float32))
    x = _t(rng.normal(size=(6, 64)).astype(np.float32))
    for dt in (torch.bfloat16, torch.float32):
        bt = _t(b).to(dt)
        live = ref.bgmv_live(idx, 16)
        assert torch.equal(bgmv.lora_expand(y, bt, idx, live),
                           bgmv.lora_expand(y.to(dt), bt, idx, live))
        at, xt = _t(a).to(dt), x.to(dt)
        ys = bgmv.lora_shrink(xt, at, idx, live)
        assert torch.equal(ops.lora_delta(xt, at, bt, idx, live=live),
                           bgmv.lora_expand(ys.to(dt), bt, idx, live))
    with pytest.raises(ValueError, match="or float32"):
        bgmv.lora_expand(y.half(), _t(b).bfloat16(), idx,
                         ref.bgmv_live(idx, 16))


# ------------------------------------- LoRA expand at prefill layouts ----

@pytest.mark.parametrize("seg", [1, 17, 64])
@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
def test_expand_segmented_rows_match_pallas(mode, seg):
    """The plain expand (what both expand kernels are held to on the card)
    against the Pallas bgmv/mbgmv_expand at prefill's layouts: runs of
    `seg` rows per slot cycling through -1 and every slot, live widths
    4/8/16 (junk in y past each row's live width and in B past each rank:
    MBGMV never reads them)."""
    ranks = [4, 8, 16]
    _, b, rng = _lora_pool(seg + 100, 3, 8, 40, 16, ranks)
    rows = 2 * max(seg, 64) + 77
    idx = _segmented_idx(rows, seg, 3)
    y = rng.normal(size=(rows, 16)).astype(np.float32)
    r_np = np.asarray(ranks, np.int32)
    if mode == "bgmv":
        want = jbgmv.bgmv_expand(jnp.asarray(y), jnp.asarray(b),
                                 jnp.asarray(idx))
        got = bgmv.bgmv_expand(_t(y), _t(b), _t(idx))
    else:
        live = ref.mbgmv_live(_t(idx), _t(r_np), 4).numpy()
        y[np.arange(16)[None] >= live[:, None]] = 9.0
        b[0, 4:], b[1, 8:] = 3.0, -5.0
        want = jmbgmv.mbgmv_expand(jnp.asarray(y), jnp.asarray(b),
                                   jnp.asarray(idx), jnp.asarray(r_np),
                                   rank_block=4)
        got = mbgmv.mbgmv_expand(_t(y), _t(b), _t(idx), _t(r_np),
                                 rank_block=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[idx < 0] == 0)


@pytest.mark.parametrize("rows", [65, 512, 4096, 4133, 32768])
@pytest.mark.parametrize("d_out", [8, 384, 512, 4096])
@pytest.mark.parametrize("slots", [1, 8, 300])
def test_expand_plan_covers_each_output_once(rows, d_out, slots):
    """The expand's row-tile plans, computed on the host from `rows`
    (above DECODE_MAX_ROWS; the decode plan has its own test above), d_out
    and the SM count. bf16 (these widths are multiples of 8) takes the
    persistent wgmma kernel: min(tiles, 2 x SMs) blocks, block b walking
    the tiles [T b // blocks, T (b + 1) // blocks) of EXPAND_ROWS rows x
    `cols` columns numbered column tile by column tile (`expand_walk`, the
    kernel's own walk). Every tile is visited once, by one block; the
    tiles cover each (row, column) once (rows and columns each
    partitioned, the tiles their product), so each element is written by
    one store; a block's tiles are consecutive, a column tile's in row
    order, so the tiles of one slot (runs of rows a slot: prefill and
    training) at one column tile are one run of the block's tiles that
    read B (tiles without an adapter read none) and its B stays loaded;
    and a tile's items (a pass a distinct slot, in row
    order, rows without an adapter zeros) write each row once. f32 takes
    the mma.sync tiles of EXPAND_ROWS rows, block k of a column tile walking
    the tiles k, k + blocks, ... (as many blocks as fill every SM twice in
    one round), visiting each tile's distinct slots and zeroing its rows
    without an adapter. Checked at random and at prefill layouts."""
    tile = bgmv.EXPAND_ROWS
    tiles = -(-rows // tile)
    plan = bgmv.expand_plan(rows, d_out, _SMS, torch.bfloat16)
    assert plan.cols in bgmv.EXPAND_TILE_COLS
    col_tiles = -(-d_out // plan.cols)
    assert plan.grid == min(tiles * col_tiles,
                            bgmv.EXPAND_BLOCKS_PER_SM * _SMS)
    if plan.cols == bgmv.EXPAND_TILE_COLS[0]:   # the wide tiles leave SMs idle
        assert tiles * -(-d_out // bgmv.EXPAND_TILE_COLS[1]) < \
            bgmv.EXPAND_BLOCKS_PER_SM * _SMS
    walk = bgmv.expand_walk(rows, d_out, plan)
    assert len(walk) == plan.grid and all(walk)    # no idle block
    order = [t for run in walk for t in run]
    assert len(order) == len(set(order)) == tiles * col_tiles
    assert set(order) == {(r * tile, c * plan.cols) for r in range(tiles)
                          for c in range(col_tiles)}
    for starts, width, n in ((sorted({r for r, _ in order}), tile, rows),
                             (sorted({c for _, c in order}), plan.cols,
                              d_out)):
        hits = np.zeros(n, int)
        for lo in starts:
            hits[lo:lo + width] += 1
        assert np.all(hits == 1)
    for run in walk:                      # consecutive tiles, a column's
        for (r0, c0), (r1, c1) in zip(run, run[1:]):   # in row order
            assert (r1, c1) == ((r0 + tile, c0) if r0 + tile < rows
                                else (0, c0 + plan.cols))
    rng = np.random.default_rng(rows + slots + d_out)
    for idx in (rng.integers(-1, slots, rows),
                _segmented_idx(rows, 17, slots),
                _segmented_idx(rows, 4096, slots)):
        for run in walk:                  # a (slot, column) is one run of
            keys = [(frozenset(idx[r:r + tile].tolist()) - {-1}, c)
                    for r, c in run]      # the tiles that read B
            keys = [k for k in keys if k[0]]
            for k in set(keys):
                at = [i for i, x in enumerate(keys) if x == k]
                if len(k[0]) == 1:
                    assert at == list(range(at[0], at[-1] + 1))
        hits = np.zeros(rows, int)        # the kernel's items, a tile's rows
        for lo in range(0, rows, tile):
            part = idx[lo:lo + tile]
            for s in dict.fromkeys(int(i) for i in part if i >= 0):
                hits[lo + np.flatnonzero(part == s)] += 1
            hits[lo + np.flatnonzero(part < 0)] += 1
        assert np.all(hits == 1)
        # the mma.sync plan (f32): block k of a column tile, tiles k, k + n
        row_blocks, cols = bgmv.expand_plan(rows, d_out, _SMS,
                                            torch.float32)
        assert cols == 0 and 1 <= row_blocks <= tiles
        col_blocks = -(-d_out // bgmv.EXPAND_COLS)
        assert row_blocks * col_blocks <= max(2 * _SMS, col_blocks)
        hits = np.zeros(rows, int)
        for k in range(row_blocks):
            for t in range(k, tiles, row_blocks):
                lo = t * tile
                part = idx[lo:lo + tile]
                for s in dict.fromkeys(int(i) for i in part if i >= 0):
                    hits[lo + np.flatnonzero(part == s)] += 1
                hits[lo + np.flatnonzero(part < 0)] += 1
        assert np.all(hits == 1)


# ------------------------------------------ paged attention: splits ----

@pytest.mark.parametrize("W", [1, 5, 130])
@pytest.mark.parametrize("bkv", [1, 2, 8, 32, 131, 132, 256])
def test_paged_split_plan_covers_each_column_once(W, bkv):
    """The paged kernel's split count, chosen on the host from W, B x KV
    and the SM count: one split once B x KV blocks fill every SM, else
    runs of at least SPLIT_PAGES columns, at most 8 blocks an SM;
    split k takes the columns [k * ceil(W / n), (k + 1) * ceil(W / n)),
    which cover each block-table column of each (row, KV head) exactly
    once and leave no split empty."""
    n = paged.split_plan(1, bkv, W, _SMS, 1)
    assert n == paged.split_plan(bkv, 1, W, _SMS, 1)
    assert 1 <= n <= max(W, 1)
    if bkv >= _SMS:
        assert n == 1
    per = -(-W // n)
    hits = np.zeros(W, int)
    for k in range(n):
        lo, hi = k * per, min(W, (k + 1) * per)
        assert hi > lo                   # no empty split
        hits[lo:hi] += 1
    assert np.all(hits == 1)
    if n > 1:
        assert per >= paged.SPLIT_PAGES
        assert bkv * n <= paged.MAX_SPLIT_BLOCKS_PER_SM * _SMS


@pytest.mark.parametrize("KV,H", [(1, 8), (2, 8)])
def test_paged_attention_long_table_matches_pallas(KV, H):
    """A long block table (W 40, the yi-9b shape cut down) at GQA group 8
    and 4: unclaimed holes mid-table, a row with no claimed page, and a
    claimed-but-empty page; the plain version against the Pallas kernel."""
    B, hd, ps, W, P = 3, 16, 8, 40, 90
    rng = np.random.default_rng(H * 10 + KV)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(P, KV, ps, hd)).astype(np.float32)
    v = rng.normal(size=(P, KV, ps, hd)).astype(np.float32)
    pp = np.full((P, ps), -1, np.int32)
    bt = np.full((B, W), -1, np.int32)
    pos = np.zeros((B,), np.int32)
    free = list(rng.permutation(P))
    for b, n_tok in ((1, W * ps - 5), (2, 37)):
        for j in range(-(-n_tok // ps)):
            pg = free.pop()
            bt[b, j] = pg
            filled = np.arange(ps) + j * ps
            pp[pg] = np.where(filled < n_tok, filled, -1)
        pos[b] = n_tok - 1
    bt[1, [3, 17, 18]] = -1               # holes: those slots drop out
    bt[2, 6] = free.pop()                 # claimed, but empty
    got, want = _both_paged((q, k, v, pp, bt, pos))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[0], np.zeros_like(got[0]))
