"""The shapes the reference's Pallas kernels take beyond the registered
configs, held on the CPU: paged attention over any GQA group (MQA at
group 32 and 71) and any head dim, flash attention at any head dim up to
256, and the LoRA pair at widths that are no multiple of 8. The plain
versions (what the CUDA kernels are held to on the card) against the
Pallas kernels in interpret mode, as the reference's own tests run them;
the launch plans (group tiles, splits, padded widths) from the wrappers'
own functions; and two llama2-7b-smoke variants (MQA, hd 40) serving the
reference's greedy tokens.

Tolerances: f32 atol = rtol = 1e-5 for paged attention and the LoRA
pair (tests/test_torch_kernels.py), 2e-5 for flash and 3e-2 in bf16
(tests/test_torch_flash.py): the same arithmetic in another summation
order, and one bf16 rounding of outputs of magnitude up to ~3."""
import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import bgmv as jbgmv  # noqa: E402
from repro.kernels import mbgmv as jmbgmv  # noqa: E402
from repro.kernels.flash import flash_attention as jflash  # noqa: E402
from repro.kernels.paged import paged_attention as jpaged  # noqa: E402
from repro_torch.analysis import kernel_model  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.engine import InferenceServer  # noqa: E402
from repro_torch.core.lora import AdapterSpec  # noqa: E402
from repro_torch.core.timing import Hardware  # noqa: E402
from repro_torch.kernels import bgmv, flash, mbgmv, paged  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
SMS = 132                                # the H100 SXM's SM count


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------ paged attention ----

def _paged_case(seed, B, H, KV, hd, ps, P, W):
    """Row 0 holds nothing, row 1 one token (pos 0), the rest random
    lengths over pages drawn at random, with an unclaimed hole."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(P, KV, ps, hd)).astype(np.float32)
    v = rng.normal(size=(P, KV, ps, hd)).astype(np.float32)
    pp = np.full((P, ps), -1, np.int32)
    bt = np.full((B, W), -1, np.int32)
    pos = np.zeros((B,), np.int32)
    free = list(rng.permutation(P))
    for b in range(1, B):
        used = 1 if b == 1 else int(rng.integers(ps + 1, W * ps + 1))
        for j in range(-(-used // ps)):
            pg = free.pop()
            bt[b, j] = pg
            filled = np.arange(ps) + j * ps
            pp[pg] = np.where(filled < used, filled, -1)
        pos[b] = used - 1
    if B > 2 and bt[2, 1] >= 0:
        bt[2, 0] = -1                    # a hole: those slots drop out
    return q, k, v, pp, bt, pos


@pytest.mark.parametrize("B,H,KV,hd,ps,P,W", [
    (2, 32, 1, 128, 8, 8, 3),            # MQA, group 32 at hd 128
    (2, 71, 1, 64, 8, 8, 3),             # MQA, group 71 at hd 64 (falcon)
    (3, 8, 2, 80, 8, 12, 3),             # hd 80, group 4
    (3, 4, 2, 100, 8, 12, 3),            # hd 100, group 2
    (3, 8, 2, 12, 8, 12, 3),             # hd 12, group 4
], ids=["G 32 hd 128", "G 71 hd 64", "hd 80", "hd 100", "hd 12"])
def test_paged_attention_at_new_shapes_matches_pallas(B, H, KV, hd, ps, P,
                                                      W):
    args = _paged_case(H * hd + B, B, H, KV, hd, ps, P, W)
    want = np.asarray(jpaged(*map(jnp.asarray, args)))
    got = paged.paged_attention(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0].any()              # a row with no claimed page


_OLD_MAX = 256                  # the rule before tiles: G x pow2(hd/8)


def _old_rule(G, hd):
    """The paged kernel's rule before group tiles: one thread per (query
    head, 8 columns of hd rounded up to a power of two) in one block of
    256, hd a multiple of 8 up to 256."""
    if G < 1 or hd < 8 or hd % 8 or hd > 256:
        return False
    lanes = 1
    while lanes < hd // 8:
        lanes *= 2
    return G * lanes <= _OLD_MAX


@pytest.mark.parametrize("hd", [8, 12, 32, 64, 80, 96, 100, 128, 256])
def test_paged_group_tiles_keep_the_old_launch_where_it_fit(hd):
    """Every (G, hd) the old rule took is one group tile (the kernel's
    Gb = G: the one block of G x pow2(hd / 8) x slot groups); a group past
    it is cut into the fewest tiles of at most 256 / pow2(ceil(hd / 8))
    heads, as even as they come, covering each head once."""
    lanes = 1
    while lanes < -(-hd // 8):
        lanes *= 2
    for G in range(1, 161):
        tiles = paged.group_tiles(G, hd)
        if _old_rule(G, hd):
            assert tiles == 1
        cap = paged.MAX_THREADS // lanes
        assert tiles == -(-G // cap)
        per = -(-G // tiles)             # the kernel's Gb
        assert per * lanes <= paged.MAX_THREADS
        heads = [h for t in range(tiles) for h in range(t * per,
                                                        min(G, (t + 1) * per))]
        assert heads == list(range(G))


@pytest.mark.parametrize("B,KV,W,tiles", [(8, 1, 16, 2), (3, 1, 96, 3),
                                          (8, 32, 16, 1), (8, 4, 128, 1),
                                          (64, 1, 64, 3)])
def test_paged_split_plan_counts_group_tiles(B, KV, W, tiles):
    """The split count sees B x KV x tiles blocks: a long MQA row cut into
    group tiles is split as B x (KV x tiles) KV heads would be, and the
    shipped shapes (one tile) keep their split counts."""
    n = paged.split_plan(B, KV, W, SMS, tiles)
    assert n == paged.split_plan(B, KV * tiles, W, SMS, 1)
    assert B * KV * tiles * n <= max(paged.MAX_SPLIT_BLOCKS_PER_SM * SMS,
                                     B * KV * tiles)


# ------------------------------------------------------------- flash ----

@pytest.mark.parametrize("hd,dtype", [(80, "f32"), (80, "bf16"),
                                      (72, "f32"), (100, "f32"),
                                      (100, "bf16"), (160, "f32"),
                                      (200, "f32")])
@pytest.mark.parametrize("causal,window,Lq,Lk", [(True, None, 70, 70),
                                                 (False, 24, 40, 90)])
def test_flash_at_new_head_dims_matches_pallas(hd, dtype, causal, window,
                                               Lq, Lk):
    jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, 2e-5),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}[dtype]
    rng = np.random.default_rng(hd + Lq)
    arrs = [rng.normal(size=(1, h, L, hd)).astype(np.float32)
            for h, L in ((4, Lq), (2, Lk), (2, Lk))]
    want = jflash(*[jnp.asarray(a).astype(jdt) for a in arrs],
                  causal=causal, window=window, bq=64, bk=64)
    got = flash.flash_attention(*[torch.from_numpy(a).to(tdt)
                                  for a in arrs], causal=causal,
                                window=window)
    assert got.dtype == tdt and tuple(got.shape) == (1, 4, Lq, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_padded_widths(dtype):
    """Every hd up to 256 is taken and runs at the narrowest instantiated
    width at or above it; 257 and up is refused."""
    for hd in range(1, 257):
        assert flash.shape_refusal(hd, dtype) is None
        w = flash.padded_width(hd, dtype)
        assert w >= hd and w in flash.HEAD_DIMS[dtype]
        assert not [x for x in flash.HEAD_DIMS[dtype] if hd <= x < w]
    assert flash.padded_width(80, torch.bfloat16) == 96
    assert flash.padded_width(160, torch.bfloat16) == 256
    for hd in (0, 257, 320):
        assert "hd 1 to 256" in flash.shape_refusal(hd, dtype)


# ----------------------------------------------------------------- LoRA ----

def _lora_pool(seed, slots, d_in, d_out, r_max, ranks):
    rng = np.random.default_rng(seed)
    a = np.zeros((slots, d_in, r_max), np.float32)
    b = np.zeros((slots, r_max, d_out), np.float32)
    for s, r in enumerate(ranks):
        a[s, :, :r] = rng.normal(size=(d_in, r)) * d_in ** -0.5
        b[s, :r] = rng.normal(size=(r, d_out)) * r ** -0.5
    return a, b, rng


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
@pytest.mark.parametrize("d_in,d_out", [(4100, 1000), (1000, 4100)])
def test_lora_pair_at_d_in_4100_d_out_1000_matches_pallas(mode, d_in,
                                                          d_out):
    """4,100 is no multiple of 8 (the kernels' tails); 1,000 is, but no
    multiple of the expand's 256-column tiles."""
    ranks = [16, 5, 8, 1]
    a, b, rng = _lora_pool(d_in, 4, d_in, d_out, 16, ranks)
    x = rng.normal(size=(6, d_in)).astype(np.float32)
    idx = np.array([0, 1, 2, 3, -1, 1], np.int32)
    r_np = np.asarray(ranks, np.int32)
    if mode == "bgmv":
        y_want = jbgmv.bgmv_shrink(jnp.asarray(x), jnp.asarray(a),
                                   jnp.asarray(idx))
        y = bgmv.bgmv_shrink(_t(x), _t(a), _t(idx))
        o_want = jbgmv.bgmv_expand(y_want, jnp.asarray(b), jnp.asarray(idx))
        o = bgmv.bgmv_expand(y, _t(b), _t(idx))
    else:
        jr = (jnp.asarray(idx), jnp.asarray(r_np))
        y_want = jmbgmv.mbgmv_shrink(jnp.asarray(x), jnp.asarray(a), *jr,
                                     rank_block=4)
        y = mbgmv.mbgmv_shrink(_t(x), _t(a), _t(idx), _t(r_np),
                               rank_block=4)
        o_want = jmbgmv.mbgmv_expand(y_want, jnp.asarray(b), *jr,
                                     rank_block=4)
        o = mbgmv.mbgmv_expand(y, _t(b), _t(idx), _t(r_np), rank_block=4)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want), **TOL)
    assert not o.numpy()[4].any()


def test_lora_rules_take_any_width():
    """The shrink and the expand refuse only an r_max the pool never
    passes (no multiple of 8, or above MAX_R); every width is taken."""
    for d in (1, 7, 130, 1000, 4100, 12289):
        assert bgmv.shrink_refusal(d, 64) is None
        assert bgmv.expand_refusal(64, d) is None
    assert bgmv.shrink_refusal(4100, 12) and bgmv.expand_refusal(12, 1000)
    assert bgmv.shrink_refusal(64, bgmv.MAX_R + 8)


def test_shape_cases_are_taken_on_every_path():
    """kernel_model's shape cases (the card's phase S footprints take them
    too): the MQA case's paged launch on the group kernel in bf16 and in
    group tiles in f32, the hd-80 case's flash at width 96, the LoRA tails
    on all four paths."""
    labels = [x.label for c in kernel_model.shape_cases()
              for x in kernel_model.launches(c)]
    refused = [x.label for c in kernel_model.shape_cases()
               for x in kernel_model.launches(c) if x.refusal]
    assert refused == []
    assert any("G 32 hd 128 in 2 group tiles" in x for x in labels)
    assert any("G 32 hd 128 on the group kernel" in x for x in labels)
    assert any("hd 80 at 96" in x for x in labels)
    for path in ("lora_shrink[decode tail]", "lora_shrink[tile 64 tail]",
                 "lora_expand[decode tail]", "lora_expand[row tiles tail]"):
        assert any(path in x for x in labels), path


# ------------------------------------------------ serving, on the CPU ----

@pytest.fixture(scope="module")
def ref():
    mods = {"base": "repro.configs.base", "engine": "repro.core.engine",
            "lora": "repro.core.lora", "timing": "repro.core.timing",
            "request": "repro.serving.request"}
    return SimpleNamespace(**{k: importlib.import_module(v)
                              for k, v in mods.items()})


def _trace(seed=7, n=6):
    rng = np.random.default_rng(seed)
    return [(i, f"ad{i % 4}",
             rng.integers(0, 512, int(rng.integers(4, 16))).astype(np.int32),
             int(rng.integers(3, 14)), float(i * 3)) for i in range(n)]


@pytest.mark.parametrize("kernel", ["bgmv", "mbgmv"])
@pytest.mark.parametrize("mutation", [{"n_kv_heads": 1}, {"head_dim": 40}],
                         ids=["MQA", "hd 40"])
def test_mutated_smoke_serves_the_references_tokens(ref, mutation, kernel):
    """llama2-7b-smoke with one KV head (group 4) or hd 40 (no multiple of
    16): with the reference's weights carried over, every request's
    greedy tokens equal the reference's, in f32."""
    cj = dataclasses.replace(ref.base.get_config("llama2-7b").smoke(),
                             **mutation)
    ct = dataclasses.replace(get_config("llama2-7b").smoke(), **mutation)
    kw = {"mode": "caraserve", "kernel": kernel, "max_batch": 4,
          "cache_slots": 64, "seed": 0}
    js = ref.engine.InferenceServer(cj, **kw)
    hw = Hardware(**dataclasses.asdict(ref.timing.V5E))
    ts = InferenceServer(ct, device="cpu", hw=hw, params=params_from_jax(
        ct, jax.tree.map(np.asarray, js.params), device="cpu"), **kw)
    for i, r in enumerate((8, 3, 5, 1)):
        js.register_adapter(ref.lora.AdapterSpec(f"ad{i}", r, cj.name))
        ts.register_adapter(AdapterSpec(f"ad{i}", r, ct.name))
    trace = _trace()
    js.run([ref.request.Request(*t) for t in trace])
    ts.run([Request(*t) for t in trace])
    assert {s.req.rid: s.generated for s in ts.states} == \
        {s.req.rid: s.generated for s in js.states}
    assert all(s.generated for s in ts.states)
