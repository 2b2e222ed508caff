"""The port's CUDA kernels on the card, held against their plain PyTorch
versions; and the port's server on the card against the same server on
the CPU. Every test is marked `cuda` and skips where no card is present
(CUDA kernels have no CPU mode). This file imports no JAX, so it runs on
the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

f32 throughout, atol = rtol = 1e-5: the same arithmetic in another
summation order (TF32 is switched off for the plain versions' matmuls).
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.cluster import Cluster  # noqa: E402
from repro_torch.core.engine import InferenceServer  # noqa: E402
from repro_torch.core.faults import FaultEvent, FaultPlane  # noqa: E402
from repro_torch.core.perf_model import ServerPerfModel  # noqa: E402
from repro_torch.core.scheduler import make_scheduler  # noqa: E402
from repro_torch.core.lora import AdapterSpec  # noqa: E402
from repro_torch.kernels import bgmv, flash, ops, paged, ref  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (CUDA kernels have no "
                    "CPU mode)")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _paged_args(seed, B=4, H=8, KV=2, hd=32, ps=8, P=24, W=5):
    """Random claimed layout plus an all-unclaimed row 0, a pos=0 row 1 and
    a claimed-but-empty page on the last row."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(P, KV, ps, hd)).astype(np.float32)
    v = rng.normal(size=(P, KV, ps, hd)).astype(np.float32)
    pp = np.full((P, ps), -1, np.int32)
    bt = np.full((B, W), -1, np.int32)
    pos = np.zeros((B,), np.int32)
    free = list(range(P))
    for b in range(1, B):
        n = int(rng.integers(1, W))
        used = 1 if b == 1 else int(rng.integers(1, n * ps + 1))
        pos[b] = used - 1
        for j in range(n):
            pg = free.pop()
            bt[b, j] = pg
            filled = np.arange(ps) + j * ps
            pp[pg] = np.where(filled < used, filled, -1)
    nl = int((bt[B - 1] >= 0).sum())
    bt[B - 1, nl] = free.pop()
    return [torch.from_numpy(a) for a in (q, k, v, pp, bt, pos)]


def test_paged_attention_kernel_matches_plain(card):
    args = [a.to(card) for a in _paged_args(3)]
    n = paged.paged_attention.launches
    got = paged.paged_attention(*args)
    want = ref.paged_attention_ref(*args)
    torch.cuda.synchronize()
    assert paged.paged_attention.launches == n + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert bool((got[0] == 0).all())


def test_paged_attention_kernel_never_reads_foreign_pages(card):
    q, k, v, pp, bt, pos = [a.to(card) for a in _paged_args(4)]
    base = paged.paged_attention(q, k, v, pp, bt, pos)
    for b in range(q.shape[0]):
        keep = torch.zeros(k.shape[0], dtype=torch.bool, device=card)
        keep[bt[b][bt[b] >= 0].long()] = True
        kk = torch.where(keep[:, None, None, None], k, float("nan"))
        vv = torch.where(keep[:, None, None, None], v, float("nan"))
        out = paged.paged_attention(q, kk, vv, torch.where(keep[:, None],
                                                          pp, 0), bt, pos)
        assert torch.equal(out[b], base[b]), b


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
def test_lora_kernels_match_plain(card, mode):
    ranks = [16, 5, 8, 1]
    rng = np.random.default_rng(2)
    a = np.zeros((4, 128, 16), np.float32)
    b = np.zeros((4, 16, 256), np.float32)
    for s, r in enumerate(ranks):
        a[s, :, :r] = rng.normal(size=(128, r)) * 128 ** -0.5
        b[s, :r] = rng.normal(size=(r, 256)) * r ** -0.5
    x = rng.normal(size=(6, 128)).astype(np.float32)
    idx = np.array([0, 1, 2, 3, -1, 1], np.int32)
    cpu = [torch.from_numpy(t) for t in (x, a, b, idx)]
    r_cpu = torch.tensor(ranks, dtype=torch.int32)
    want = ops.lora_delta(*cpu, ranks=r_cpu, mode=mode, rank_block=8)
    n = (bgmv.lora_shrink.launches, bgmv.lora_expand.launches)
    got = ops.lora_delta(*(t.to(card) for t in cpu), ranks=r_cpu.to(card),
                         mode=mode, rank_block=8)
    assert (bgmv.lora_shrink.launches, bgmv.lora_expand.launches) == \
        (n[0] + 1, n[1] + 1)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    assert bool((got[4] == 0).all())


@pytest.mark.parametrize("causal,window,group,Lq,Lk,hd", [
    (True, None, 1, 130, 130, 32), (True, 48, 2, 257, 257, 64),
    (False, None, 4, 96, 160, 16), (False, 48, 8, 160, 96, 128),
    (True, None, 1, 150, 150, 96), (True, 40, 5, 170, 170, 256),
    (False, None, 1, 64, 150, 256)])
def test_flash_kernel_matches_plain(card, causal, window, group, Lq, Lk, hd):
    """f32 (the CUDA-core path): ragged lengths, Lq != Lk, GQA groups 1 to
    8, causal or not, with and without a window."""
    rng = np.random.default_rng(Lq + hd)
    KV = 2
    q = rng.normal(size=(2, KV * group, Lq, hd)).astype(np.float32)
    k = rng.normal(size=(2, KV, Lk, hd)).astype(np.float32)
    v = rng.normal(size=(2, KV, Lk, hd)).astype(np.float32)
    args = [torch.from_numpy(a).to(card) for a in (q, k, v)]
    n = flash.flash_attention.launches
    got = flash.flash_attention(*args, causal=causal, window=window)
    want = ref.flash_attention_ref(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash.flash_attention.launches == n + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


def test_flash_kernel_bf16_strided_matches_plain(card):
    """bf16 (the tensor-core path) on (B, H, L, hd) views of (B, L, H, hd)
    tensors, as the model passes them: each query row within 1e-2 of its
    largest plain value (one bf16 rounding of the output, and P rounded to
    bf16 for the PV product)."""
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(2, 300, 8, 128, generator=g, device=card).bfloat16()
    k = torch.randn(2, 300, 2, 128, generator=g, device=card).bfloat16()
    v = torch.randn(2, 300, 2, 128, generator=g, device=card).bfloat16()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    got = flash.flash_attention(qt, kt, vt)
    want = ref.flash_attention_ref(qt, kt, vt)
    assert got.transpose(1, 2).is_contiguous()
    err = (got.float() - want.float()).abs().amax(-1)
    assert bool((err <= 1e-2 * want.float().abs().amax(-1)).all())


def _serve(device, params=None, arch="llama2-7b", kv="", seed=0, **kw):
    cfg = dataclasses.replace(get_config(arch).smoke(), kv_cache_dtype=kv)
    srv = InferenceServer(cfg, mode="caraserve", max_batch=4,
                          cache_slots=64, seed=seed, device=device,
                          params=params, **kw)
    for i, r in enumerate((8, 4, 2, 8)):
        srv.register_adapter(AdapterSpec(f"ad{i}", r, cfg.name))
    rng = np.random.default_rng(1)
    srv.run([Request(i, f"ad{i % 4}",
                     rng.integers(0, cfg.vocab, int(rng.integers(4, 30))
                                  ).astype(np.int32),
                     int(rng.integers(3, 20)), float(3 * i))
             for i in range(8)])
    return srv


def test_server_on_card_matches_server_on_cpu(card):
    """llama2-7b-smoke (f32): the same weights and trace through the CUDA
    kernels and through the plain versions give the same tokens."""
    cpu = _serve("cpu")
    params = copy.deepcopy(cpu.params).to(card)
    n = paged.paged_attention.launches
    gpu = _serve("cuda", params=params)
    assert paged.paged_attention.launches > n
    assert {s.req.rid: s.generated for s in gpu.states} == \
        {s.req.rid: s.generated for s in cpu.states}


@pytest.mark.parametrize("chunk_budget", [0, 16])
def test_yi9b_server_on_card_matches_server_on_cpu(card, chunk_budget):
    """yi-9b-smoke (f32, GQA group 2), monolithic and chunked prefill: the
    flash, paged and LoRA kernels give the CPU server's tokens."""
    kw = dict(arch="yi-9b", page_size=16, chunk_budget=chunk_budget)
    cpu = _serve("cpu", **kw)
    params = copy.deepcopy(cpu.params).to(card)
    n = flash.flash_attention.launches
    gpu = _serve("cuda", params=params, **kw)
    assert flash.flash_attention.launches > n
    assert (gpu.backend.transfer_stats["prefill_chunks"] > 0) == \
        bool(chunk_budget)
    assert {s.req.rid: s.generated for s in gpu.states} == \
        {s.req.rid: s.generated for s in cpu.states}


@pytest.mark.parametrize("kv", ["", "int8"])
def test_dense_server_on_card_matches_server_on_cpu(card, kv):
    """The dense plane (f32 and int8 KV): the LoRA and flash kernels on the
    card, dense decode attention in plain PyTorch on both, give the CPU
    server's tokens; paged attention never launches."""
    cpu = _serve("cpu", memory="dense", kv=kv)
    params = copy.deepcopy(cpu.params).to(card)
    before = {f: f.launches for f in (paged.paged_attention,
                                      bgmv.lora_shrink,
                                      flash.flash_attention)}
    gpu = _serve("cuda", params=params, memory="dense", kv=kv)
    assert gpu.memory == "dense"
    moved = {f.__name__: f.launches - n for f, n in before.items()}
    assert moved["paged_attention"] == 0, moved
    assert moved["lora_shrink"] > 0 and moved["flash_attention"] > 0, moved
    assert {s.req.rid: s.generated for s in gpu.states} == \
        {s.req.rid: s.generated for s in cpu.states}


@pytest.mark.parametrize("memory", ["paged", "dense"])
def test_temperature_streams_on_card_repeat_under_one_seed(card, memory):
    """T = 0.8 on the card: the same seed gives the same streams (the
    generator's draws and every kernel repeat bitwise); another seed
    gives others."""
    cfg = get_config("llama2-7b").smoke()
    kw = dict(memory=memory, temperature=0.8)
    a = _serve("cuda", **kw)
    params = a.params
    b = _serve("cuda", params=params, **kw)
    c = _serve("cuda", params=params, seed=1, **kw)
    toks = [{s.req.rid: s.generated for s in x.states} for x in (a, b, c)]
    assert toks[0] == toks[1]
    assert toks[0] != toks[2]
    assert all(0 <= t < cfg.vocab for st in a.states for t in st.generated)


@pytest.mark.parametrize("memory", ["paged", "dense"])
def test_graphed_step_on_card_matches_eager(card, memory):
    """The fused pipeline's decode and megastep[K=k] CUDA graphs: the
    replayed steps give the eager steps' tokens, every key is captured
    once and replayed, and the launch counters move by exactly what the
    eager run launches (each replay adds its capture's count)."""
    counters = (paged.paged_attention, bgmv.lora_shrink, bgmv.lora_expand,
                flash.flash_attention)
    runs, params = [], None
    for graphs in (False, True):
        before = [f.launches for f in counters]
        srv = _serve("cuda", params=params, memory=memory, graphs=graphs)
        params = srv.params
        runs.append(([f.launches - n for f, n in zip(counters, before)],
                     {s.req.rid: s.generated for s in srv.states},
                     srv.backend.graphs.stats()))
    (l_eager, t_eager, s_eager), (l_graph, t_graph, s_graph) = runs
    assert t_graph == t_eager
    assert l_graph == l_eager
    assert any(k.startswith("megastep[K=") for k in s_graph)
    for s in s_graph.values():
        assert s["builds"] == 1 and s["captures"] <= 1
        assert s["replays"] >= s["captures"]
    assert sum(s["replays"] for s in s_graph.values()) > 0
    assert all(s["captures"] == s["replays"] == 0
               for s in s_eager.values())


@pytest.mark.parametrize("memory,chunk_budget", [("paged", 0),
                                                  ("paged", 16),
                                                  ("dense", 0)])
def test_graphed_prefill_and_chunks_on_card_match_eager(card, memory,
                                                        chunk_budget):
    """The prefill[Nb,Lp] and prefill_chunk[_final][C] CUDA graphs: a
    trace served twice on one server (every bucket and chunk width comes
    again) gives the eager server's tokens and launch counts, and every
    such key is built once and replayed."""
    cfg = get_config("llama2-7b").smoke()
    counters = (paged.paged_attention, bgmv.lora_shrink, bgmv.lora_expand,
                flash.flash_attention)
    rng = np.random.default_rng(2)
    trace = [(i, f"ad{i % 4}",
              rng.integers(0, cfg.vocab, int(rng.integers(4, 40))
                           ).astype(np.int32),
              int(rng.integers(3, 12)), float(3 * i)) for i in range(8)]
    runs, params = [], None
    for graphs in (False, True):
        srv = InferenceServer(cfg, mode="caraserve", max_batch=4,
                              cache_slots=64, seed=0, device="cuda",
                              params=params, memory=memory, graphs=graphs,
                              chunk_budget=chunk_budget)
        params = srv.params
        for i, r in enumerate((8, 4, 2, 8)):
            srv.register_adapter(AdapterSpec(f"ad{i}", r, cfg.name))
        before = [f.launches for f in counters]
        for rep in range(2):
            srv.run([Request(1000 * rep + t[0], *t[1:4],
                             srv.clock + t[4]) for t in trace])
        runs.append(([f.launches - n for f, n in zip(counters, before)],
                     {s.req.rid: s.generated for s in srv.states},
                     srv.backend.graphs.stats()))
    (l_eager, t_eager, _), (l_graph, t_graph, s_graph) = runs
    assert t_graph == t_eager
    assert l_graph == l_eager
    kinds = ("prefill_chunk[", "prefill_chunk_final[") if chunk_budget \
        else ("prefill[",)
    for kind in kinds:
        keys = {k: g for k, g in s_graph.items() if k.startswith(kind)}
        assert keys and all(g["builds"] == 1 for g in keys.values())
        assert any(g["replays"] for g in keys.values()), keys


@pytest.mark.parametrize("lora_rank", [8, 0])
def test_graphed_training_step_on_card_matches_eager(card, lora_rank):
    """`Trainer.step` as a CUDA graph (key `train`: captured on its second
    call, then replayed) against the same trainer with graphs=False, from
    the same init on the same batches: the metrics and every trained
    leaf after four steps agree."""
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.weights import init_params
    from repro_torch.training import tree as ttree
    cfg = get_config("llama2-7b").smoke()
    out = []
    for graphs in (True, False):
        trainer = tlaunch.Trainer(cfg, lora_rank=lora_rank, steps=4,
                                  device="cuda", graphs=graphs, accum=2,
                                  params=init_params(cfg, 0, "cuda"))
        data = trainer.batches(4, 32)
        ms = [trainer.step(next(data)) for _ in range(4)]
        out.append(([float(m["loss"]) for m in ms],
                    [t.detach().clone() for t in ttree.leaves(
                        trainer.trained())], trainer.graphs.stats()))
    (lg, tg, sg), (le, te, se) = out
    assert lg == pytest.approx(le, rel=1e-5)
    for a, b in zip(tg, te):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert (sg["train"]["builds"], sg["train"]["captures"],
            sg["train"]["replays"]) == (1, 1, 3)
    assert se["train"]["captures"] == se["train"]["replays"] == 0


def _smoke_cluster(device, params=None, crash=None):
    """Two llama2-7b-smoke servers (f32) over one weight set behind the
    rank-aware router; `crash` = (crash, restart) times of server 1."""
    cfg = get_config("llama2-7b").smoke()
    servers = []
    for _ in range(2):
        srv = InferenceServer(cfg, mode="caraserve", max_batch=4,
                              cache_slots=64, seed=0, device=device,
                              params=params)
        params = srv.params
        for i, r in enumerate((8, 4, 2, 8)):
            srv.register_adapter(AdapterSpec(f"ad{i}", r, cfg.name))
        servers.append(srv)
    perf = ServerPerfModel(get_config("llama2-7b"), kernel="bgmv")
    plane = FaultPlane([FaultEvent(crash[0], "crash", 1),
                        FaultEvent(crash[1], "restart", 1)]) \
        if crash else None
    cl = Cluster(servers, make_scheduler(
        "rank_aware", perf, slo_ms=1.5 * perf.dec_perf([64] * 4)),
        faults=plane)
    rng = np.random.default_rng(5)
    out, states = cl.run([Request(i, f"ad{i % 4}", rng.integers(
        0, cfg.vocab, 10 + 3 * i).astype(np.int32), 10, 4.0 * i)
        for i in range(6)])
    return cl, out, {s.req.rid: s.generated for s in states}


def test_cluster_crash_on_card_matches_cluster_on_cpu(card):
    """The cluster plane with numerics on the card: two servers sharing
    one weight set, server 1 crashed while its first request decodes and
    restarted; the recompute failover re-prefills through the flash kernel
    and decodes through the paged and LoRA kernels, and every request's
    tokens equal the CPU cluster's and the unfailed run's (f32)."""
    cl, _, want = _smoke_cluster("cpu")
    first = min(cl.servers[1].states, key=lambda st: st.first_token_ms)
    mid = 0.5 * (first.first_token_ms + first.finish_ms)
    crash = (mid, mid + first.finish_ms - first.first_token_ms)
    params = copy.deepcopy(cl.servers[0].params)
    _, cpu_out, cpu = _smoke_cluster("cpu", params, crash)
    n = flash.flash_attention.launches
    gpu_cl, gpu_out, gpu = _smoke_cluster("cuda", params.to(card), crash)
    assert flash.flash_attention.launches > n
    assert gpu_cl.fault_stats["crashes"] == 1
    assert gpu_out["recovered"] == cpu_out["recovered"] > 0
    assert gpu == cpu == want


def _rows_close(got, want, tol, floor):
    """Each output row within tol x max(floor, that row's max |plain|)."""
    err = (got.float() - want.float()).abs().flatten(1).amax(1)
    scale = want.float().abs().flatten(1).amax(1).clamp(min=floor)
    assert bool((err <= tol * scale).all()), float((err / scale).max())


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
@pytest.mark.parametrize("rows,seg,d_in", [
    (8, 0, 1024), (64, 0, 4096), (65, 1, 512), (300, 17, 512),
    (2048, 32, 1024), (4096 + 5, 32, 1024),
    (8269, 4096, 256), (16896 + 77, 4096, 64)])
def test_lora_shrink_paths_match_plain(card, mode, rows, seg, d_in):
    """bf16 shrink on both launch shapes: decode (<= 64 rows: blocks by
    slot, a cluster over d) and the persistent row tiles of 64 rows, at
    random slots (seg 0) and at prefill's runs
    of `seg` rows per slot (boundaries inside tiles, whole tiles of idx -1
    rows, a ragged last tile; runs of 32: every tile of two slots, a pass
    each), ranks 8/16/32/64. f32 output: each row
    within 1e-5 x max(1, its max |plain|), dead columns exactly 0, and a
    second run bitwise equal (no atomics)."""
    g = torch.Generator(device=card).manual_seed(rows + d_in)
    ranks = [8, 16, 32, 64] * 2
    a = torch.zeros(8, d_in, 64, device=card, dtype=torch.bfloat16)
    for s, r in enumerate(ranks):
        a[s, :, :r] = (torch.randn(d_in, r, generator=g, device=card)
                       * d_in ** -0.5).bfloat16()
    x = torch.randn(rows, d_in, generator=g, device=card).bfloat16()
    if seg:
        idx = torch.arange(rows, device=card) // seg % 9 - 1
    else:
        idx = torch.randint(-1, 8, (rows,), generator=g, device=card)
    idx = idx.to(torch.int32)
    live = ref.bgmv_live(idx, 64) if mode == "bgmv" else ref.mbgmv_live(
        idx, torch.tensor(ranks, dtype=torch.int32, device=card), 16)
    n = bgmv.lora_shrink.launches
    y = bgmv.lora_shrink(x, a, idx, live)
    assert bgmv.lora_shrink.launches == n + 1
    _rows_close(y, ref.lora_shrink_ref(x, a, idx, live), 1e-5, 1.0)
    dead = torch.arange(64, device=card)[None] >= live[:, None]
    assert bool((y[dead] == 0).all())
    assert torch.equal(y, bgmv.lora_shrink(x, a, idx, live))


def _shrink_case(card, rows, d_in, r_max, ranks, seg):
    """x, the A pool (zero past each slot's rank) and idx: runs of `seg`
    rows a slot cycling through the slots (seg >= rows: every row at the
    last slot)."""
    g = torch.Generator(device=card).manual_seed(rows + d_in + r_max)
    a = torch.zeros(len(ranks), d_in, r_max, device=card,
                    dtype=torch.bfloat16)
    for s, r in enumerate(ranks):
        a[s, :, :r] = (torch.randn(d_in, r, generator=g, device=card)
                       * d_in ** -0.5).bfloat16()
    x = torch.randn(rows, d_in, generator=g, device=card).bfloat16()
    idx = (torch.arange(rows, device=card) // seg % len(ranks)).to(
        torch.int32)
    return x, a, idx


@pytest.mark.parametrize("rows,d_in,r_max,ranks,seg", [
    (4096, 4096, 64, [64], 4096), (32768, 4096, 64, [64] * 8, 4096),
    (2048 + 37, 2048, 64, [8, 16, 32, 64] * 2, 32),
    (4096, 4096, 128, [128], 4096), (1100, 12288, 64, [64, 16] * 2, 17),
    (4133, 1024, 200, [200, 8, 100], 300)])
def test_lora_shrink_wgmma_every_split_matches_plain(card, rows, d_in, r_max,
                                                     ranks, seg):
    """The persistent wgmma shrink launched directly at every split (1, 2,
    4, 8 d slices a cluster) with the clusters the card holds at once, a
    quarter of them and one: the training and prefill shapes, runs of 32
    over 8 slots (tiles of two slots, one pass for the pair), r_max 128
    (column passes), runs of 17 over slots of ranks 64 and 16 at d_in
    12,288 (tiles of up to five slots), a partial tile at r_max 200 over
    ranks 200 / 8 / 100 (column passes past one slot of a pair, which
    then go one at a time); each row within 1e-5 x max(1, its max
    |plain|), dead columns exactly 0."""
    from repro_torch.kernels import build
    lib = build.library()
    x, a, idx = _shrink_case(card, rows, d_in, r_max, ranks, seg)
    for mode in ("bgmv", "mbgmv"):
        live = ops.lora_live(idx, torch.tensor(ranks, dtype=torch.int32,
                                               device=card), mode, r_max, 16)
        want = ref.lora_shrink_ref(x, a, idx, live)
        room = bgmv.cluster_room(card)
        tiles = -(-rows // bgmv.SHRINK_ROWS)
        for split in (1, 2, 4, 8):
            if split > 1 and d_in < 2 * split * bgmv.MIN_SLICE_D:
                continue
            d_chunk = -(-(-(-d_in // split)) // 64) * 64
            most = min(room[split], tiles)
            for clusters in sorted({most, max(1, most // 4), 1}):
                y = torch.full((rows, r_max), float("nan"), device=card)
                rc = lib.rt_lora_shrink(
                    x.data_ptr(), a.data_ptr(), idx.data_ptr(),
                    live.data_ptr(), y.data_ptr(), rows, d_in, r_max,
                    len(ranks), bgmv.SHRINK_ROWS, d_chunk, split,
                    clusters * split, build.DTYPE_CODE[torch.bfloat16],
                    build.stream_handle(card))
                assert rc == 0, (split, clusters, rc)
                torch.cuda.synchronize()
                _rows_close(y, want, 1e-5, 1.0)
                dead = torch.arange(r_max, device=card)[None] >= \
                    live[:, None]
                assert bool((y[dead] == 0).all()), (split, clusters)


@pytest.mark.parametrize("rows,slots", [(4096, 1), (32768, 8)])
def test_lora_shrink_wgmma_repeats_bitwise_and_in_a_graph(card, rows,
                                                          slots):
    """The persistent shrink at the training shape (4,096 rows of one
    slot) and the yi-9b prefill's (32,768 rows, 8 slots in runs of
    4,096), d_in 4,096, r_max 64: two launches on the same inputs give
    the same bits (a fixed order of sums, no atomics), and a CUDA graph of
    it replayed twice gives the eager launch's bits (its plan needs no
    device sync)."""
    import gc
    x, a, idx = _shrink_case(card, rows, 4096, 64, [64] * slots, 4096)
    live = ref.bgmv_live(idx, 64)
    eager = bgmv.lora_shrink(x, a, idx, live)
    assert torch.equal(eager, bgmv.lora_shrink(x, a, idx, live))
    _rows_close(eager, ref.lora_shrink_ref(x, a, idx, live), 1e-5, 1.0)
    out = torch.empty_like(eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out.copy_(bgmv.lora_shrink(x, a, idx, live))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            out.copy_(bgmv.lora_shrink(x, a, idx, live))
    finally:
        gc.enable()
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_lora_shrink_wgmma_refusals_raise(card):
    """The persistent launch is never given up for another: the entry
    point refuses it a tile other than 64 rows, a grid that is no whole
    number of clusters and a split whose slices miss part of d_in."""
    from repro_torch.kernels import build
    lib = build.library()
    x, a, idx = _shrink_case(card, 300, 1024, 64, [64], 300)
    live = ref.bgmv_live(idx, 64)
    y = torch.empty(300, 64, device=card)
    bf = build.DTYPE_CODE[torch.bfloat16]
    for tile, d_chunk, split, grid in ((128, 512, 2, 8), (64, 512, 2, 7),
                                       (64, 512, 2, 1), (64, 256, 2, 8)):
        assert lib.rt_lora_shrink(
            x.data_ptr(), a.data_ptr(), idx.data_ptr(), live.data_ptr(),
            y.data_ptr(), 300, 1024, 64, 1, tile, d_chunk, split, grid, bf,
            build.stream_handle(card)) != 0, (tile, d_chunk, split, grid)


@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("causal,window,group,Lq,Lk", [
    (True, None, 1, 200, 333), (True, 64, 4, 515, 515),
    (False, None, 8, 300, 190), (False, 100, 4, 777, 777),
    (True, 100, 10, 400, 400)])
def test_flash_kernel_bf16_head_dims(card, hd, causal, window, group, Lq,
                                     Lk):
    """The wgmma kernel at every bf16 head dim (96: 32-column boxes; 256:
    64-key tiles in 2 stages), on (B, H, L, hd) views of (B, L, H, hd)
    tensors: lengths no multiple of its key tile, Lq != Lk, windows,
    causal=False, GQA groups 1/4/8/10; each query row within 1e-2 of its
    largest plain value."""
    g = torch.Generator(device=card).manual_seed(Lq + hd)
    KV = 2
    q = torch.randn(2, Lq, KV * group, hd, generator=g, device=card)
    k = torch.randn(2, Lk, KV, hd, generator=g, device=card)
    v = torch.randn(2, Lk, KV, hd, generator=g, device=card)
    qt, kt, vt = (t.bfloat16().transpose(1, 2) for t in (q, k, v))
    n = flash.flash_attention.launches
    got = flash.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert flash.flash_attention.launches == n + 1
    want = ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    _rows_close(got.reshape(-1, hd), want.reshape(-1, hd), 1e-2, 0.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [320, 264])
def test_flash_kernel_raises_for_other_head_dims(card, dtype, hd):
    """A head dim past 256 (any other runs at an instantiated width)
    raises on the card (no plain fallback), and nothing launches."""
    q = torch.zeros(1, 2, 8, hd, device=card, dtype=dtype)
    n = flash.flash_attention.launches
    with pytest.raises(ValueError, match="the kernel takes hd 1 to 256"):
        flash.flash_attention(q, q, q)
    assert flash.flash_attention.launches == n


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
@pytest.mark.parametrize("rows,seg,d_out,dtype", [
    (1, 0, 4096, torch.bfloat16), (8, 0, 4096, torch.bfloat16),
    (64, 0, 512, torch.bfloat16), (65, 1, 512, torch.bfloat16),
    (300, 17, 384, torch.bfloat16), (4096 + 37, 4096, 4096, torch.bfloat16),
    (16896 + 77, 64, 512, torch.bfloat16), (8, 0, 136, torch.float32),
    (300, 17, 136, torch.float32)])
def test_lora_expand_paths_match_plain(card, mode, rows, seg, d_out,
                                       dtype):
    """The expand on both launch shapes: decode (<= 64 rows: a block per
    (row, 256 columns)) and row tiles of 64 / 128 rows on the
    tensor cores (bf16) or CUDA cores (f32), at random
    slots (seg 0) and at prefill's runs of `seg` rows per slot (boundaries
    inside tiles, whole tiles of idx -1 rows, ragged last tiles and column
    tiles), live widths 16/32/64. Each row within 1e-2 (bf16) / 1e-5 (f32)
    of its max |plain|, idx -1 rows exactly 0, a second run bitwise
    equal."""
    g = torch.Generator(device=card).manual_seed(rows + d_out)
    ranks = [16, 32, 64, 16, 32, 64, 64, 16]
    b = torch.zeros(8, 64, d_out, device=card, dtype=dtype)
    for s, r in enumerate(ranks):
        b[s, :r] = (torch.randn(r, d_out, generator=g, device=card)
                    * r ** -0.5).to(dtype)
    y = torch.randn(rows, 64, generator=g, device=card).to(dtype)
    if seg:
        idx = torch.arange(rows, device=card) // seg % 9 - 1
    else:
        idx = torch.randint(-1, 8, (rows,), generator=g, device=card)
    idx = idx.to(torch.int32)
    live = ref.bgmv_live(idx, 64) if mode == "bgmv" else ref.mbgmv_live(
        idx, torch.tensor(ranks, dtype=torch.int32, device=card), 16)
    n = bgmv.lora_expand.launches
    out = bgmv.lora_expand(y, b, idx, live)
    assert bgmv.lora_expand.launches == n + 1
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    _rows_close(out, ref.lora_expand_ref(y, b, idx, live), tol,
                0.0 if dtype == torch.bfloat16 else 1.0)
    assert bool((out[idx < 0] == 0).all())
    assert torch.equal(out, bgmv.lora_expand(y, b, idx, live))


def _decode_case(card, rows, d, dtype, pattern="round"):
    """kernel_ab.py's decode LoRA inputs (`lora_case`): 8 slots of ranks
    8/16/32/64 (two each, zero past each rank), row r at slot r % 8 (rows
    share slots past 8; "idle first": row 0 without an adapter too) or
    slots drawn with weights 1 / (s + 1) ("zipf"), the last row of a
    batch of more than one without an adapter."""
    g = torch.Generator(device=card).manual_seed(rows + d)
    ranks = [8, 16, 32, 64] * 2
    a = torch.zeros(8, d, 64, device=card)
    b = torch.zeros(8, 64, d, device=card)
    for s, r in enumerate(ranks):
        a[s, :, :r] = torch.randn(d, r, generator=g, device=card) * d ** -.5
        b[s, :r] = torch.randn(r, d, generator=g, device=card) * r ** -.5
    x = torch.randn(rows, d, generator=g, device=card)
    if pattern == "zipf":
        w = 1.0 / torch.arange(1, 9, device=card, dtype=torch.float32)
        idx = torch.multinomial(w, rows, replacement=True,
                                generator=g).to(torch.int32)
    else:
        idx = (torch.arange(rows, device=card) % 8).to(torch.int32)
        if pattern == "idle first":
            idx[0] = -1
    if rows > 1:
        idx[-1] = -1
    return (x.to(dtype), a.to(dtype), b.to(dtype), idx,
            torch.tensor(ranks, dtype=torch.int32, device=card))


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
@pytest.mark.parametrize("d", [4096, 4100])
@pytest.mark.parametrize("rows", [1, 8, 32, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pattern", ["round", "idle first", "zipf"])
def test_decode_lora_pair_matches_plain_and_repeats(card, pattern, dtype,
                                                    rows, d, mode):
    """The decode shrink and expand at kernel_ab.py's A/B shapes (1 to 64
    rows, d 4,096 and the 4,100 tail, BGMV and MBGMV live widths; its
    three batches: slots in turn, row 0 idle as well, skewed slots): the
    shrink within 1e-5 x max(1, a row's max |plain|), the expand within
    1e-2 (bf16) / 1e-5 (f32) of a row's max |plain|, idx -1 rows exactly
    0; the expand of the shrink's f32 y (rounded as it is loaded) bitwise
    equal to the expand of y cast to the pool's dtype; two runs and a CUDA
    graph replay of the pair bitwise equal (no atomics)."""
    x, a, b, idx, ranks = _decode_case(card, rows, d, dtype, pattern)
    live = ops.lora_live(idx, ranks, mode, 64, 16)
    n = (bgmv.lora_shrink.launches, bgmv.lora_expand.launches)
    y = bgmv.lora_shrink(x, a, idx, live)
    _rows_close(y, ref.lora_shrink_ref(x, a, idx, live), 1e-5, 1.0)
    yd = y.to(dtype)
    out = bgmv.lora_expand(yd, b, idx, live)
    out32 = bgmv.lora_expand(y, b, idx, live)
    assert (bgmv.lora_shrink.launches, bgmv.lora_expand.launches) == \
        (n[0] + 1, n[1] + 2)
    bf = dtype == torch.bfloat16
    _rows_close(out, ref.lora_expand_ref(yd, b, idx, live),
                1e-2 if bf else 1e-5, 0.0 if bf else 1.0)
    assert bool((out[idx < 0] == 0).all())
    assert torch.equal(out32, out)
    assert torch.equal(y, bgmv.lora_shrink(x, a, idx, live))
    assert torch.equal(out32, bgmv.lora_expand(y, b, idx, live))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        gy = bgmv.lora_shrink(x, a, idx, live)
        go = bgmv.lora_expand(gy, b, idx, live)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(gy, y) and torch.equal(go, out32)


def test_decode_pair_graph_holds_a_programmatic_edge(card):
    """`ops.lora_delta` at 8 rows captured in a CUDA graph: two kernel
    nodes (the decode expand rounds the f32 y itself: no cast between
    them), the expand joined to the shrink by a programmatic edge (it is
    launched with programmatic dependent launch and the shrink lets it
    start), and a replay equal to the eager pair bitwise."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.library()
    x, a, b, idx, ranks = _decode_case(card, 8, 4096, torch.bfloat16)
    live = ops.lora_live(idx, ranks, "mbgmv", 64, 16)
    want = ops.lora_delta(x, a, b, idx, live=live)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        got = ops.lora_delta(x, a, b, idx, live=live)
    info = (ctypes.c_longlong * 3)()
    assert lib.rt_graph_edges(ctypes.c_void_p(g.raw_cuda_graph()),
                              info) == 0
    assert tuple(info) == (2, 1, 1)
    g.instantiate()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,KV,hd,split", [
    (8, 32, 4, 128, True), (2, 8, 1, 128, True), (8, 32, 32, 128, False),
    (8, 96, 8, 128, True), (20, 96, 8, 128, False), (8, 48, 8, 128, True),
    (8, 128, 8, 128, True), (20, 128, 8, 128, False), (4, 32, 1, 64, True),
    (4, 8, 1, 256, True), (4, 16, 1, 96, True)])
def test_paged_attention_splits_match_plain(card, dtype, B, H, KV, hd,
                                            split):
    """The paged kernel with each row's block table split over blocks
    (few rows x KV heads: yi-9b's 8 x 4, GQA group 8; mistral-large's 8 x
    8, group 12; dbrx/grok's, group 6) and in one block (8 x 32, llama2-
    7b's, group 1; 20 x 8 at group 12), and at the edge of what the kernel
    takes (GQA group x pow2(hd / 8) = 256: group 16 at hd 128, 32 at hd
    64, 8 at hd 256, 16 at hd 96): a 2,300-token row beside short rows,
    a row with no claimed page, unclaimed holes; each row within 1e-2
    (bf16) / 1e-5 (f32) of its max |plain|, NaN in every page a row does
    not own leaves its output bitwise unchanged, and a second run is
    bitwise equal."""
    ps, W = 32, 80
    P = B * W + 1
    g = torch.Generator(device=card).manual_seed(B * H + KV)
    q = torch.randn(B, H, hd, generator=g, device=card).to(dtype)
    k = torch.randn(P, KV, ps, hd, generator=g, device=card).to(dtype)
    v = torch.randn(P, KV, ps, hd, generator=g, device=card).to(dtype)
    pp = torch.full((P, ps), -1, dtype=torch.int32)
    bt = torch.full((B, W), -1, dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    perm = np.random.default_rng(B).permutation(P - 1).tolist()
    ctx = [0, 2300] + [37 * (i + 1) for i in range(B - 2)]
    for b, n_tok in enumerate(ctx):
        for j in range(-(-n_tok // ps)):
            pg = perm.pop()
            bt[b, j] = pg
            filled = torch.arange(ps) + j * ps
            pp[pg] = torch.where(filled < n_tok, filled, -1).int()
        pos[b] = max(n_tok - 1, 0)
    bt[1, [5, 40]] = -1
    pp, bt, pos = pp.to(card), bt.to(card), pos.to(card)
    assert (paged.split_plan(B, KV, W, bgmv.sm_count(q.device),
                             paged.group_tiles(H // KV, hd)) > 1) == split
    n = paged.paged_attention.launches
    got = paged.paged_attention(q, k, v, pp, bt, pos)
    assert paged.paged_attention.launches == n + 1
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    _rows_close(got, ref.paged_attention_ref(q, k, v, pp, bt, pos), tol,
                0.0 if dtype == torch.bfloat16 else 1.0)
    assert bool((got[0] == 0).all())
    assert torch.equal(got, paged.paged_attention(q, k, v, pp, bt, pos))
    for b in range(B):
        keep = torch.zeros(P, dtype=torch.bool, device=card)
        keep[bt[b][bt[b] >= 0].long()] = True
        kk = torch.where(keep[:, None, None, None], k, float("nan"))
        vv = torch.where(keep[:, None, None, None], v, float("nan"))
        out = paged.paged_attention(q, kk, vv, torch.where(keep[:, None],
                                                          pp, 0), bt, pos)
        assert torch.equal(out[b], got[b]), b


@pytest.mark.parametrize("H,KV,hd", [(136, 8, 264), (33, 1, 320),
                                     (9, 1, 257), (17, 1, 512)])
def test_paged_attention_refuses_groups_past_one_block(card, H, KV, hd):
    """Any group is taken now (group tiles); past hd 256, where a head's
    lanes would pass one warp, the wrapper raises, launching nothing."""
    B, P, ps = 2, 4, 32
    q = torch.zeros(B, H, hd, device=card, dtype=torch.bfloat16)
    k = torch.zeros(P, KV, ps, hd, device=card, dtype=torch.bfloat16)
    pp = torch.zeros(P, ps, dtype=torch.int32, device=card)
    bt = torch.zeros(B, 2, dtype=torch.int32, device=card)
    pos = torch.zeros(B, dtype=torch.int32, device=card)
    n = paged.paged_attention.launches
    with pytest.raises(ValueError, match="hd 1 to 256"):
        paged.paged_attention(q, k, k, pp, bt, pos)
    assert paged.paged_attention.launches == n


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
@pytest.mark.parametrize("rows,dtype", [(8, torch.bfloat16),
                                        (300, torch.bfloat16),
                                        (300, torch.float32)])
def test_lora_expand_ranks_past_64_match_plain(card, mode, rows, dtype):
    """r_max 128: the row tiles take the rank rows in two passes of 64,
    each pass's sum added on the CUDA cores; live widths 16/80/128 (the
    decode path at 8 rows). Each row within 1e-2 (bf16) / 1e-5 (f32) of
    its max |plain|, and a second run bitwise equal."""
    g = torch.Generator(device=card).manual_seed(rows)
    ranks = [128, 80, 16]
    b = torch.zeros(3, 128, 264, device=card, dtype=dtype)
    for s, r in enumerate(ranks):
        b[s, :r] = (torch.randn(r, 264, generator=g, device=card)
                    * r ** -0.5).to(dtype)
    y = torch.randn(rows, 128, generator=g, device=card).to(dtype)
    idx = (torch.arange(rows, device=card) // 17 % 4 - 1).to(torch.int32)
    live = ref.bgmv_live(idx, 128) if mode == "bgmv" else ref.mbgmv_live(
        idx, torch.tensor(ranks, dtype=torch.int32, device=card), 16)
    out = bgmv.lora_expand(y, b, idx, live)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    _rows_close(out, ref.lora_expand_ref(y, b, idx, live), tol,
                0.0 if dtype == torch.bfloat16 else 1.0)
    assert torch.equal(out, bgmv.lora_expand(y, b, idx, live))


def _wgmma_expand_case(card, rows, d_out, r_max, ranks, seg, one_slot=None,
                       seed=0):
    """Expand inputs for the persistent wgmma kernel: a bf16 pool of
    len(ranks) slots (zero past each rank), f32 y (the shrink's) with junk
    at and past each row's live width under MBGMV, and idx in runs of
    `seg` rows cycling through -1 and every slot (seg 0: random), or every
    row at slot `one_slot`."""
    g = torch.Generator(device=card).manual_seed(seed + rows + d_out + r_max)
    b = torch.zeros(len(ranks), r_max, d_out, device=card)
    for s, r in enumerate(ranks):
        b[s, :r] = torch.randn(r, d_out, generator=g, device=card) * r ** -.5
    y = torch.randn(rows, r_max, generator=g, device=card)
    if one_slot is not None:
        idx = torch.full((rows,), one_slot, device=card)
    elif seg:
        idx = torch.arange(rows, device=card) // seg % (len(ranks) + 1) - 1
    else:
        idx = torch.randint(-1, len(ranks), (rows,), generator=g,
                            device=card)
    return y, b.bfloat16(), idx.to(torch.int32), torch.tensor(
        ranks, dtype=torch.int32, device=card)


# (rows, d_out, r_max, ranks, seg, one slot): kernel_ab.py --expand's rows
# (training; the yi-9b chunk's q and k / v; the prefill; runs of 32 over 8
# slots; a partial last tile) and MBGMV's odd widths
WGMMA_EXPAND_CASES = [
    (4096, 4096, 64, [64], 0, 0),
    (512, 4096, 64, [8, 16, 32, 64] * 2, 0, 7),
    (512, 512, 64, [8, 16, 32, 64] * 2, 0, 7),
    (32768, 4096, 64, [8, 16, 32, 64] * 2, 4096, None),
    (2048, 4096, 64, [8, 16, 32, 64] * 2, 32, None),
    (4133, 4096, 64, [64, 16, 48, 8], 4096, None),
    (65, 8, 64, [64, 16, 48, 8], 1, None),
    (300, 136, 64, [64, 16, 48, 8], 17, None),
    (777, 520, 24, [24, 4, 20], 0, None),
]


@pytest.mark.parametrize("mode,rank_block", [("bgmv", 16), ("mbgmv", 16),
                                             ("mbgmv", 4)])
@pytest.mark.parametrize("rows,d_out,r_max,ranks,seg,one_slot",
                         WGMMA_EXPAND_CASES)
def test_lora_expand_wgmma_matches_plain(card, mode, rank_block, rows, d_out,
                                         r_max, ranks, seg, one_slot):
    """The persistent wgmma expand (bf16 B, d_out a multiple of 8, more
    than 64 rows) at kernel_ab.py's shapes, under BGMV and MBGMV live
    widths (rank blocks of 16 and of 4: live widths that are no multiple
    of 8), the shrink's f32 y with junk past each row's live width: each
    row within 1e-2 of its max |plain| on the cast y, idx -1 rows exactly
    0; bitwise equal to the expand of y cast to bf16 first (rounding on
    load is the cast) and to a second run."""
    y, b, idx, ranks_t = _wgmma_expand_case(card, rows, d_out, r_max, ranks,
                                            seg, one_slot)
    live = ops.lora_live(idx, ranks_t, mode, r_max, rank_block)
    plan = bgmv.expand_plan(rows, d_out, bgmv.sm_count(card), b.dtype)
    assert plan.cols in bgmv.EXPAND_TILE_COLS
    if mode == "mbgmv":
        junk = torch.arange(r_max, device=card)[None] >= live[:, None]
        y = torch.where(junk, 1e4, y)
    n = bgmv.lora_expand.launches
    out = bgmv.lora_expand(y, b, idx, live)
    assert bgmv.lora_expand.launches == n + 1
    yd = y.bfloat16()
    _rows_close(out, ref.lora_expand_ref(yd, b, idx, live), 1e-2, 0.0)
    assert bool((out[idx < 0] == 0).all())
    assert torch.equal(out, bgmv.lora_expand(yd, b, idx, live))
    assert torch.equal(out, bgmv.lora_expand(y, b, idx, live))


@pytest.mark.parametrize("mode,rank_block", [("bgmv", 16), ("mbgmv", 4)])
@pytest.mark.parametrize("r_max", [8, 16, 24, 64, 72, 128, 200, 1024])
def test_lora_expand_wgmma_any_rank_matches_plain(card, mode, rank_block,
                                                  r_max):
    """r_max 8 to 1,024 on the wgmma expand: rank chunks of 64 (several
    passes' worth of items a slot past 64), B's last 8-row group zeroed
    where a slot's width ends mid k-step, idx -1 rows and MBGMV rank
    blocks of 4; 300 rows in runs of 17, d_out 264. Each row within 1e-2
    of its max |plain|, bitwise equal to a second run."""
    ranks = [r_max, max(4, r_max // 3), 4, min(r_max, 12)]
    y, b, idx, ranks_t = _wgmma_expand_case(card, 300, 264, r_max, ranks, 17)
    live = ops.lora_live(idx, ranks_t, mode, r_max, rank_block)
    out = bgmv.lora_expand(y, b, idx, live)
    _rows_close(out, ref.lora_expand_ref(y.bfloat16(), b, idx, live), 1e-2,
                0.0)
    assert bool((out[idx < 0] == 0).all())
    assert torch.equal(out, bgmv.lora_expand(y, b, idx, live))


def test_lora_expand_wgmma_never_reads_past_live_rows(card):
    """NaN in every rank row of B past each slot's live width rounded up
    to 8 (the group a width ends in may be read, as the kernel's header
    says), in the slot no row uses, and in y's rows of idx -1: the result
    is bitwise that of the clean inputs."""
    ranks = [64, 20, 4, 36]
    y, b, idx, ranks_t = _wgmma_expand_case(card, 1000, 1024, 64,
                                            ranks + [64], 17)
    idx = torch.where(idx == 4, -1, idx)
    live = ops.lora_live(idx, ranks_t, "mbgmv", 64, 4)
    clean = bgmv.lora_expand(y, b, idx, live)
    pb, py = b.clone(), y.clone()
    for s, r in enumerate(ranks):
        pb[s, -(-r // 8) * 8:] = float("nan")
    pb[4] = float("nan")
    py[idx < 0] = float("nan")
    assert torch.equal(bgmv.lora_expand(py, pb, idx, live), clean)


def test_lora_expand_wgmma_graph_replay_equals_eager(card):
    """A CUDA graph of the wgmma expand (the training shape and a tile of
    several slots) replayed twice gives the eager launch's bits."""
    import gc
    for rows, seg, one in ((4096, 0, 0), (2048, 32, None)):
        y, b, idx, _ = _wgmma_expand_case(card, rows, 4096, 64,
                                          [8, 16, 32, 64] * 2, seg, one)
        live = ref.bgmv_live(idx, 64)
        eager = bgmv.lora_expand(y, b, idx, live)
        out = torch.empty_like(eager)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out.copy_(bgmv.lora_expand(y, b, idx, live))
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                out.copy_(bgmv.lora_expand(y, b, idx, live))
        finally:
            gc.enable()
        for _ in range(2):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


def test_lora_expand_wgmma_refusals_raise(card):
    """The wgmma launch is never given up for another: the entry point
    refuses a tile width it has no kernel for, f32 B, a d_out that is no
    multiple of 8 (TMA's 16-byte strides) and the mma.sync row tiles for
    what the wgmma kernel takes; the wrapper raises for a B that does not
    start on 16 bytes."""
    from repro_torch.kernels import build
    lib = build.library()
    y, b, idx, _ = _wgmma_expand_case(card, 300, 264, 64, [64], 0, 0)
    live = ref.bgmv_live(idx, 64)
    out = torch.empty(300, 264, device=card, dtype=torch.bfloat16)
    st = build.stream_handle(card)
    bf, f32 = build.DTYPE_CODE[torch.bfloat16], build.DTYPE_CODE[
        torch.float32]
    for d_out, cols, dt, yd in ((264, 96, bf, f32), (264, 64, f32, f32),
                                (260, 64, bf, f32), (264, 0, bf, bf)):
        assert lib.rt_lora_expand(y.data_ptr(), b.data_ptr(), idx.data_ptr(),
                                  live.data_ptr(), out.data_ptr(), 300, 64,
                                  d_out, 1, 8, cols, dt, yd, st) != 0
    wide = torch.zeros(1, 64 * 264 + 8, device=card, dtype=torch.bfloat16)
    odd = wide[0, 4:4 + 64 * 264].view(1, 64, 264)
    with pytest.raises(ValueError, match="16-byte"):
        bgmv.lora_expand(y, odd, idx, live)


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
@pytest.mark.parametrize("rows,seg", [(8, 0), (2048, 256)])
@pytest.mark.parametrize("d_in,d_out", [(5120, 5120), (12288, 12288),
                                        (12288, 1024)])
def test_lora_pair_at_family_widths(card, mode, rows, seg, d_in, d_out):
    """The shrink and the expand at llama2-13b's d 5,120 and mistral-
    large's d 12,288 (q: d_out 12,288; k/v over 8 KV heads: 1,024), on
    the decode path (8 rows) and the row tiles (2,048 rows in runs of 256
    per slot), bf16, ranks 8/16/32/64: each row within 1e-5 x max(1, its
    max |plain|) (shrink, f32 out) / 1e-2 x its max |plain| (expand), and
    a second run bitwise equal."""
    g = torch.Generator(device=card).manual_seed(rows + d_in + d_out)
    ranks = [8, 16, 32, 64] * 2
    bf = torch.bfloat16
    a = torch.zeros(8, d_in, 64, device=card, dtype=bf)
    b = torch.zeros(8, 64, d_out, device=card, dtype=bf)
    for s, r in enumerate(ranks):
        a[s, :, :r] = (torch.randn(d_in, r, generator=g, device=card)
                       * d_in ** -0.5).to(bf)
        b[s, :r] = (torch.randn(r, d_out, generator=g, device=card)
                    * r ** -0.5).to(bf)
    x = torch.randn(rows, d_in, generator=g, device=card).to(bf)
    if seg:
        idx = torch.arange(rows, device=card) // seg % 9 - 1
    else:
        idx = torch.randint(-1, 8, (rows,), generator=g, device=card)
    idx = idx.to(torch.int32)
    live = ref.bgmv_live(idx, 64) if mode == "bgmv" else ref.mbgmv_live(
        idx, torch.tensor(ranks, dtype=torch.int32, device=card), 16)
    y = bgmv.lora_shrink(x, a, idx, live)
    _rows_close(y, ref.lora_shrink_ref(x, a, idx, live), 1e-5, 1.0)
    assert torch.equal(y, bgmv.lora_shrink(x, a, idx, live))
    yd = y.to(bf)
    out = bgmv.lora_expand(yd, b, idx, live)
    _rows_close(out, ref.lora_expand_ref(yd, b, idx, live), 1e-2, 0.0)
    assert bool((out[idx < 0] == 0).all())
    assert torch.equal(out, bgmv.lora_expand(yd, b, idx, live))


def test_windowed_paged_decode_on_card_takes_the_plain_path(card):
    """yi-9b-smoke (f32) at 24 tokens past its window of 16: a windowed
    decode step over the paged pool on the card launches no paged kernel
    (the kernel has no window mask, as the reference's has none) and
    gives the CPU's logits; without the window the kernel launches."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.weights import init_params
    from repro_torch.serving import cache as cache_lib
    cfg = get_config("yi-9b").smoke()
    win, L, S, ps = cfg.sliding_window, 24, 32, 8
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, L)).astype(np.int32))
    ids = np.arange(8, dtype=np.int32).reshape(2, 4)
    cpu = init_params(cfg, 0, "cpu")
    logits = {}
    for dev, params in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).to(card))):
        lg, rc = model_lib.prefill(cfg, params, {"tokens": toks.to(dev)},
                                   cache_slots=S, window=win)
        pool = cache_lib.scatter_pages(
            cache_lib.zeros_paged(model_lib.cache_abstract(cfg, 1, S), 8,
                                  ps, dev), rc, ids)
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((2,), L, dtype=torch.int32, device=dev)
        n = paged.paged_attention.launches
        out, _ = model_lib.decode(cfg, params, pool, tok, pos, window=win,
                                  block_table=torch.from_numpy(ids).to(dev))
        assert paged.paged_attention.launches == n
        logits[dev] = out.cpu()
    np.testing.assert_allclose(logits["cuda"].numpy(), logits["cpu"].numpy(),
                               atol=1e-4, rtol=1e-4)
    model_lib.decode(cfg, cpu.to(card), pool, tok, pos,
                     block_table=torch.from_numpy(ids).to(card))
    assert paged.paged_attention.launches == n + cfg.n_layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,H,KV,L", [
    (True, None, 8, 8, 300), (True, 64, 8, 2, 515), (False, 100, 4, 1, 257)])
def test_flash_function_grads_on_card_match_plain(card, dtype, causal,
                                                  window, H, KV, L):
    """dq, dk, dv through the flash Function (the kernel forward, the
    blockwise backward) on (B, L, H, hd) views against autograd through the
    plain version on the card: f32 within 1e-5, bf16 per row within 1e-2
    of its max |plain|; the kernel launched; a second backward bitwise
    equal."""
    g = torch.Generator(device=card).manual_seed(L + H)
    leaves = [torch.randn(2, L, n, 128, generator=g, device=card).to(dtype)
              .requires_grad_() for n in (H, KV, KV)]
    views = [t.transpose(1, 2) for t in leaves]
    dout = torch.randn(2, H, L, 128, generator=g, device=card).to(dtype)
    n = flash.flash_attention.launches
    out = flash.flash_attention(*views, causal=causal, window=window)
    assert flash.flash_attention.launches == n + 1
    got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    again = torch.autograd.grad(out, leaves, dout)
    plain = ref.flash_attention_ref(*views, causal=causal, window=window)
    want = torch.autograd.grad(plain, leaves, dout)
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype and torch.equal(a, b)
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, **TOL)
        else:
            _rows_close(a.reshape(-1, 128), w.reshape(-1, 128), 1e-2, 0.0)


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
@pytest.mark.parametrize("rows,r_max", [(8, 64), (4096, 64), (300, 48),
                                        (40, 24)])
def test_lora_function_grads_on_card_match_plain(card, mode, rows, r_max):
    """dx, dA, dB of the LoRA delta through the shrink / expand Functions
    (the data gradients through the kernels on A^T and B^T) against
    autograd through the plain versions, in f32, with idx -1 rows, on both
    launch paths of each kernel and at r_max 48 and 24 (multiples of 8
    that are no power-of-two multiple of it). Each row within 1e-5 x
    max(1, its max |plain|), the f32 rule: dA and dB sum up to thousands
    of rows whose dy / y come from the kernels in another order."""
    g = torch.Generator(device=card).manual_seed(rows + r_max)
    ranks = [r_max, r_max // 2, 8, r_max - 8]
    a = torch.zeros(4, 256, r_max, device=card)
    b = torch.zeros(4, r_max, 384, device=card)
    for s, r in enumerate(ranks):
        a[s, :, :r] = torch.randn(256, r, generator=g, device=card) / 16
        b[s, :r] = torch.randn(r, 384, generator=g, device=card) / 8
    x = torch.randn(rows, 256, generator=g, device=card)
    idx = torch.randint(-1, 4, (rows,), generator=g, device=card).to(
        torch.int32)
    live = ops.lora_live(idx, torch.tensor(ranks, dtype=torch.int32,
                                           device=card), mode, r_max, 8)
    x, a, b = (t.requires_grad_() for t in (x, a, b))
    dout = torch.randn(rows, 384, generator=g, device=card)
    n = (bgmv.lora_shrink.launches, bgmv.lora_expand.launches)
    got = torch.autograd.grad(ops.lora_delta(x, a, b, idx, live=live),
                              (x, a, b), dout)
    # forward and backward: each kernel twice
    assert (bgmv.lora_shrink.launches, bgmv.lora_expand.launches) == \
        (n[0] + 2, n[1] + 2)
    y = ref.lora_shrink_ref(x, a, idx, live)
    want = torch.autograd.grad(ref.lora_expand_ref(y, b, idx, live),
                               (x, a, b), dout)
    for gt, w in zip(got, want):
        _rows_close(gt.reshape(-1, gt.shape[-1]), w.reshape(-1, w.shape[-1]),
                    1e-5, 1.0)
    assert bool((got[0][idx < 0] == 0).all())


def test_lora_train_grads_on_card_match_cpu(card):
    """The loss and adapter gradients of llama2-7b-smoke (f32, nonzero B)
    on the card, through the flash and LoRA kernels and their Functions,
    against the same on the CPU: each leaf within 1e-4 x its max."""
    from repro_torch.models.weights import init_params
    from repro_torch.training import train
    cfg = get_config("llama2-7b").smoke()
    g = torch.Generator().manual_seed(1)
    ad = train.init_lora_adapter(cfg, 8, g)
    for t in ad:
        ad[t]["b"] = torch.randn(ad[t]["b"].shape, generator=g) * 0.1
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (4, 64)).astype(np.int32))}
    params = init_params(cfg, 0, "cpu")
    lc, gc = train.lora_loss_and_grads(cfg, params, ad, batch, 8)
    n = flash.flash_attention.launches
    to = lambda tr: {t: {k: v.to(card) for k, v in ab.items()}  # noqa
                     for t, ab in tr.items()}
    lg, gg = train.lora_loss_and_grads(
        cfg, params.to(card), to(ad), {"tokens": batch["tokens"].to(card)},
        8)
    # the forward and the remat recompute, each layer
    assert flash.flash_attention.launches == n + 2 * cfg.n_layers
    assert float(lg) == pytest.approx(float(lc), rel=1e-5)
    for t in gc:
        for k in ("a", "b"):
            w = gc[t][k]
            err = float((gg[t][k].cpu() - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()), (t, k, err)


# ------------------------------- shapes past the registered configs ----

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,KV,hd", [
    (8, 32, 1, 128), (3, 71, 1, 64), (4, 8, 2, 80), (4, 4, 2, 100),
    (4, 8, 2, 12)], ids=["MQA G 32 hd 128", "MQA G 71 hd 64", "hd 80",
                         "hd 100", "hd 12"])
def test_paged_attention_new_shapes_match_plain(card, dtype, B, H, KV, hd):
    """Group tiles (MQA at group 32 and 71) and head dims that are no
    multiple of 8 (element copies into padded ring rows): a 2,300-token
    row (splits) beside short rows and a row with no claimed page; each
    row within 1e-2 (bf16) / 1e-5 (f32) of its max |plain|, NaN in every
    page a row does not own leaves its output bitwise unchanged, a second
    run is bitwise equal."""
    ps, W = 32, 80
    P = B * W + 1
    g = torch.Generator(device=card).manual_seed(B * H + hd)
    q = torch.randn(B, H, hd, generator=g, device=card).to(dtype)
    k = torch.randn(P, KV, ps, hd, generator=g, device=card).to(dtype)
    v = torch.randn(P, KV, ps, hd, generator=g, device=card).to(dtype)
    pp = torch.full((P, ps), -1, dtype=torch.int32)
    bt = torch.full((B, W), -1, dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    perm = np.random.default_rng(B + hd).permutation(P - 1).tolist()
    for b, n_tok in enumerate([0, 2300] + [37 * (i + 1)
                                           for i in range(B - 2)]):
        for j in range(-(-n_tok // ps)):
            pg = perm.pop()
            bt[b, j] = pg
            filled = torch.arange(ps) + j * ps
            pp[pg] = torch.where(filled < n_tok, filled, -1).int()
        pos[b] = max(n_tok - 1, 0)
    pp, bt, pos = pp.to(card), bt.to(card), pos.to(card)
    n = paged.paged_attention.launches
    got = paged.paged_attention(q, k, v, pp, bt, pos)
    assert paged.paged_attention.launches == n + 1
    want = ref.paged_attention_ref(q, k, v, pp, bt, pos)
    if dtype == torch.float32:
        _rows_close(got, want, 1e-5, 1.0)
    else:
        _rows_close(got, want, 1e-2, 0.0)
    assert not got[0].any()
    assert torch.equal(got, paged.paged_attention(q, k, v, pp, bt, pos))
    for b in range(B):
        keep = torch.zeros(P, dtype=torch.bool, device=card)
        keep[bt[b][bt[b] >= 0].long()] = True
        kk = torch.where(keep[:, None, None, None], k, float("nan"))
        vv = torch.where(keep[:, None, None, None], v, float("nan"))
        out = paged.paged_attention(q, kk, vv, torch.where(keep[:, None],
                                                          pp, 0), bt, pos)
        assert torch.equal(out[b], got[b]), b


def test_paged_launch_is_unchanged_where_one_block_held_the_group(card):
    """The lane kernel (f32 at every group, bf16 at G 1): where G x
    pow2(hd / 8) <= 256 it still takes one group tile, the grid's y axis
    the KV heads and the block G x pow2(hd / 8) x slot-group threads, as
    before group tiles; past it the library's tile count equals
    `paged.group_tiles`. bf16 at G >= 2 launches the group kernel, one
    block a (split, KV head, row) at any page size, its combine one warp
    a (row, head)."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.library()
    n = len(build.INFO_FIELDS)
    out = (ctypes.c_longlong * (2 * n))()
    for G in range(1, 40):
        for hd in (64, 80, 96, 128, 256):
            lanes = 1
            while lanes < hd // 8:
                lanes *= 2
            tiles = lib.rt_paged_attention_tiles(G, hd)
            assert tiles == paged.group_tiles(G, hd)
            assert lib.rt_paged_attention_info(8, 2 * G, 2, 32, hd, 16, 1, 0,
                                               out) == 0
            info = dict(zip(build.INFO_FIELDS, out[:n]))
            if G * lanes <= 256:
                assert tiles == 1 and info["grid_y"] == 2
                tg = 256 // (G * lanes)
                assert info["threads"] == -(-G * lanes * tg // 32) * 32
            else:
                assert info["grid_y"] == 2 * tiles
            for ps in (16, 32, 64, 128) if G > 1 else (32,):
                assert lib.rt_paged_attention_info(8, 2 * G, 2, ps, hd, 16,
                                                   4, 1, out) == 0
                attn = dict(zip(build.INFO_FIELDS, out[:n]))
                comb = dict(zip(build.INFO_FIELDS, out[n:2 * n]))
                if G == 1:
                    assert attn["grid_y"] == 2 and attn["grid_z"] == 4
                    assert comb["grid_x"] == 8 and comb["grid_y"] == 2
                else:
                    assert (attn["grid_x"], attn["grid_y"],
                            attn["grid_z"]) == (4, 2, 8), (G, hd, ps)
                    assert (comb["grid_x"], comb["threads"]) == (
                        -(-16 * G // 4), 128)
                    # the ring holds chunks of at most 32 slots
                    if ps > 32:
                        assert attn["dyn_smem"] <= small["dyn_smem"], ps
                    else:
                        small = attn


def _group_case(card, G, hd, KV=2, B=4, seed=0, ps=32):
    """Paged inputs in bf16 at GQA group G: row 0 claims no page, row 1
    holds 2,300 tokens (its table split over blocks) with unclaimed
    entries mid-table, row 2 a short row, row 3 one claimed page whose
    slots are all empty (no valid slot)."""
    W = max(80, -(-2300 // ps) + 4)
    P = B * W + 1
    g = torch.Generator(device=card).manual_seed(seed * 1000 + G * 7 + hd)
    q = torch.randn(B, G * KV, hd, generator=g, device=card).bfloat16()
    k = torch.randn(P, KV, ps, hd, generator=g, device=card).bfloat16()
    v = torch.randn(P, KV, ps, hd, generator=g, device=card).bfloat16()
    pp = torch.full((P, ps), -1, dtype=torch.int32)
    bt = torch.full((B, W), -1, dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    perm = np.random.default_rng(G + hd).permutation(P - 1).tolist()
    for b, n_tok in enumerate([0, 2300, 77, 0][:B]):
        for j in range(-(-n_tok // ps)):
            pg = perm.pop()
            bt[b, j] = pg
            filled = torch.arange(ps) + j * ps
            pp[pg] = torch.where(filled < n_tok, filled, -1).int()
        pos[b] = max(n_tok - 1, 0)
    bt[1, [3, 30, 31]] = -1
    bt[3, 0] = perm.pop()                  # claimed, every slot empty
    pos[3] = 50
    return [q, k, v, pp.to(card), bt.to(card), pos.to(card)]


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("G", [2, 6, 8, 12, 32, 71, 128])
def test_paged_group_kernel_matches_plain(card, G, hd):
    """The group kernel (bf16, one block a KV head's whole group) against
    the plain version: each row within 1e-2 of its max |plain|, the rows
    with no valid slot (no claimed page; one claimed page of empty slots)
    exactly zero, one launch counted a call."""
    args = _group_case(card, G, hd)
    assert paged.route(G, hd, torch.bfloat16) == 1
    assert paged.split_plan(4, 2, 80, bgmv.sm_count(card), 1) > 1
    n = paged.paged_attention.launches
    got = paged.paged_attention(*args)
    assert paged.paged_attention.launches == n + 1
    _rows_close(got, ref.paged_attention_ref(*args), 1e-2, 0.0)
    assert not got[0].any() and not got[3].any()


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("G,ps", [(8, 16), (8, 48), (8, 64), (8, 128),
                                  (32, 64), (71, 128), (128, 128)])
def test_paged_group_kernel_at_any_page_size(card, G, ps, hd):
    """The group kernel at pages smaller and larger than its ring stage
    (32 slots; a larger page streams through it in chunks, the last one
    short at 48) against the plain version: each row within 1e-2 of its
    max |plain|, the rows with no valid slot zero, two launches equal."""
    args = _group_case(card, G, hd, ps=ps)
    got = paged.paged_attention(*args)
    _rows_close(got, ref.paged_attention_ref(*args), 1e-2, 0.0)
    assert not got[0].any() and not got[3].any()
    assert torch.equal(got, paged.paged_attention(*args))


@pytest.mark.parametrize("G", [8, 32])
def test_paged_group_kernel_never_reads_foreign_pages(card, G):
    """NaN in every page a row does not own (with valid positions) leaves
    that row's output bitwise unchanged on the group kernel."""
    q, k, v, pp, bt, pos = _group_case(card, G, 128, seed=1)
    got = paged.paged_attention(q, k, v, pp, bt, pos)
    for b in range(q.shape[0]):
        keep = torch.zeros(k.shape[0], dtype=torch.bool, device=card)
        keep[bt[b][bt[b] >= 0].long()] = True
        kk = torch.where(keep[:, None, None, None], k, float("nan"))
        vv = torch.where(keep[:, None, None, None], v, float("nan"))
        out = paged.paged_attention(q, kk, vv, torch.where(keep[:, None],
                                                          pp, 0), bt, pos)
        assert torch.equal(out[b], got[b]), b


@pytest.mark.parametrize("B", [4, 68])
def test_paged_group_kernel_repeats_bitwise(card, B):
    """Two launches of the group kernel give equal bits, with splits (4
    rows) and in one split (68 rows x 2 KV heads fill the card)."""
    args = _group_case(card, 8, 128, B=4, seed=2)
    if B > 4:
        args = [a.repeat(B // 4, *[1] * (a.dim() - 1)) if i in (0, 4, 5)
                else a for i, a in enumerate(args)]
    splits = paged.split_plan(B, 2, 80, bgmv.sm_count(card), 1)
    assert (splits > 1) == (B == 4)
    first = paged.paged_attention(*args)
    assert torch.equal(first, paged.paged_attention(*args))
    _rows_close(first, ref.paged_attention_ref(*args), 1e-2, 0.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [80, 72, 100, 160, 200, 12])
@pytest.mark.parametrize("causal,window,group,Lq,Lk", [
    (True, None, 4, 300, 300), (True, 64, 1, 200, 333),
    (False, 100, 2, 257, 190)])
def test_flash_kernel_padded_widths_match_plain(card, dtype, hd, causal,
                                                window, group, Lq, Lk):
    """A head dim with no instantiation of its own runs at the next width
    (zero columns from TMA, or from the f32 loads; a padded copy where hd
    is no multiple of 8), on (B, L, H, hd) views: each query row within
    1e-2 (bf16) / 1e-5 x max(1, it) (f32) of its max |plain|, the output
    hd wide, a second run bitwise equal."""
    KV = 2
    H = KV * group
    g = torch.Generator(device=card).manual_seed(hd + Lq + Lk)
    q, k, v = (torch.randn(2, L, n, hd, generator=g, device=card)
               .to(dtype).transpose(1, 2) for L, n in ((Lq, H), (Lk, KV),
                                                       (Lk, KV)))
    n = flash.flash_attention.launches
    got = flash.flash_attention(q, k, v, causal=causal, window=window)
    assert flash.flash_attention.launches == n + 1
    assert tuple(got.shape) == (2, H, Lq, hd)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if dtype == torch.float32:
        _rows_close(got.reshape(-1, hd), want.reshape(-1, hd), 1e-5, 1.0)
    else:
        _rows_close(got.reshape(-1, hd), want.reshape(-1, hd), 1e-2, 0.0)
    assert torch.equal(got, flash.flash_attention(q, k, v, causal=causal,
                                                  window=window))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_function_grads_at_hd_80_match_plain(card, dtype):
    """dq, dk, dv through the flash Function at hd 80 (the kernel at width
    96, the plain blockwise backward) against autograd through the plain
    version: each leaf within 5e-2 of its max |plain|."""
    g = torch.Generator(device=card).manual_seed(80)
    leaves = [torch.randn(2, 300, n, 80, generator=g, device=card).to(dtype)
              .requires_grad_() for n in (8, 2, 2)]
    views = [t.transpose(1, 2) for t in leaves]
    dout = torch.randn(2, 8, 300, 80, generator=g, device=card).to(dtype)
    n = flash.flash_attention.launches
    out = flash.flash_attention(*views, causal=True)
    assert flash.flash_attention.launches == n + 1
    got = torch.autograd.grad(out, leaves, dout)
    plain = ref.flash_attention_ref(*views, causal=True)
    want = torch.autograd.grad(plain, leaves, dout)
    for a, w in zip(got, want):
        err = float((a.float() - w.float()).abs().max())
        assert err <= 5e-2 * float(w.float().abs().max()), err


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,seg", [(8, 0), (300, 17), (4133, 4096)])
@pytest.mark.parametrize("d_in,d_out", [(4100, 1000), (1000, 4100),
                                        (131, 37)])
def test_lora_pair_tails_match_plain(card, mode, dtype, rows, seg, d_in,
                                     d_out):
    """The shrink and the expand at widths that are no multiple of 8 (the
    element-copy instantiations) on every launch path (decode and split
    d_in at 8 rows; row tiles at 300 and 4,133), ranks 8/16/32/64: each
    row within 1e-5 x max(1, it) (shrink, f32 out) and 1e-2 (bf16) /
    1e-5 (f32) of its max |plain| (expand), idx -1 rows zero, repeatable
    bitwise."""
    g = torch.Generator(device=card).manual_seed(rows + d_in + d_out)
    ranks = [8, 16, 32, 64]
    a = torch.zeros(4, d_in, 64, device=card, dtype=dtype)
    b = torch.zeros(4, 64, d_out, device=card, dtype=dtype)
    for s, r in enumerate(ranks):
        a[s, :, :r] = (torch.randn(d_in, r, generator=g, device=card)
                       * d_in ** -0.5).to(dtype)
        b[s, :r] = (torch.randn(r, d_out, generator=g, device=card)
                    * r ** -0.5).to(dtype)
    x = torch.randn(rows, d_in, generator=g, device=card).to(dtype)
    if seg:
        idx = torch.arange(rows, device=card) // seg % 5 - 1
    else:
        idx = torch.randint(-1, 4, (rows,), generator=g, device=card)
    idx = idx.to(torch.int32)
    live = ref.bgmv_live(idx, 64) if mode == "bgmv" else ref.mbgmv_live(
        idx, torch.tensor(ranks, dtype=torch.int32, device=card), 16)
    y = bgmv.lora_shrink(x, a, idx, live)
    _rows_close(y, ref.lora_shrink_ref(x, a, idx, live), 1e-5, 1.0)
    assert torch.equal(y, bgmv.lora_shrink(x, a, idx, live))
    yd = y.to(dtype)
    out = bgmv.lora_expand(yd, b, idx, live)
    want = ref.lora_expand_ref(yd, b, idx, live)
    if dtype == torch.float32:
        _rows_close(out, want, 1e-5, 1.0)
    else:
        _rows_close(out, want, 1e-2, 0.0)
    assert not out[idx < 0].any()
    assert torch.equal(out, bgmv.lora_expand(yd, b, idx, live))


# ------------------------------------------ the persistent bf16 flash ----

# (B, H, KV, Lq, Lk, causal, window): more work tiles than blocks (the
# walk takes several tiles of unequal weight a block) and fewer (B 1, Lq
# 1 / 127 / 129), Lq != Lk, windows that straddle tiles, GQA 8 and MQA
PERSISTENT_CASES = [
    (2, 32, 4, 2000, 2000, True, None),          # 1,024 tiles, GQA 8
    (1, 16, 1, 1000, 1000, False, 300),          # MQA, a non-causal window
    (1, 8, 8, 1, 1, True, None),                 # one row a tile
    (1, 2, 1, 127, 127, True, None),
    (1, 3, 3, 129, 129, True, 100),              # a window across tiles
    (2, 8, 1, 700, 1300, True, 250),             # Lq < Lk, MQA
    (2, 16, 2, 1500, 600, False, None),          # Lq > Lk
]


@pytest.mark.parametrize("hd", [32, 64, 80, 96, 128, 256])
@pytest.mark.parametrize("B,H,KV,Lq,Lk,causal,window", PERSISTENT_CASES)
def test_flash_persistent_walk_matches_plain(card, hd, B, H, KV, Lq, Lk,
                                             causal, window):
    """The persistent bf16 kernel (min(work tiles, SMs) blocks, each walking
    its tiles heaviest first, TMA-stored output) on (B, L, H, hd) views:
    each query row within 1e-2 of its max |plain|, a second run bitwise
    equal."""
    g = torch.Generator(device=card).manual_seed(hd + Lq + 7 * H)
    q, k, v = (torch.randn(B, L, n, hd, generator=g, device=card)
               .bfloat16().transpose(1, 2)
               for L, n in ((Lq, H), (Lk, KV), (Lk, KV)))
    n = flash.flash_attention.launches
    got = flash.flash_attention(q, k, v, causal=causal, window=window)
    assert flash.flash_attention.launches == n + 1
    assert tuple(got.shape) == (B, H, Lq, hd)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _rows_close(got.reshape(-1, hd), want.reshape(-1, hd), 1e-2, 0.0)
    assert torch.equal(got, flash.flash_attention(q, k, v, causal=causal,
                                                  window=window))


@pytest.mark.parametrize("hd", [128, 256])
def test_flash_graph_replay_equals_eager_launch(card, hd):
    """A CUDA graph of the kernel (the walk has no counter to reset)
    replayed twice gives the eager launch's bits."""
    import gc
    g = torch.Generator(device=card).manual_seed(hd)
    q, k, v = (torch.randn(2, 1100, n, hd, generator=g, device=card)
               .bfloat16().transpose(1, 2) for n in (16, 2, 2))
    eager = flash.flash_attention(q, k, v)
    out = torch.empty_like(eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out.copy_(flash.flash_attention(q, k, v))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            out.copy_(flash.flash_attention(q, k, v))
    finally:
        gc.enable()
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_flash_walk_copy_matches_the_library(card):
    """`flash.tile_order` equals the kernel's own TileOrder run on the host
    (`rt_flash_attention_order`), and every bf16 launch's description is
    the persistent grid `flash.persistent_grid` gives."""
    import ctypes
    from repro_torch.analysis import kernel_verify
    from repro_torch.kernels import build
    lib = build.library()
    assert kernel_verify.flash_order_findings(lib) == []
    sms = bgmv.sm_count(card)
    info = (ctypes.c_longlong * len(build.INFO_FIELDS))()
    for B, H, Lq in ((1, 1, 1), (8, 32, 512), (1, 4, 300), (8, 32, 4096)):
        assert lib.rt_flash_attention_info(B, H, Lq, Lq, 128, 1, 0,
                                           build.DTYPE_CODE[torch.bfloat16],
                                           info) == 0
        got = dict(zip(build.INFO_FIELDS, info))
        assert (got["grid_x"], got["grid_y"], got["grid_z"]) == \
            (flash.persistent_grid(B, H, Lq, sms), 1, 1)
