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

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.engine import InferenceServer  # noqa: E402
from repro_torch.core.lora import AdapterSpec  # noqa: E402
from repro_torch.kernels import bgmv, ops, paged, ref  # noqa: E402
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


def _serve(device, params=None):
    cfg = get_config("llama2-7b").smoke()
    srv = InferenceServer(cfg, mode="caraserve", max_batch=4,
                          cache_slots=64, seed=0, device=device,
                          params=params)
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
