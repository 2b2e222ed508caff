"""Gradients through the port's kernel wrappers: the flash attention and
LoRA shrink / expand autograd Functions (kernels/flash.py,
kernels/bgmv.py). On the CPU the Functions run the plain versions
forward, so their backward is checked here: `torch.autograd.gradcheck` in
float64 against finite differences, and, in float32, equal (rtol = atol =
1e-5, other summation orders) to autograd through the plain versions.
The same checks on the card are in tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import bgmv, ops, ref  # noqa: E402
from repro_torch.kernels.flash import (FlashAttention,  # noqa: E402
                                       flash_attention,
                                       flash_attention_backward)

TOL = dict(rtol=1e-5, atol=1e-5)
# (causal, window, H, KV, Lq, Lk)
FLASH_CASES = [(True, None, 2, 2, 6, 6), (True, None, 4, 2, 7, 7),
               (True, 3, 4, 1, 7, 7), (False, None, 2, 1, 5, 5),
               (False, 2, 4, 2, 6, 6), (True, None, 2, 1, 4, 7),
               (True, 2, 2, 2, 7, 4)]


def _qkv(B, H, KV, Lq, Lk, hd, dtype, seed=0, view=False):
    """q (B, H, Lq, hd), k/v (B, KV, Lk, hd) requiring grad; `view`: as
    the model passes them, (B, L, H, hd) tensors transposed."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s)).to(dtype)
    if view:
        q, k, v = (mk(B, L, n, hd).requires_grad_().transpose(1, 2)
                   for L, n in ((Lq, H), (Lk, KV), (Lk, KV)))
        return q, k, v
    return (mk(B, H, Lq, hd).requires_grad_(),
            mk(B, KV, Lk, hd).requires_grad_(),
            mk(B, KV, Lk, hd).requires_grad_())


@pytest.mark.parametrize("causal,window,H,KV,Lq,Lk", FLASH_CASES)
def test_flash_gradcheck_f64(causal, window, H, KV, Lq, Lk):
    q, k, v = _qkv(1, H, KV, Lq, Lk, 4, torch.float64, seed=Lq + H)
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, causal, window),
        (q, k, v))


@pytest.mark.parametrize("causal,window,H,KV,Lq,Lk", FLASH_CASES)
@pytest.mark.parametrize("block", [2, 3, 512])
def test_flash_backward_blocks_equal_plain_autograd(causal, window, H, KV,
                                                    Lq, Lk, block):
    """The blockwise backward at any query block (each block against only
    the keys its mask reaches) equals autograd through the plain version,
    with a query row that sees no key (Lq > Lk window cases) included."""
    q, k, v = _qkv(2, H, KV, Lq, Lk, 8, torch.float32, seed=block)
    dout = torch.randn(2, H, Lq, 8, generator=torch.Generator().manual_seed(
        block))
    out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = flash_attention_backward(q.detach(), k.detach(), v.detach(), dout,
                                   causal=causal, window=window, block=block)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_flash_function_on_strided_views_returns_grads_in_their_layout():
    """The model's (B, L, H, hd) tensors passed as (B, H, L, hd) views:
    gradients come back in the leaves' layout and dtype (bf16 here), equal
    to autograd through the plain version; a non-contiguous output
    gradient is taken."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(2, 4, 2, 9, 9, 16, dtype, seed=3, view=True)
        leaves = [t._base for t in (q, k, v)]
        assert not q.is_contiguous()
        out = flash_attention(q, k, v, causal=True, window=5)
        assert out.grad_fn is not None and out.dtype == dtype
        w = torch.randn(2, 9, 4, 16).to(dtype).transpose(1, 2)
        got = torch.autograd.grad((out.float() * w.float()).sum(), leaves)
        plain = ref.flash_attention_ref(q, k, v, causal=True, window=5)
        want = torch.autograd.grad((plain.float() * w.float()).sum(), leaves)
        for g, wt, leaf in zip(got, want, leaves):
            assert g.dtype == dtype and g.shape == leaf.shape
            tol = TOL if dtype == torch.float32 else dict(rtol=1e-2,
                                                          atol=1e-2)
            torch.testing.assert_close(g.float(), wt.float(), **tol)


def test_flash_without_grad_takes_no_function():
    q, k, v = _qkv(1, 2, 2, 5, 5, 4, torch.float32)
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    q, k, v = (t.detach() for t in (q, k, v))
    assert flash_attention(q, k, v).grad_fn is None


# ---------------------------------------------------------------- LoRA ----

def _lora(rows, d_in, d_out, r_max, ranks, dtype, seed=0, mode="mbgmv",
          rank_block=4):
    """x, a, b requiring grad (a, b zero past each slot's rank, as the
    pool is), idx with -1 rows, and each row's live width."""
    rng = np.random.default_rng(seed)
    slots = len(ranks)
    a = np.zeros((slots, d_in, r_max))
    b = np.zeros((slots, r_max, d_out))
    for s, r in enumerate(ranks):
        a[s, :, :r] = rng.normal(size=(d_in, r))
        b[s, :r] = rng.normal(size=(r, d_out))
    x = rng.normal(size=(rows, d_in))
    idx = torch.as_tensor(rng.integers(-1, slots, rows), dtype=torch.int32)
    idx[0] = -1
    live = ops.lora_live(idx, torch.as_tensor(ranks, dtype=torch.int32),
                         mode, r_max, rank_block)
    t = lambda z: torch.from_numpy(z).to(dtype).requires_grad_()  # noqa
    return t(x), t(a), t(b), idx, live


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
def test_lora_gradcheck_f64(mode):
    x, a, b, idx, live = _lora(7, 6, 5, 8, [8, 3, 5], torch.float64,
                               mode=mode)
    assert torch.autograd.gradcheck(
        lambda x, a: bgmv.LoRAShrink.apply(x, a, idx, live), (x, a))
    y = torch.randn(7, 8, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda y, b: bgmv.LoRAExpand.apply(y, b, idx, live), (y, b))
    assert torch.autograd.gradcheck(
        lambda x, a, b: ops.lora_delta(x, a, b, idx, live=live), (x, a, b))


@pytest.mark.parametrize("mode", ["bgmv", "mbgmv"])
@pytest.mark.parametrize("rows", [9, 80])
def test_lora_grads_equal_plain_autograd(mode, rows):
    """dx, dA, dB of the delta (shrink, cast, expand) through the
    Functions equal autograd through the plain versions; idx -1 rows get
    zero dx, and A and B get exactly zero past each slot's rank."""
    x, a, b, idx, live = _lora(rows, 16, 24, 8, [8, 3, 5, 1],
                               torch.float32, seed=rows, mode=mode)
    dout = torch.randn(rows, 24, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(ops.lora_delta(x, a, b, idx, live=live),
                              (x, a, b), dout)
    y = ref.lora_shrink_ref(x, a, idx, live)
    want = torch.autograd.grad(ref.lora_expand_ref(y.to(x.dtype), b, idx,
                                                   live), (x, a, b), dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    assert bool((got[0][idx < 0] == 0).all())
    dead = torch.arange(8)[None] >= torch.tensor([8, 3, 5, 1])[:, None]
    assert bool((got[1].transpose(1, 2)[dead] == 0).all())
    assert bool((got[2][dead] == 0).all())


def test_lora_only_the_needed_gradients_are_computed():
    """The frozen operand gets no gradient: a LoRA step differentiates in
    A and B only where x does not require grad (layer 0), and a frozen
    pool gives x's gradient alone."""
    x, a, b, idx, live = _lora(9, 16, 24, 8, [8, 3], torch.float32)
    xd = x.detach()
    out = ops.lora_delta(xd, a, b, idx, live=live)
    gx = torch.autograd.grad(out.sum(), (a, b))
    assert all(g is not None for g in gx)
    out = ops.lora_delta(x, a.detach(), b.detach(), idx, live=live)
    (g,) = torch.autograd.grad(out.sum(), (x,))
    assert g.shape == x.shape
    with torch.no_grad():
        assert ops.lora_delta(x, a, b, idx, live=live).grad_fn is None
