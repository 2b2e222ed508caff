"""The port's flash attention (repro_torch.kernels.flash) against the
reference's Pallas kernel, run in interpret mode on the CPU as the
reference's own tests run it (bq = bk = 64). On a CPU tensor the wrapper
takes its plain PyTorch version, so these tests hold the plain version —
what the CUDA kernel is checked against on the card — to the TPU
kernel's function. Inputs are made with numpy from a seed. Tolerances are
the reference's own (tests/test_kernels.py): atol = rtol = 2e-5 in f32,
3e-2 in bf16 (one bf16 rounding of outputs of magnitude up to ~3)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small ops: one intra-op thread avoids oversubscribing the cores the
# reference (XLA) and the other test workers share
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash import flash_attention as jflash  # noqa: E402
from repro_torch.kernels import build, flash, ops, ref  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(seed, B, H, KV, Lq, Lk, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Lq, hd)).astype(np.float32),
            rng.normal(size=(B, KV, Lk, hd)).astype(np.float32),
            rng.normal(size=(B, KV, Lk, hd)).astype(np.float32))


def _to_jax(arrs, dt):
    return [jnp.asarray(a).astype(dt) for a in arrs]


def _to_torch(arrs, dt):
    return [torch.from_numpy(a).to(dt) for a in arrs]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("Lq,Lk", [(130, 130), (96, 160), (160, 96)])
def test_flash_plain_matches_pallas(dtype, causal, window, group, Lq, Lk):
    """Ragged lengths (130 and 96/160 are no multiples of 64), Lq < Lk and
    Lq > Lk (both sides put query i at position i, as key i), GQA groups
    1/2/4, causal or not, with and without a window."""
    jdt, tdt, tol = DTYPES[dtype]
    KV = 2
    arrs = _inputs(Lq * 7 + Lk + group, 1, KV * group, KV, Lq, Lk, 32)
    want = jflash(*_to_jax(arrs, jdt), causal=causal, window=window,
                  bq=64, bk=64)
    n = flash.flash_attention.launches
    got = flash.flash_attention(*_to_torch(arrs, tdt), causal=causal,
                                window=window)
    assert flash.flash_attention.launches == n
    assert got.dtype == tdt and tuple(got.shape) == (1, KV * group, Lq, 32)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    if Lq == Lk:
        oracle = jref.flash_attention_ref(*_to_jax(arrs, jdt), causal=causal,
                                          window=window)
        np.testing.assert_allclose(_f32(got), _f32(oracle), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("L", [257, 64])
def test_flash_plain_matches_pallas_long_ragged(L):
    """Several KV tiles with a partial last one (257 = 4 x 64 + 1), and one
    exact tile; B 2, GQA group 2, causal, f32; plus `ops.attention`, the
    public entry point."""
    arrs = _inputs(L, 2, 4, 2, L, L, 64)
    want = jflash(*_to_jax(arrs, jnp.float32), bq=64, bk=64)
    got = ops.attention(*_to_torch(arrs, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hd,H,KV,Lq,Lk,causal,window", [
    (96, 4, 4, 150, 150, True, None),       # phi-3-vision: MHA, hd 96
    (96, 4, 4, 70, 130, False, None),
    (256, 10, 1, 150, 150, True, 40),       # recurrentgemma: MQA 10 / 1
    (256, 10, 1, 96, 70, True, None),
    (64, 6, 6, 20, 150, False, None)])      # whisper's cross-attention
def test_flash_plain_matches_pallas_new_head_dims(dtype, hd, H, KV, Lq, Lk,
                                                  causal, window):
    """The head dims this port's flash kernel added (96, 256) and
    whisper's non-causal Lq != Lk shape: the plain version equals the
    Pallas kernel in interpret mode, which takes any head dim."""
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _inputs(hd + Lq + Lk, 1, H, KV, Lq, Lk, hd)
    want = jflash(*_to_jax(arrs, jdt), causal=causal, window=window,
                  bq=64, bk=64)
    got = flash.flash_attention(*_to_torch(arrs, tdt), causal=causal,
                                window=window)
    assert got.dtype == tdt and tuple(got.shape) == (1, H, Lq, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_flash_head_dims_of_the_kernel():
    """The kernel's head dims in each dtype (csrc/flash_attention.cu):
    every hd the served families use, 96 and 256 among them."""
    assert set(flash.HEAD_DIMS[torch.bfloat16]) == {32, 64, 96, 128, 256}
    assert set(flash.HEAD_DIMS[torch.float32]) == {16, 32, 64, 96, 128, 256}
    from repro_torch.configs.base import get_config
    for arch in ("phi-3-vision-4.2b", "recurrentgemma-2b", "whisper-tiny",
                 "llama2-7b", "yi-9b"):
        assert get_config(arch).hd in flash.HEAD_DIMS[torch.bfloat16]


def test_flash_plain_query_blocks_change_nothing():
    """The plain version takes queries `block` at a time to bound its score
    tensor; the block size must not change the result."""
    q, k, v = _to_torch(_inputs(5, 1, 4, 2, 150, 150, 16), torch.float32)
    a = ref.flash_attention_ref(q, k, v, window=40)
    b = ref.flash_attention_ref(q, k, v, window=40, block=32)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_flash_rows_without_a_key_are_zero():
    """A window of 1 under causal masking leaves each query its own key
    only; non-causal with Lq > Lk and window 1 leaves queries past Lk with
    no key at all: their rows must be exactly zero, as the TPU kernel's
    masked p and clamped l give."""
    q, k, v = _to_torch(_inputs(6, 1, 2, 1, 80, 40, 16), torch.float32)
    out = flash.flash_attention(q, k, v, causal=False, window=1)
    assert bool((out[:, :, 40:] == 0).all())
    assert bool((out[:, :, :40] != 0).any(-1).all())
    own = flash.flash_attention(q[:, :, :40], k, v, causal=True, window=1)
    torch.testing.assert_close(own, v.expand(1, 2, 40, 16), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("q_shape,k_shape,match", [
    ((1, 6, 8, 16), (1, 4, 8, 16), "not divisible"),
    ((1, 4, 8, 16), (2, 2, 8, 16), "disagree on batch or head dim"),
    ((1, 4, 8, 16), (1, 2, 8, 32), "disagree on batch or head dim"),
])
def test_flash_shape_validation(q_shape, k_shape, match):
    k = torch.zeros(k_shape)
    with pytest.raises(ValueError, match=match):
        flash.flash_attention(torch.zeros(q_shape), k, k)


def test_flash_k_v_mismatch_and_window_rejected():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="!= v"):
        flash.flash_attention(q, k, torch.zeros(1, 2, 9, 16))
    with pytest.raises(ValueError, match="window must be >= 1"):
        flash.flash_attention(q, k, k, window=0)


def test_flash_on_cpu_never_builds_or_counts(monkeypatch):
    """A CPU tensor takes the plain version: no build, no launch count."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")
    monkeypatch.setattr(build, "library", no_build)
    n = flash.flash_attention.launches
    q, k, v = _to_torch(_inputs(8, 1, 4, 2, 33, 33, 16), torch.float32)
    flash.flash_attention(q, k, v)
    ops.attention(q, k, v, causal=False, window=5)
    assert flash.flash_attention.launches == n
