"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled for sm_90a by its own `nvcc -c` (all started
together), then one `nvcc -shared` links them into
`build/repro_torch/libkernels-<hash of sources and flags>.so` at the root
of the checkout. The library has a plain C interface and is loaded with
ctypes; each entry point launches on the stream it is given and returns
`cudaGetLastError()`. Nothing here runs at import: the first kernel call
builds (or finds) the library. A missing `nvcc` or a failed build raises —
no caller falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, k_pages, v_pages, pos_pages, block_table, pos, out,
    # B, H, KV, P, ps, hd, W, dtype, stream
    "rt_paged_attention": [_P] * 7 + [_I] * 8 + [_P],
    # x, a, idx, live, y, rows, d_in, r_max, slots, dtype, stream
    "rt_lora_shrink": [_P] * 5 + [_I] * 5 + [_P],
    # y, b, idx, live, out, rows, r_max, d_out, slots, dtype, stream
    "rt_lora_expand": [_P] * 5 + [_I] * 5 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None    # set by the build that ran


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("repro_torch kernels: nvcc not found; the CUDA "
                           "kernels build only where the CUDA toolkit is "
                           "installed")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + hdrs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libkernels-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    global build_seconds
    nvcc = _nvcc()
    cus, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (cu.stem + ".o") for cu in cus]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(cu), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for cu, obj in zip(cus, objs)]
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
        bad = [(cu.name, log) for cu, p, log in zip(cus, procs, logs)
               if p.returncode != 0]
        if bad:
            raise RuntimeError("repro_torch kernels: nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in bad))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared",
                               *map(str, objs), "-o", str(tmp_so)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("repro_torch kernels: link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp_so, out)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def stream_handle(device: torch.device) -> int:
    """The current stream of `device` (passing the device skips the
    current-device lookup, which costs tens of microseconds per call)."""
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, *, dtypes=None, ndim=None,
            device=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor the kernel takes."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{sorted(map(str, dtypes))}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_aligned(t: torch.Tensor, name: str) -> None:
    """The kernels read this operand in 16-byte vectors."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
