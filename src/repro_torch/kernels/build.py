"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled for sm_90a by its own `nvcc -c` (all started
together), then one `nvcc -shared` links them into
`build/repro_torch/libkernels-<hash of sources and flags>.so` at the root
of the checkout. The library has a plain C interface and is loaded with
ctypes; each entry point launches on the stream it is given and returns
`cudaGetLastError()`. Nothing here runs at import: the first kernel call
builds (or finds) the library. A missing `nvcc` or a failed build raises —
no caller falls back to the plain versions.

The TMA tensor maps (flash, the bf16 row-tile shrink and expand) are
encoded by the driver function `cuTensorMapEncodeTiled`, which the
library looks up at run time through the CUDA runtime's driver entry
point (`cudaGetDriverEntryPoint`), so nothing beyond the runtime is
linked; a driver without it makes those calls raise (CUDA error 801, not
supported).
nvcc runs with `-Xptxas -v`; its report (registers, shared memory and
spills of each kernel) is written beside the library as
`libkernels-<hash>.log` and held in `build_log`, whether this process built
the library or found it built (a library found without its report is built
again).
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, k_pages, v_pages, pos_pages, block_table, pos, out, ws,
    # B, H, KV, P, ps, hd, W, nsplit, dtype, stream
    "rt_paged_attention": [_P] * 8 + [_I] * 9 + [_P],
    # G (query heads a KV head), hd -> 1 if the paged kernel takes them
    "rt_paged_attention_fits": [_I, _I],
    # G, hd -> the group tiles a KV head's heads are cut into (0: refused)
    "rt_paged_attention_tiles": [_I, _I],
    # G, hd, dtype -> the kernel launched: 0 lanes, 1 group (-1: refused)
    "rt_paged_attention_route": [_I, _I, _I],
    # x, a, idx, live, y, rows, d_in, r_max, slots, tile, d_chunk, split,
    # blocks, dtype, stream
    "rt_lora_shrink": [_P] * 5 + [_I] * 9 + [_P],
    # y, b, idx, live, out, rows, r_max, d_out, slots, blocks, cols,
    # dtype, y_dtype, stream
    "rt_lora_expand": [_P] * 5 + [_I] * 8 + [_P],
    # q, k, v, out, strides (12 int64 on the host),
    # B, H, KV, Lq, Lk, hd, causal, window, dtype, stream
    "rt_flash_attention": [_P] * 5 + [_I] * 9 + [_P],
    # the launches the entry points above would make, described (no
    # kernel runs): the same shape arguments, then an int64 out array of
    # INFO_FIELDS a launch (csrc/common.cuh: rt::describe)
    "rt_lora_shrink_info": [_I] * 9 + [_P],
    # out: the persistent shrink's phase stamps (measurement only)
    "rt_lora_shrink_stamps": [_P],
    "rt_lora_expand_info": [_I] * 7 + [_P],
    # B, H, KV, ps, hd, W, nsplit, dtype: the attention kernel, then the
    # combine with nsplit > 1
    "rt_paged_attention_info": [_I] * 8 + [_P],
    # B, H, Lq, Lk, hd, causal, window, dtype
    "rt_flash_attention_info": [_I] * 8 + [_P],
    # Lq, Lk, hd, causal, window, out (ceil(Lq / 128) int32): the bf16
    # kernel's query-tile order (kernels/flash.py: tile_order)
    "rt_flash_attention_order": [_I] * 5 + [_P],
    # device, out: csrc/device.cu
    "rt_device_limits": [_I, _P],
    # pdl, blocks, cluster, stream: an empty kernel (csrc/device.cu,
    # measurement only)
    "rt_empty": [_I, _I, _I, _P],
    # out, rows, cols, tma, blocks, stream: a store-only kernel
    # (csrc/device.cu, measurement only)
    "rt_store_probe": [_P, _I, _I, _I, _I, _P],
    # x, rows, cols, blocks, stages, stream: a load-only kernel
    # (csrc/device.cu, measurement only)
    "rt_load_probe": [_P, _I, _I, _I, _I, _P],
    # graph (cudaGraph_t), out: nodes, edges, programmatic edges
    "rt_graph_edges": [_P, _P],
}
# rt::describe's fields, in order
INFO_FIELDS = ("grid_x", "grid_y", "grid_z", "threads", "dyn_smem",
               "registers", "static_smem", "local_bytes",
               "max_threads_per_block", "blocks_per_sm", "cluster",
               "max_clusters")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None    # set by the build that ran
build_log: str = ""                      # nvcc's report of the library loaded


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


def log_path(lib_path: Path) -> Path:
    """Where the build of `lib_path` keeps nvcc's report."""
    return lib_path.with_suffix(".log")


def _build(out: Path) -> None:
    global build_seconds, build_log
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
        report = "\n".join(f"--- {cu.name}\n{log}"
                           for cu, log in zip(cus, logs))
        # the report first: a library on disk always has its report
        tmp_log = Path(tmp) / log_path(out).name
        tmp_log.write_text(report)
        os.replace(tmp_log, log_path(out))
        os.replace(tmp_so, out)
    build_seconds = time.perf_counter() - t0
    build_log = report


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            path = library_path()
            if not (path.exists() and log_path(path).exists()):
                _build(path)
            else:
                build_log = log_path(path).read_text()
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
            device=None, contiguous=True) -> None:
    """Raise unless `t` is a CUDA tensor the kernel takes (contiguous,
    unless the kernel reads it through its strides)."""
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
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_aligned(t: torch.Tensor, name: str) -> None:
    """The kernels read this operand in 16-byte vectors."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
