"""Device selection for the port's entry points, and the pinned upload
of host-built arrays.

`device=None` means the card. The entry points never fall back to the
CPU silently: a caller that wants the CPU (the tests) says so."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(arr, device: torch.device,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A host-built array or tensor (token ids, positions, slots, page
    ids, adapter weights) onto the device: staged through pinned host
    memory and copied with non_blocking=True on the current stream, so
    the host never waits for it. Into `out` in place where given (a
    buffer a captured step reads keeps its storage), else into a new
    tensor. The pinned stage goes back to PyTorch's host allocator,
    which reuses it only once the copy ran."""
    src = arr if torch.is_tensor(arr) \
        else torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        src = src.pin_memory()
    if out is None:
        out = torch.empty(src.shape, dtype=src.dtype, device=device)
    return out.copy_(src, non_blocking=True)
