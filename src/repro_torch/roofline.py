"""Roofline terms of a dry-run step. Mirrors `repro.roofline`.

Three terms per (arch x shape x mesh), in seconds:
    compute    = FLOPs / (chips * peak FLOP/s)
    memory     = bytes / (chips * HBM bytes/s)
    collective = collective bytes / (chips * link bytes/s)

The defaults are NVIDIA's H100 SXM data-sheet figures that
`core.timing.H100` holds: 989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM,
50e9 B/s a link (NVLink 4, 18 links = 900 GB/s). The dry run
(`launch/dryrun.py`) counts a rank's collective bytes from the
collectives `torch.distributed` runs (`comm_bytes`); the parser of
optimized-HLO text (`collective_bytes`) is the reference's, kept for
parity. Both count an all-reduce twice (its reduce and broadcast
phases) and every other collective at its tensor's size.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple

from repro_torch.core.timing import H100

PEAK_FLOPS = H100.peak_flops
HBM_BW = H100.hbm_bw
LINK_BW = H100.ici_bw

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_ELEM_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Bytes moved per collective kind, from optimized HLO text."""
    out = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        line = line.strip()
        kind = next((k for k in _COLLECTIVES if f" {k}(" in line or
                     line.startswith(k)), None)
        if kind is None:
            continue
        # output shape(s) appear between '=' and the op name
        head = line.split(f" {kind}(")[0]
        elems = _ELEM_RE.findall(head.split("=", 1)[-1])
        size = sum(_shape_bytes(dt, dims) for dt, dims in elems)
        out[kind] += size * (2 if kind == "all-reduce" else 1)
    return out


def comm_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Bytes per collective kind from (kind, tensor bytes) records of the
    collectives a rank ran (the dry run's `CommDebugMode` counter), in
    `collective_bytes`' kinds and convention."""
    out = {k: 0 for k in _COLLECTIVES}
    for kind, nbytes in records:
        out[kind] += nbytes * (2 if kind == "all-reduce" else 1)
    return out


def roofline_terms(flops: float, bytes_hbm: float, coll_bytes: float,
                   chips: int, *, per_device: bool = True,
                   peak=PEAK_FLOPS, bw=HBM_BW, link=LINK_BW):
    """Per-device quantities divide by one chip's rate (numerically the
    total over chips x rate); totals (`per_device=False`) by chips x
    rate."""
    div = 1 if per_device else chips
    t_c = flops / (div * peak)
    t_m = bytes_hbm / (div * bw)
    t_x = coll_bytes / (div * link)
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "dominant": dom}


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N the active
    parameters, D the tokens (decode: one a request)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
