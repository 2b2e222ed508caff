"""Production and debug meshes over the default process group. Mirrors
`repro.launch.mesh`. Defined as functions, so importing this module
touches no process group and no CUDA state (the dry run starts its fake
group first)."""
from __future__ import annotations

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """Single pod: 16 x 16 = 256 ranks ("data", "model"). Multi-pod:
    2 x 16 x 16 = 512 ("pod", "data", "model"). The first ranks of the
    default group, which must hold enough of them."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return _mesh(shape, POD_AXES if multi_pod else AXES, device_type,
                 "run it under launch/dryrun.py, whose fake group holds 512")


def make_debug_mesh(data: int = 2, model: int = 2, device_type="cuda"):
    """A small ("data", "model") mesh for tests (the first data x model
    ranks)."""
    return _mesh((data, model), AXES, device_type, "start more ranks")


def _mesh(shape, names, device_type, hint):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, the default "
                           f"process group has {have}: {hint}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape).tolist(),
                      mesh_dim_names=names)
