"""Checkpointing: flattened-tree .npz snapshots with a manifest, atomic
writes, and step-indexed retention. Mirrors `repro.training.checkpoint`
and writes its layout: `__manifest__` (JSON: treedef, n_leaves, step,
extra) and `leaf_i` in the tree's leaf order (`training.tree`, JAX's
order), bfloat16 stored as float32 (exact). So a checkpoint of a tree
either package writes, the other loads into the same structure."""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.training import tree as tree_lib


def _describe(tree) -> str:
    """The tree's structure, for the manifest (informational: `load`
    checks only the leaf count and shapes, as the reference's does)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        return name + "(" + ", ".join(_describe(t) for t in tree) + ")"
    return "None" if tree is None else "*"


def _to_np(x) -> np.ndarray:
    t = torch.as_tensor(x).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()                      # npz-safe; exact for bf16
    return t.numpy()


def save(path: str, tree: Any, step: Optional[int] = None,
         extra: Optional[dict] = None):
    """Atomic save of any tree of tensors."""
    leaves = tree_lib.leaves(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"leaf_{i}": _to_np(x) for i, x in enumerate(leaves)}
    manifest = {"treedef": _describe(tree), "n_leaves": len(leaves),
                "step": step, "extra": extra or {}}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    os.close(fd)
    np.savez(tmp, __manifest__=json.dumps(manifest), **payload)
    os.remove(tmp)                       # mkstemp placeholder
    os.replace(tmp + ".npz", path)       # savez appended .npz


def load(path: str, like: Any) -> Tuple[Any, dict]:
    """Restore into the structure of `like`: each leaf takes the dtype
    and device of `like`'s leaf; leaf count and shapes are checked."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        leaves = [z[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    ref_leaves = tree_lib.leaves(like)
    if len(leaves) != len(ref_leaves):
        raise ValueError(
            f"leaf count mismatch: {len(leaves)} != {len(ref_leaves)}")
    out = []
    for got, ref in zip(leaves, ref_leaves):
        if tuple(got.shape) != tuple(ref.shape):
            raise ValueError(
                f"shape mismatch: {got.shape} != {tuple(ref.shape)}")
        out.append(torch.from_numpy(np.array(got)).to(
            ref.device, ref.dtype))
    return tree_lib.unflatten(like, out), manifest


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for f in os.listdir(ckpt_dir):
        if f.startswith("ckpt_") and f.endswith(".npz"):
            try:
                steps.append(int(f[5:-4]))
            except ValueError:
                pass
    return max(steps) if steps else None


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step}.npz")


def retain(ckpt_dir: str, keep: int = 3):
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted([int(f[5:-4]) for f in os.listdir(ckpt_dir)
                    if f.startswith("ckpt_") and f.endswith(".npz")])
    for s in steps[:-keep]:
        os.remove(step_path(ckpt_dir, s))
