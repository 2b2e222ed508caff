"""Trees of tensors (nested dicts, lists and tuples), flattened in JAX's
order: dict keys sorted, lists and tuples (a NamedTuple such as
`optim.AdamWState` included) in order, None an empty subtree. The
optimizer state and the checkpoints are such trees, so a tree the port
writes lines up leaf for leaf with the reference's pytree of the same
structure."""
from __future__ import annotations

from typing import Any, Callable, List

from torch import nn


def leaves(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def paths(tree, prefix="") -> List[str]:
    """Each leaf's dotted path, in leaf order (`blocks.3.attn.wq.w`)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in paths(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


def unflatten(like, flat) -> Any:
    """A tree of `like`'s structure holding the leaves `flat` in order."""
    it = iter(flat)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def map_(fn: Callable, tree, *rest) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    cols = [leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError(f"tree map: leaf counts differ "
                         f"{[len(c) for c in cols]}")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def param_tree(module: nn.Module):
    """The parameters of the port's model as the reference's value tree:
    the modules' attribute names are the reference's leaf names, and the
    layers a list (the reference stacks a uniform stack's layers on a
    leading axis instead)."""
    if isinstance(module, nn.ModuleList):
        return [param_tree(m) for m in module]
    out = {n: p for n, p in module._parameters.items() if p is not None}
    out.update({n: param_tree(m) for n, m in module._modules.items()
                if m is not None})
    return out
