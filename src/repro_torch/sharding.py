"""Logical-axis sharding over a `DeviceMesh`: parameters, caches, pools
and batches carry logical axis names (`models.param.Box`); rules map them
to mesh axes with a divisibility guard, so every config lays out on every
mesh. Mirrors `repro.sharding`.

A spec is a plain tuple with one entry a tensor dim: None (replicated), a
mesh axis name, or a tuple of names (the dim split over several mesh axes,
major first), as the reference's `PartitionSpec`. On a mesh whose
`mesh_dim_names` are the reference's axis names ("pod", "data", "model")
a spec becomes DTensor placements: `Shard(dim)` on every mesh dim the spec
names, `Replicate()` on the others (`placements`); `distribute` and
`redistribute` apply them.

`use_mesh` installs the current mesh (the counterpart of the reference's
`jax_compat.set_mesh`); `transformer.block_apply` consults it for the
expert-parallel MoE.

DTensor has no sharding rule for some of the model's ops (the KV-cache
writes, the MoE dispatch, top-k, the kernels' custom ops), and a rule
that loses the layout for others (GQA attention after its reshapes). A
model function given DTensors runs such a region through `local_call`,
the counterpart of the reference's `shard_map`: its tensors laid out by
logical axes, the function run on each rank's shards, the results put
back together by theirs. Plain tensors never take that path.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Optional, Sequence, Tuple

# Default logical->mesh rules. Order matters for multi-axis entries: batch
# shards over ("pod", "data") when present. "embed_fsdp" is the d_model dim
# of weight matrices under cfg.fsdp_weights (2D sharding).
RULES = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "qkv": ("model",),        # fused head*hd output dim of attention projections
    "mlp": ("model",),        # d_ff
    "embed": (),              # activations/weights d_model: unsharded
    "embed_fsdp": ("data",),  # weight d_model dim under 2D sharding
    "experts": ("data",),     # expert-parallel when divisible
    "experts_ep": ("data",),  # EP-native weight layout (moe_ep)
    "seq": (),                # sequence: unsharded by default
    "cache_seq": ("model",),  # long KV caches: sequence over model
    "lora_rank": (),
    "lora_in": ("model",),    # LoRA A's d_in dim
    "slots": (),
    "layers": (),             # a stacked layer dim
    "mlp_fsdp": ("data", "model"),  # MoE expert d_ff under 2D sharding
    "state": (),              # SSM state dim
    None: (),
}

_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` or of a duck-typed mesh with
    `axis_names` and `devices.shape` (the reference tests' fake mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh_axis_sizes(mesh))


def logical_to_physical(logical_axes: Sequence[Optional[str]],
                        shape: Sequence[int], mesh,
                        rules: Optional[dict] = None) -> tuple:
    """Map logical axes to a spec, pruning mesh axes that do not divide
    the dim or that an earlier dim took."""
    rules = rules or RULES
    sizes = mesh_axis_sizes(mesh)
    if len(logical_axes) != len(shape):
        raise ValueError(
            f"rank mismatch: axes {logical_axes} vs shape {shape}")
    spec = []
    used = set()
    for ax, dim in zip(logical_axes, shape):
        picked = []
        prod = 1
        for m in rules.get(ax, ()):
            if m not in sizes or m in used:
                continue
            if dim % (prod * sizes[m]) == 0:
                picked.append(m)
                prod *= sizes[m]
        used.update(picked)
        spec.append(None if not picked else
                    picked[0] if len(picked) == 1 else tuple(picked))
    return tuple(spec)


def serve_rules() -> dict:
    """Inference sharding: weights TP-only (replicated over data), since
    without optimizer state FSDP weight gathers are pure waste."""
    r = dict(RULES)
    r["embed_fsdp"] = ()
    r["mlp_fsdp"] = ("model",)
    return r


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes used for data parallelism (pod + data when multi-pod)."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_count(spec, mesh) -> int:
    """How many pieces a spec cuts a tensor into."""
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[ax] for entry in spec for ax in spec_axes(entry))


# ------------------------------------------------------------- DTensor ----

def placements(spec, mesh) -> list:
    """A spec as DTensor placements on `mesh` (a `DeviceMesh` named with
    the reference's axis names): Shard(dim) on each mesh dim the spec
    names at `dim`, Replicate() elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for dim, entry in enumerate(spec):
        for ax in spec_axes(entry):
            out[mesh.mesh_dim_names.index(ax)] = Shard(dim)
    return out


def placements_for(mesh, logical_axes, shape, rules=None) -> list:
    """The counterpart of the reference's `named_sharding`."""
    return placements(logical_to_physical(logical_axes, shape, mesh, rules),
                      mesh)


def is_axes(x) -> bool:
    """True for a logical-axes tuple (a leaf of an axes tree)."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_specs(mesh, axes_tree, shapes_tree, rules=None):
    """Zip an axes tree with a tree of tensors (or shapes) of the same
    structure -> a tree of specs (the counterpart of `tree_shardings`)."""
    if is_axes(axes_tree):
        shape = getattr(shapes_tree, "shape", shapes_tree)
        return logical_to_physical(axes_tree, tuple(shape), mesh, rules)
    if isinstance(axes_tree, dict):
        return {k: tree_specs(mesh, axes_tree[k], shapes_tree[k], rules)
                for k in axes_tree}
    return [tree_specs(mesh, a, s, rules)
            for a, s in zip(axes_tree, shapes_tree)]


def distribute(tree, axes_tree, mesh, rules=None):
    """Every tensor of `tree` (dicts and lists) as a DTensor laid out by
    its logical axes; a tensor's values are those of the global tensor."""
    from torch.distributed.tensor import distribute_tensor
    if is_axes(axes_tree):
        return distribute_tensor(
            tree, mesh, placements_for(mesh, axes_tree, tree.shape, rules))
    if isinstance(axes_tree, dict):
        return {k: distribute(tree[k], axes_tree[k], mesh, rules)
                for k in axes_tree}
    return [distribute(t, a, mesh, rules) for t, a in zip(tree, axes_tree)]


def distribute_empty(meta_tree, axes_tree, mesh, rules=None):
    """DTensors of `meta_tree`'s shapes and dtypes laid out by their
    logical axes, each rank's shard allocated on its own (uninitialized;
    under `FakeTensorMode`, not at all): the counterpart of a
    `ShapeDtypeStruct` with a sharding. The divisibility guard makes every
    shard equal."""
    import torch
    from torch.distributed.tensor import DTensor
    if is_axes(axes_tree):
        spec = logical_to_physical(axes_tree, tuple(meta_tree.shape), mesh,
                                   rules)
        sizes = mesh_axis_sizes(mesh)
        local = [n // math.prod(sizes[a] for a in spec_axes(e))
                 for n, e in zip(meta_tree.shape, spec)]
        return DTensor.from_local(
            torch.empty(local, dtype=meta_tree.dtype), mesh,
            placements(spec, mesh), run_check=False,
            shape=meta_tree.shape, stride=meta_tree.stride())
    if isinstance(axes_tree, dict):
        return {k: distribute_empty(meta_tree[k], axes_tree[k], mesh, rules)
                for k in axes_tree}
    return [distribute_empty(t, a, mesh, rules)
            for t, a in zip(meta_tree, axes_tree)]


def constrain(x, *logical_axes):
    """A DTensor moved to the layout of its logical axes (on its own mesh);
    a plain tensor as it is. The model pins its residual stream with it,
    so a sum over "model" is taken where the reference's GSPMD takes it."""
    if not is_dtensor(x):
        return x
    return redistribute(x, x.device_mesh, *logical_axes)


def take_layer(t, i: int):
    """t[i] of a tensor stacked on an uncut leading layer axis. On a
    DTensor it is taken from each rank's shard (DTensor's own select
    gathers the whole stack first)."""
    if not is_dtensor(t):
        return t[i]
    from torch.distributed.tensor import DTensor, Shard
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p
          for p in t.placements]
    if any(isinstance(p, Shard) and p.dim < 0 for p in pl):
        raise ValueError("the layer axis of a stack must not be cut")
    return DTensor.from_local(t.to_local()[i], t.device_mesh, pl,
                              run_check=False, shape=t.shape[1:],
                              stride=t.stride()[1:])


def like(x, ref):
    """x laid out as the DTensor `ref` is (a gradient as its parameter: a
    partial sum becomes a reduce-scatter); plain tensors as they are."""
    if not is_dtensor(x):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def redistribute(x, mesh, *logical_axes, rules=None):
    """A DTensor moved to the layout its logical axes give (the
    counterpart of the reference's `constrain`)."""
    return x.redistribute(mesh, placements_for(mesh, logical_axes, x.shape,
                                               rules))


# --------------------------------------------------------- current mesh ----

@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` the current mesh inside the block; with a mesh, a plain
    tensor meeting a DTensor there is taken as replicated on it (the
    model's position and RoPE tables)."""
    token = _MESH.set(mesh)
    try:
        if mesh is None:
            yield mesh
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh `use_mesh` installed, or None."""
    return _MESH.get()


# -------------------------------------------------------- local regions ----

@functools.lru_cache(maxsize=None)
def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    """True for a DTensor: the model then runs its regions through
    `local_call`; plain tensors take the model's own path."""
    return type(x) is _dtensor_type()


def _named_dims(axes_tree, args):
    """(logical name, dim size) of every named dim of the call's tensors."""
    if axes_tree is None:
        return []
    if is_axes(axes_tree):
        return [(n, d) for n, d in zip(axes_tree, args.shape)
                if n is not None]
    if isinstance(axes_tree, dict):
        return [p for k in axes_tree
                for p in _named_dims(axes_tree[k], args[k])]
    return [p for a, t in zip(axes_tree, args) for p in _named_dims(a, t)]


def decide(axes_tree, args, mesh, rules=None) -> dict:
    """{logical name: mesh axes} for one region: each name, in order of
    first appearance, takes its rule's mesh axes that divide every dim it
    names and that no earlier name took, so the region's tensors are cut
    consistently (a GQA group's query and key heads alike)."""
    rules = rules or RULES
    sizes = mesh_axis_sizes(mesh)
    dims: dict = {}
    for n, d in _named_dims(axes_tree, args):
        dims.setdefault(n, []).append(d)
    used, out = set(), {}
    for n, ds in dims.items():
        picked, prod = [], 1
        for m in rules.get(n, ()):
            if m in sizes and m not in used and \
                    all(d % (prod * sizes[m]) == 0 for d in ds):
                picked.append(m)
                prod *= sizes[m]
        used.update(picked)
        out[n] = tuple(picked)
    return out


def _spec(axes, placed):
    return tuple(None if not placed.get(n) else
                 placed[n][0] if len(placed[n]) == 1 else placed[n]
                 for n in axes)


def as_dtensor(t, mesh):
    """A DTensor as it is; a plain tensor every rank holds whole as a
    DTensor replicated over `mesh`."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _to_local(t, axes, placed, mesh):
    from torch.distributed.tensor import Partial
    if axes is None:
        return t
    if is_axes(axes):
        t = as_dtensor(t, mesh)
        pl = placements(_spec(axes, placed), mesh)
        # a tensor without the batch dim, used on each rank's rows: its
        # gradient is the sum of the ranks' over the batch's mesh axes
        grad = [Partial() if "batch" not in axes and
                mesh.mesh_dim_names[i] in placed.get("batch", ()) else p
                for i, p in enumerate(pl)]
        return t.redistribute(mesh, pl).to_local(grad_placements=grad)
    if isinstance(axes, dict):
        return {k: _to_local(t[k], axes[k], placed, mesh) for k in axes}
    return [_to_local(x, a, placed, mesh) for x, a in zip(t, axes)]


def _from_local(t, axes, placed, mesh):
    from torch.distributed.tensor import DTensor
    if axes is None:
        return t
    if is_axes(axes):
        return DTensor.from_local(t, mesh, placements(_spec(axes, placed),
                                                      mesh), run_check=False)
    if isinstance(axes, dict):
        return {k: _from_local(t[k], axes[k], placed, mesh) for k in axes}
    return type(t)(_from_local(x, a, placed, mesh) for x, a in zip(t, axes))


def local_call(fn, args, in_axes, out_axes, mesh=None, rules=None):
    """fn(placed, *local args) on this rank's shards: `args` (DTensors, or
    plain tensors every rank holds whole) laid out by `in_axes` (one
    logical-axes tuple a tensor, dicts and lists of them, or None for an
    argument passed as it is) with the cut `decide` makes, and the results
    put back together by `out_axes`, cut the same way. `placed` ({name:
    mesh axes}) tells fn which mesh axes hold its tensors' named dims,
    for the collectives it runs over them."""
    mesh = mesh or current_mesh()
    placed = decide(list(in_axes), list(args), mesh, rules)
    local = [_to_local(t, a, placed, mesh) for t, a in zip(args, in_axes)]
    return _from_local(fn(placed, *local), out_axes, placed, mesh)


def write_back(dst, src):
    """After a region wrote into its shards of the DTensors `dst` (dicts
    of them), with its results `src`: a leaf the region took in another
    layout was a copy, so its new values are put back into `dst`."""
    for n, t in dst.items():
        if src[n].placements != t.placements:
            t.copy_(src[n].redistribute(t.device_mesh, t.placements))


def group_of(mesh, axes):
    """The process group over `axes` of `mesh` (one axis, or several
    flattened major first)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[tuple(axes)]._flatten().get_group()


def sum_over(t, group, scale=1.0):
    """The sum (times `scale`) over `group`'s ranks of per-rank partial
    values. The result is replicated over the group, so each partial's
    gradient is the result's (times `scale`)."""
    return _sum_fn().apply(t, group, scale)


def enter_sliced(t, group):
    """Identity on a value every rank of `group` holds whole, entering a
    computation cut over the group: its gradient is summed over it."""
    return _enter_fn().apply(t, group)


def max_over(t, group):
    """The elementwise max over `group`'s ranks (no gradient)."""
    import torch.distributed._functional_collectives as fc
    return fc.wait_tensor(fc.all_reduce(t, "max", group))


@functools.lru_cache(maxsize=None)
def _sum_fn():
    import torch
    import torch.distributed._functional_collectives as fc

    class SumOver(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, group, scale):
            ctx.scale = scale
            return fc.wait_tensor(fc.all_reduce(t, "sum", group)) * scale

        @staticmethod
        def backward(ctx, g):
            return g * ctx.scale, None, None

    return SumOver


@functools.lru_cache(maxsize=None)
def _enter_fn():
    import torch
    import torch.distributed._functional_collectives as fc

    class EnterSliced(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, group):
            ctx.group = group
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return fc.wait_tensor(fc.all_reduce(g, "sum", ctx.group)), None

    return EnterSliced


def coordinate(mesh, axes) -> int:
    """This rank's index along `axes` of `mesh` (flattened major first)."""
    sizes = mesh_axis_sizes(mesh)
    c = 0
    for a in axes:
        c = c * sizes[a] + mesh.get_local_rank(a)
    return c
