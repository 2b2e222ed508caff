"""The port's logical->physical sharding (repro_torch.sharding) against the
reference's (repro.sharding): every case of tests/test_sharding.py,
its hypothesis properties included, through both packages, giving equal
specs; on a fake process group of 256 ranks (a 16 x 16 DeviceMesh, in a
process of its own) the DTensor placements `distribute` gives cut each
parameter of a full-width config as its spec says; and on a 2 x 2 gloo
mesh (four processes) the model over DTensors laid out by their axes --
the dry run's program -- computes the plain model's prefill and decode
logits, loss and every parameter gradient, family by family (f32: 1e-5
of the largest logit, 1e-4 of each leaf's largest gradient or of 1e-3,
whichever is larger: a key bias's gradient is zero but for rounding,
since the softmax ignores a shift that every key shares)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import sharding as jshd  # noqa: E402
from repro_torch import sharding as tshd  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


class FakeMesh:
    axis_names = ("data", "model")

    class devices:
        shape = (16, 16)


class M3:
    axis_names = ("pod", "data", "model")

    class devices:
        shape = (2, 16, 16)


def both(axes, shape, mesh, rules=None):
    """The two packages' specs for one leaf, which must be equal; the
    port's."""
    want = tuple(jshd.logical_to_physical(axes, shape, mesh, rules))
    got = tshd.logical_to_physical(axes, shape, mesh, rules)
    assert got == want, (axes, shape)
    return got


@pytest.fixture(scope="module")
def mesh():
    return FakeMesh()


def test_prune_non_dividing(mesh):
    # whisper: 6 heads on a 16-way model axis -> pruned
    assert both(("embed", "heads", None), (384, 6, 64), mesh) == \
        (None, None, None)
    # 48 heads divide -> sharded
    assert both(("embed", "heads", None), (6144, 48, 128), mesh) == \
        (None, "model", None)


def test_axis_used_once(mesh):
    # experts takes "data" first; embed_fsdp then cannot reuse it
    assert both(("experts", "embed_fsdp", "mlp"), (16, 6144, 10752),
                mesh) == ("data", None, "model")
    # experts not divisible (8 % 16): embed_fsdp gets data instead
    assert both(("experts", "embed_fsdp", "mlp"), (8, 6144, 32768),
                mesh) == (None, "data", "model")


def test_batch_multi_axis():
    assert both(("batch", None), (256, 4096), M3()) == (("pod", "data"),
                                                        None)
    # batch=1 -> fully pruned
    assert both(("batch", None), (1, 4096), M3()) == (None, None)
    assert tshd.batch_axes(M3()) == jshd.batch_axes(M3()) == ("pod", "data")


def test_serve_rules_and_rank_mismatch(mesh):
    assert tshd.serve_rules() == jshd.serve_rules()
    assert tshd.RULES == jshd.RULES
    rules = tshd.serve_rules()
    assert both(("embed_fsdp", "mlp"), (6144, 10752), mesh, rules) == \
        (None, "model")
    assert both(("experts", "mlp_fsdp", None), (16, 10752, 6144), mesh,
                rules) == ("data", "model", None)
    with pytest.raises(ValueError, match="rank mismatch"):
        tshd.logical_to_physical(("batch",), (4, 4), mesh)


@settings(max_examples=50, deadline=None)
@given(dim=st.integers(1, 4096),
       ax=st.sampled_from(["vocab", "heads", "mlp", "batch", "experts",
                           None, "embed"]))
def test_property_spec_always_divides(mesh, dim, ax):
    entry = both((ax,), (dim,), mesh)[0]
    sizes = tshd.mesh_axis_sizes(mesh)
    assert sizes == jshd.mesh_axis_sizes(mesh)
    if entry is None:
        return
    prod = int(np.prod([sizes[a] for a in tshd.spec_axes(entry)]))
    assert dim % prod == 0


@settings(max_examples=30, deadline=None)
@given(dims=st.lists(st.integers(1, 2048), min_size=1, max_size=4))
def test_property_no_axis_reused(mesh, dims):
    axes = ["mlp", "vocab", "heads", "qkv"][: len(dims)]
    used = [a for e in both(axes, dims, mesh) for a in tshd.spec_axes(e)]
    assert len(used) == len(set(used))


FAKE = r"""
import dataclasses, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
from repro_torch import sharding as shd
from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model
mesh = make_production_mesh(device_type="cpu")
assert shd.mesh_axis_sizes(mesh) == {"data": 16, "model": 16}
n = 0
for arch, kw in (("dbrx-132b", {"moe_ep": True}), ("yi-9b", {}),
                 ("whisper-tiny", {})):
    cfg = dataclasses.replace(get_config(arch), n_layers=1, **kw)
    meta, axes = model.abstract_params(cfg)
    with FakeTensorMode():
        def fake(t):
            if isinstance(t, dict):
                return {k: fake(v) for k, v in t.items()}
            if isinstance(t, list):
                return [fake(v) for v in t]
            return torch.empty(t.shape, dtype=t.dtype)
        dt = shd.distribute(fake(meta), axes, mesh)
    specs = shd.tree_specs(mesh, axes, meta)
    def check(d, s):
        global n
        if isinstance(d, dict):
            return [check(d[k], s[k]) for k in d]
        if isinstance(d, list):
            return [check(a, b) for a, b in zip(d, s)]
        local = list(d.shape)
        for dim, entry in enumerate(s):
            for ax in shd.spec_axes(entry):
                local[dim] //= shd.mesh_axis_sizes(mesh)[ax]
        assert tuple(d.to_local().shape) == tuple(local), (d.shape, s)
        assert d.placements == tuple(shd.placements(s, mesh))
        n += 1
    check(dt, specs)
print("LEAVES", n)
"""


def test_distribute_cuts_as_the_spec_says_on_a_fake_256_rank_group():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", FAKE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split("LEAVES")[-1]) > 30


GLOO = r"""
import dataclasses, json, sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch import sharding as shd
from repro_torch.configs.base import get_config
from repro_torch.core import lora as lora_lib
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model, weights
from repro_torch.models.param import split
from repro_torch.training import tree as tree_lib
mesh = make_debug_mesh(2, 2, device_type="cpu")
B, L = 4, 12
out = {}
for arch, kw in json.loads(sys.argv[4]):
    cfg = dataclasses.replace(get_config(arch).smoke(), **kw)
    if cfg.moe:      # no drop: moe_ep's shards group otherwise
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    vals, axes = split(weights.init_tree(cfg, 0, torch.device("cpu")))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, L), generator=g,
                                     dtype=torch.int32)}
    if cfg.family in ("audio", "encdec"):
        batch["enc_embeds"] = torch.randn(B, cfg.enc_seq, cfg.d_model,
                                          generator=g)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.randn(B, cfg.n_prefix_tokens,
                                             cfg.d_model, generator=g)
    pool = None
    if cfg.family != "ssm" and cfg.family not in ("audio", "encdec"):
        pool = lora_lib.pool_init(cfg, 2, "cpu")
        for name, t in split(lora_lib.pool_abstract(cfg, 2))[0].items():
            if name != "ranks":
                for ab in ("a", "b"):
                    pool[name][ab].normal_(0.0, 0.1, generator=g)
        pool["ranks"][:] = torch.tensor([8, 4], dtype=torch.int32)
    pos = torch.full((B,), L + (cfg.n_prefix_tokens
                                if cfg.family == "vlm" else 0),
                     dtype=torch.int32)
    nxt = batch["tokens"][:, :1].contiguous()
    idx = torch.tensor([0, 1, 0, -1], dtype=torch.int32)

    def run(on_mesh):
        ax = lambda t: ("batch",) + (None,) * (t.dim() - 1)
        put = (lambda t, a: shd.distribute(t, a, mesh)) if on_mesh \
            else (lambda t, a: t)
        p = weights._build(cfg, put(vals, axes) if on_mesh else vals)
        b = {k: put(t, ax(t)) for k, t in batch.items()}
        lora = None if pool is None else {
            "pool": put(pool, split(lora_lib.pool_abstract(cfg, 2))[1]),
            "idx": put(idx, ("batch",)), "mode": "mbgmv"}
        with shd.use_mesh(mesh if on_mesh else None):
            with torch.no_grad():
                lp, cache = model.prefill(cfg, p, b, lora=lora,
                                          cache_slots=L + 8)
                ld, _ = model.decode(cfg, p, cache, put(nxt, ax(nxt)),
                                     put(pos, ("batch",)), lora=lora)
            leaves = tree_lib.leaves(tree_lib.param_tree(p))
            for t in leaves:
                t.requires_grad_(True)
            loss, _ = model.loss(cfg, p, b, aux_weight=0.0)
            gs = torch.autograd.grad(loss, leaves)
        full = lambda t: t.full_tensor() if shd.is_dtensor(t) else t
        return [full(lp), full(ld), full(loss).detach()] + \
            [full(x) for x in gs]

    want, got = run(False), run(True)
    rel = lambda x, y, floor=1e-30: float(
        (x - y).abs().max() / y.abs().max().clamp(min=floor))
    out[arch] = {"prefill": rel(got[0], want[0]),
                 "decode": rel(got[1], want[1]),
                 "loss": rel(got[2], want[2]),
                 "grad": max(rel(x, y, 1e-3)
                             for x, y in zip(got[3:], want[3:]))}
if rank == 0:
    print("OUT=" + json.dumps(out))
dist.destroy_process_group()
"""

MESH_ARCHS = [("llama2-7b", {}),
              ("dbrx-132b", {"moe_ep": True, "moe_ep_shards": 2}),
              ("grok-1-314b", {}), ("mamba2-130m", {}),
              ("recurrentgemma-2b", {}), ("whisper-tiny", {}),
              ("phi-3-vision-4.2b", {"kv_cache_dtype": "int8"})]


def test_the_model_on_a_gloo_mesh_computes_the_plain_model(tmp_path):
    import json
    env = dict(os.environ, PYTHONPATH=str(SRC))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO, str(r), "4", store,
         json.dumps(MESH_ARCHS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    res = json.loads(outs[0][0].split("OUT=")[-1])
    assert sorted(res) == sorted(a for a, _ in MESH_ARCHS)
    for arch, r in res.items():
        for what in ("prefill", "decode", "loss"):
            assert r[what] <= 1e-5, (arch, what, r)
        assert r["grad"] <= 1e-4, (arch, r)
