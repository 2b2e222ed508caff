"""The port's dry run (repro_torch.launch.dryrun, launch.mesh) against the
reference's: importing the mesh module touches no process group and no
CUDA state; the reference test's three combos give the same status and
chips (in a process of their own, which starts its fake process group);
and for several (arch x shape x mesh) combos the analytic input bytes a
chip holds and MODEL_FLOPS equal the reference's, computed from its
abstract_params / input_specs / pool_abstract and its logical_to_physical
on a duck-typed mesh, with nothing compiled."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import roofline as jroof  # noqa: E402
from repro import sharding as jshd  # noqa: E402
from repro.configs.base import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.launch import dryrun as jdry  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.param import split as jsplit  # noqa: E402
from repro_torch import roofline as troof  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


class Pod:
    axis_names = ("data", "model")

    class devices:
        shape = (16, 16)


class MultiPod:
    axis_names = ("pod", "data", "model")

    class devices:
        shape = (2, 16, 16)


COMBOS = [("llama2-7b", "train_4k", Pod, ()),
          ("yi-9b", "prefill_32k", MultiPod, ()),
          ("dbrx-132b", "decode_32k", Pod, ("moe_ep",)),
          ("grok-1-314b", "train_4k", Pod, ("moe_ep",)),
          ("mistral-large-123b", "decode_32k", Pod, ("serve_tp",)),
          ("whisper-tiny", "prefill_32k", Pod, ()),
          ("mamba2-130m", "long_500k", MultiPod, ()),
          ("recurrentgemma-2b", "decode_32k", MultiPod, ("kv8",)),
          ("phi-3-vision-4.2b", "train_4k", MultiPod, ())]


def _leaf_bytes(shapes, axes, mesh, rules=None):
    """The reference's analytic_bytes_per_chip over one input tree."""
    leaves = jax.tree.leaves(shapes)
    specs = jax.tree.leaves(axes, is_leaf=jshd_is_axes)
    assert len(leaves) == len(specs)
    total = 0.0
    for leaf, ax in zip(leaves, specs):
        spec = jshd.logical_to_physical(ax, leaf.shape, mesh, rules)
        shards = 1
        sizes = jshd.mesh_axis_sizes(mesh)
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else
                      (entry,) if entry else ()):
                shards *= sizes[a]
        total += int(np.prod(leaf.shape)) * jnp.dtype(leaf.dtype).itemsize \
            / shards
    return total


def jshd_is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _reference_bytes(cfg, shape, mesh):
    """The inputs the reference's build_train / build_prefill /
    build_decode hold, over their shardings."""
    rules = jshd.serve_rules() if cfg.serve_tp else None
    p_shapes, p_axes = jmodel.abstract_params(cfg)
    specs = jmodel.input_specs(cfg, shape)
    B = shape.global_batch
    if shape.kind == "train":
        mom = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            s.shape, jnp.dtype(cfg.opt_moments_dtype)), p_shapes)
        return (_leaf_bytes(p_shapes, p_axes, mesh)
                + 2 * _leaf_bytes(mom, p_axes, mesh) + 4
                + _leaf_bytes(specs["batch"],
                              jmodel.batch_logical_axes(specs["batch"]),
                              mesh))
    pool_shapes, pool_axes = jsplit(jlora.pool_abstract(cfg))
    idx = jax.ShapeDtypeStruct((B,), jnp.int32)
    total = _leaf_bytes(p_shapes, p_axes, mesh, rules) \
        + _leaf_bytes(pool_shapes, pool_axes, mesh, rules) \
        + _leaf_bytes(idx, ("batch",), mesh)
    if shape.kind == "prefill":
        return total + _leaf_bytes(specs["batch"], jmodel.batch_logical_axes(
            specs["batch"]), mesh)
    return total + _leaf_bytes(
        specs["cache"], jmodel.cache_logical_axes(cfg, specs["cache"]),
        mesh) + _leaf_bytes(specs["tokens_t"], ("batch", None), mesh) \
        + _leaf_bytes(specs["pos"], ("batch",), mesh)


@pytest.mark.parametrize("arch,shape,mesh,opts", COMBOS,
                         ids=[f"{a}-{s}-{m.__name__}{'-' if o else ''}"
                              f"{'+'.join(o)}" for a, s, m, o in COMBOS])
def test_analytic_bytes_and_model_flops_equal_the_reference(arch, shape,
                                                            mesh, opts):
    cj = jdry.apply_opts(jget(arch), opts)
    ct = tdry.apply_opts(tget(arch), opts)
    want = _reference_bytes(cj, J_SHAPES[shape], mesh())
    got = tdry.analytic_bytes(ct, INPUT_SHAPES[shape], mesh())
    assert got == pytest.approx(want, rel=1e-12)
    assert troof.model_flops(ct, INPUT_SHAPES[shape]) == \
        jroof.model_flops(cj, J_SHAPES[shape])


def test_mesh_functions_do_not_touch_devices_on_import():
    code = ("import torch, torch.distributed as dist\n"
            "import repro_torch.launch.mesh as m\n"
            "assert not dist.is_initialized()\n"
            "assert not torch.cuda.is_initialized()\n"
            "try:\n"
            "    m.make_debug_mesh(2, 2, device_type='cpu')\n"
            "except RuntimeError as e:\n"
            "    assert 'ranks' in str(e)\n"
            "else:\n"
            "    raise AssertionError('a mesh without a process group')\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]


SCRIPT = r"""
import json
from repro_torch.launch.dryrun import run_combo
rec = run_combo("whisper-tiny", "decode_32k", multi_pod=False)
print("REC=" + json.dumps({k: rec[k] for k in
      ("status", "chips", "fits_80g", "scan_corrected", "bytes_per_chip",
       "analytic_input_bytes_per_chip")}))
rec2 = run_combo("mamba2-130m", "long_500k", multi_pod=True)
print("REC2=" + json.dumps({k: rec2[k] for k in ("status", "chips")}))
rec3 = run_combo("whisper-tiny", "long_500k", multi_pod=False)
print("REC3=" + json.dumps({k: rec3[k] for k in ("status",)}))
"""


def test_dryrun_machinery_subprocess():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = {}
    for line in out.stdout.splitlines():
        if line.startswith("REC"):
            key, payload = line.split("=", 1)
            recs[key] = json.loads(payload)
    assert recs["REC"]["status"] == "ok"
    assert recs["REC"]["chips"] == 256
    assert recs["REC"]["scan_corrected"]
    assert recs["REC"]["fits_80g"]
    # a rank holds at least its inputs at the peak
    assert recs["REC"]["bytes_per_chip"] >= \
        recs["REC"]["analytic_input_bytes_per_chip"]
    assert recs["REC2"]["status"] == "ok"      # multi-pod: 512 ranks
    assert recs["REC2"]["chips"] == 512
    assert recs["REC3"]["status"] == "skipped"  # the documented skip
