"""The port's expert-parallel MoE (repro_torch.models.moe_ep) against the
reference's: `ep_factors` and `shard_expert_weights` on the same numpy
weights, and `moe_apply_ep` on gloo meshes (4, 2), (2, 2) and (8, 1) with
the reference test's (E, top-k) cases against the reference's `moe_apply`
on the same numpy inputs, within 1e-5 of max |reference| (the reference
test's own bound); every gradient (tokens, router, w1, w2, w3) is held to
the port's single-device `moe_apply`'s within 1e-5 x max(1, max |grad|)
(f32, other summation orders). The ranks are processes of their own over
a FileStore, started by the test, since a default process group is
global to its process."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import moe_ep as jep  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.models import moe_ep as tep  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402
from repro_torch.models.param import Dense  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
# (mesh (data, model), E, top-k): the reference test's cases, by world size
CASES = {8: [((4, 2), 4, 2), ((4, 2), 2, 1), ((8, 1), 4, 2)],
         4: [((2, 2), 4, 2)]}
TOL = 1e-5

RANK = r"""
import dataclasses, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, data = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch.configs.base import MoEConfig, get_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.moe_ep import moe_apply_ep
from repro_torch.models.param import Dense
z = np.load(data)
out = {}
for i in range(int(z["n"])):
    dn, mn, E, k = (int(v) for v in z[f"case{i}"])
    mesh = make_debug_mesh(dn, mn, device_type="cpu")
    cfg = dataclasses.replace(get_config("dbrx-132b").smoke(),
                              moe=MoEConfig(E, k, capacity_factor=E * 2.0))
    x0 = z[f"x{i}"]
    def run(ep):
        p = MoE(*(Dense(torch.from_numpy(z[f"{n}{i}"]))
                  for n in ("router", "w1", "w2", "w3")))
        leaves = {n: getattr(p, n).w.requires_grad_(True)
                  for n in ("router", "w1", "w2", "w3")}
        x = torch.from_numpy(x0).requires_grad_(True)
        if ep:
            y, _ = moe_apply_ep(cfg, p, x, mesh)
        else:   # one group of every token, as the reference test's
            y = moe_apply(cfg, p, x.reshape(1, -1, x.shape[-1]))[0]
            y = y.reshape(x.shape)
        (y * torch.from_numpy(z[f"c{i}"])).sum().backward()
        return y.detach(), {"x": x.grad, **{n: t.grad for n, t in leaves.items()}}
    y, g = run(True)
    _, g_ref = run(False)
    out[f"y{i}"] = y.numpy()
    for n in g:
        lim = max(1.0, float(g_ref[n].abs().max()))
        out[f"gerr{i}_{n}"] = np.float64((g[n] - g_ref[n]).abs().max() / lim)
np.savez(data.replace(".npz", f"_rank{rank}.npz"), **out)
dist.destroy_process_group()
"""


def _launch(script, world, args, tmp_path, timeout=240):
    """Run `script` as `world` processes (ranks 0..world-1) over a
    FileStore in tmp_path; fails with the first failing rank's stderr."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), store, *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return [o for o, _ in outs]


def _reference_case(i, mesh_shape, E, k):
    """The reference test's inputs for one case (numpy, f32), its
    moe_apply output, and a fixed cotangent."""
    cfg = dataclasses.replace(jget("dbrx-132b").smoke(),
                              moe=JMoE(E, k, capacity_factor=float(E) * 2))
    p = jax.tree.map(lambda b: np.asarray(b.value, np.float32),
                     jmoe.moe_init(cfg, jax.random.PRNGKey(i)),
                     is_leaf=lambda b: hasattr(b, "axes"))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(100 + i),
                                     (4, 8, cfg.d_model)), np.float32)
    want, _ = jmoe.moe_apply(cfg, jax.tree.map(jnp.asarray, p),
                             jnp.asarray(x), group_by_sequence=False)
    c = np.random.default_rng(i).normal(size=x.shape).astype(np.float32)
    return {f"case{i}": np.array([*mesh_shape, E, k]), f"x{i}": x,
            f"c{i}": c, **{f"{n}{i}": p[n]["w"]
                           for n in ("router", "w1", "w2", "w3")}}, \
        np.asarray(want)


def test_ep_factors_equal_the_reference():
    for E, n in ((8, 16), (16, 16), (4, 2), (4, 8), (2, 4), (16, 32),
                 (4, 1)):
        assert tep.ep_factors(E, n) == jep.ep_factors(E, n)
    assert tep.ep_factors(8, 16) == (2, 1)      # grok on the production mesh
    assert tep.ep_factors(16, 16) == (1, 1)     # dbrx
    assert tep.ep_factors(4, 2) == (1, 2)       # smoke
    for E, n in ((6, 16), (4, 3)):
        with pytest.raises(ValueError):
            tep.ep_factors(E, n)


@pytest.mark.parametrize("E,n_data", [(8, 16), (4, 2), (4, 8), (2, 4)])
def test_shard_expert_weights_equal_the_reference(E, n_data):
    cj = dataclasses.replace(jget("grok-1-314b").smoke(), moe=JMoE(E, 2))
    ct = dataclasses.replace(tget("grok-1-314b").smoke(),
                             moe=cj.moe.__class__(E, 2))
    rng = np.random.default_rng(E * n_data)
    d, f = ct.d_model, ct.d_ff
    w = {"router": rng.normal(size=(d, E)), "w1": rng.normal(size=(E, d, f)),
         "w2": rng.normal(size=(E, f, d)), "w3": rng.normal(size=(E, d, f))}
    w = {n: v.astype(np.float32) for n, v in w.items()}
    want = jep.shard_expert_weights(
        cj, {n: {"w": jnp.asarray(v)} for n, v in w.items()}, n_data)
    got = tep.shard_expert_weights(
        ct, MoE(*(Dense(torch.from_numpy(w[n]))
                  for n in ("router", "w1", "w2", "w3"))), n_data)
    for n in w:
        np.testing.assert_array_equal(got[n].numpy(),
                                      np.asarray(want[n]["w"]))
    # EP-native weights pass as they are
    again = tep.shard_expert_weights(
        ct, MoE(*(Dense(got[n]) for n in ("router", "w1", "w2", "w3"))),
        n_data)
    for n in w:
        assert torch.equal(again[n], got[n])


@pytest.mark.parametrize("world", sorted(CASES))
def test_moe_apply_ep_on_gloo_meshes_matches_the_reference(world, tmp_path):
    data, wants = {"n": np.array(len(CASES[world]))}, []
    for i, case in enumerate(CASES[world]):
        arrays, want = _reference_case(i, *case)
        data.update(arrays)
        wants.append(want)
    path = str(tmp_path / "case.npz")
    np.savez(path, **data)
    _launch(RANK, world, [path], tmp_path)
    for r in range(world):
        z = np.load(path.replace(".npz", f"_rank{r}.npz"))
        for i, (case, want) in enumerate(zip(CASES[world], wants)):
            err = np.abs(z[f"y{i}"] - want).max() / (np.abs(want).max()
                                                     + 1e-9)
            assert err < TOL, f"rank {r} {case}: y rel err {err:.2e}"
            for n in ("x", "router", "w1", "w2", "w3"):
                assert z[f"gerr{i}_{n}"] <= TOL, \
                    f"rank {r} {case}: grad {n} {z[f'gerr{i}_{n}']:.2e}"
