"""The port's logical axes (models.model.abstract_params, input_specs,
cache_logical_axes, batch_logical_axes; core.lora.pool_abstract) against
the reference's, for every registered config: equal axes and shapes, with
the two recorded layout differences mapped: a uniform stack's layers are
a list in the port, each leaf without the reference's leading "layers"
axis; the LoRA pool's rank axis is padded_rank(max_rank) wide."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs.base import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.param import split as jsplit  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import lora as tlora  # noqa: E402
from repro_torch.kernels.bgmv import padded_rank  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.param import split as tsplit  # noqa: E402

CONFIGS = sorted(p.stem.replace("_", "-").replace("4-2b", "4.2b")
                 for p in (Path(__file__).resolve().parents[1] / "src" /
                           "repro_torch" / "configs").glob("*_*.py")
                 if not p.stem.startswith("_"))
# the EP-native layout (grok: 2 f-slices an expert on 16 shards; dbrx: 1)
# and the FSDP weight axes, at full width
FULL = [("dbrx-132b", {"moe_ep": True}), ("grok-1-314b", {"moe_ep": True}),
        ("grok-1-314b", {}), ("mistral-large-123b", {}),
        ("whisper-tiny", {}), ("recurrentgemma-2b", {}),
        ("mamba2-130m", {})]


def _pair(arch, smoke, **kw):
    cj, ct = jget(arch), tget(arch)
    if smoke:
        cj, ct = cj.smoke(), ct.smoke()
    return dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw)


def _unstack(cfg, tree, strip):
    """The reference's tree in the port's layout: a uniform stack's
    blocks as a list, `strip` applied to each of their leaves."""
    tree = dict(tree)
    if isinstance(tree.get("blocks"), dict):
        tree["blocks"] = [
            jax.tree.map(strip, tree["blocks"],
                         is_leaf=lambda x: isinstance(x, tuple))
            for _ in range(cfg.n_layers)]
    return tree


def _drop_layers(axes):
    assert axes[0] == "layers", axes
    return axes[1:]


def _shapes(tree):
    return jax.tree.map(lambda v: tuple(v.shape), tree)


def _tshapes(tree):
    if isinstance(tree, dict):
        return {k: _tshapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tshapes(v) for v in tree]
    return tuple(tree.shape)


def _check_params(cj, ct):
    jv, ja = jmodel.abstract_params(cj)
    tv, ta = tmodel.abstract_params(ct)
    assert ta == _unstack(cj, ja, _drop_layers)
    assert _tshapes(tv) == _unstack(cj, _shapes(jv), lambda s: s[1:])
    for leaf in jax.tree.leaves(tv):
        assert leaf.device.type == "meta"


def test_every_registered_config_is_covered():
    assert len(CONFIGS) == 13 and "phi-3-vision-4.2b" in CONFIGS


@pytest.mark.parametrize("arch", CONFIGS)
def test_param_axes_equal_the_reference_at_smoke_size(arch):
    _check_params(*_pair(arch, smoke=True))


@pytest.mark.parametrize("arch,kw", FULL,
                         ids=[f"{a}{'-ep' if kw else ''}" for a, kw in FULL])
def test_param_axes_equal_the_reference_at_full_width(arch, kw):
    cj, ct = _pair(arch, smoke=False, **kw)
    _check_params(cj, ct)
    if kw:       # EP-native experts: (E*s, d, f/s) over "experts_ep"
        _, ta = tmodel.abstract_params(ct)
        assert ta["blocks"][0]["moe"]["w1"]["w"] == ("experts_ep", None,
                                                     "mlp")


@pytest.mark.parametrize("arch", CONFIGS)
def test_cache_batch_and_pool_axes_equal_the_reference(arch):
    cj, ct = _pair(arch, smoke=True)
    for name, shape in INPUT_SHAPES.items():
        js, ts = jmodel.input_specs(cj, J_SHAPES[name]), \
            tmodel.input_specs(ct, shape)
        assert sorted(js) == sorted(ts)
        if shape.kind == "decode":
            jc, tc = js["cache"], ts["cache"]
            assert tmodel.cache_logical_axes(ct, tc) == \
                jmodel.cache_logical_axes(cj, jc)
            assert _tshapes(tc) == _shapes(jc)
            assert tuple(ts["tokens_t"].shape) == js["tokens_t"].shape
        else:
            assert tmodel.batch_logical_axes(ts["batch"]) == \
                jmodel.batch_logical_axes(js["batch"])
            assert _tshapes(ts["batch"]) == _shapes(js["batch"])
            for k, v in ts["batch"].items():
                assert str(v.dtype).split(".")[-1] == str(
                    js["batch"][k].dtype), k
    jv, ja = jsplit(jlora.pool_abstract(cj))
    tv, ta = tsplit(tlora.pool_abstract(ct))
    assert ta == ja
    r, r_pad = cj.lora.max_rank, padded_rank(ct.lora.max_rank)

    def padded(path, s):
        leaf = path[-1].key
        if leaf == "a":
            return s[:-1] + (r_pad if s[-1] == r else s[-1],)
        if leaf == "b":
            return s[:2] + (r_pad,) + s[3:]
        return s

    want = jax.tree_util.tree_map_with_path(padded, _shapes(jv),
                                            is_leaf=lambda x: isinstance(
                                                x, tuple))
    assert _tshapes(tv) == want
    pool = tlora.pool_init(ct, device="cpu")
    assert _tshapes(pool) == want
    assert all(float(np.abs(t.numpy()).max()) == 0
               for t in jax.tree.leaves(pool))


@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b"])
def test_params_from_jax_takes_the_ep_native_layout(arch):
    """A reference moe_ep tree ((E*s, d, f/s) experts; s = 4 f-slices an
    expert at smoke size over 16 shards) comes across leaf for leaf, and
    the port's own init draws the same layout."""
    from repro_torch.models.weights import init_params, params_from_jax
    cj, ct = _pair(arch, smoke=True, moe_ep=True)
    vals = jsplit(jmodel.init_params(cj, jax.random.PRNGKey(0)))[0]
    pt = params_from_jax(ct, jax.tree.map(np.asarray, vals), device="cpu")
    E, s = ct.moe.n_experts, ct.moe_ep_shards // ct.moe.n_experts
    for i, blk in enumerate(pt.blocks):
        for n in ("w1", "w2", "w3"):
            w = getattr(blk.moe, n).w
            np.testing.assert_array_equal(
                w.numpy(), np.asarray(vals["blocks"]["moe"][n]["w"][i]))
        assert tuple(blk.moe.w1.w.shape) == (E * s, ct.d_model, ct.d_ff // s)
    own = init_params(ct, 0, "cpu")
    assert own.blocks[0].moe.w2.w.shape == pt.blocks[0].moe.w2.w.shape
