"""The port's training path (repro_torch.data, .training, model.loss,
launch.train) against the reference's (repro.data, repro.training,
repro.models.model.loss): the same seeds give the same batches, the same
weights (carried across with `params_from_jax`), adapters
(`adapter_from_jax`) and optimizer states (`opt_state_from_jax`) give the
same losses, gradients and updates. f32 smoke configs; tolerances:
losses rtol 1e-4, gradients 1e-4 x each leaf's max |reference grad|
(other summation orders), AdamW 1e-6, and the reference's own atol 5e-3
for parameters after several Adam steps (Adam's normalisation amplifies
rounding in near-zero gradient entries)."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-sized ops: one intra-op thread avoids oversubscribing the cores the
# reference (XLA) and the other test workers share
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.param import split  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.models.weights import (adapter_from_jax,  # noqa: E402
                                        opt_state_from_jax, params_from_jax)
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.training import train as ttrain  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

LOSS_ARCHS = ["llama2-7b", "yi-9b", "dbrx-132b", "mamba2-130m",
              "recurrentgemma-2b", "phi-3-vision-4.2b"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _both(arch):
    cj, ct = jget(arch).smoke(), tget(arch).smoke()
    pj = split(jmodel.init_params(cj, jax.random.PRNGKey(0)))[0]
    pt = params_from_jax(ct, _np_tree(pj), device="cpu")
    return cj, ct, pj, pt


@pytest.fixture(scope="module")
def llama():
    return _both("llama2-7b")


def _batch(cfg, B=4, L=16, seed=0, prefix=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    mask = (rng.random((B, L)) > 0.2).astype(np.int32)
    out = {"tokens": toks, "loss_mask": mask}
    if prefix:
        out["prefix_embeds"] = rng.normal(
            size=(B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: _t(v) for k, v in out.items()})


def _close_tree(got, want, rel):
    """Each leaf within rel x its max |want|."""
    for path, g, w in zip(ttree.paths(got), ttree.leaves(got),
                          ttree.leaves(want)):
        w = np.asarray(w, np.float64)
        g = g.detach().double().numpy()
        assert g.shape == w.shape, path
        lim = rel * max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= lim, f"{path}: max abs err {err:.3e} > {lim:.3e}"


def _unstack(cfg, tree):
    """The reference's params-shaped tree (a uniform stack's layers on a
    leading axis) in the port's layout (a list of layers)."""
    tree = dict(tree)
    if isinstance(tree.get("blocks"), dict):
        tree["blocks"] = [jax.tree.map(lambda v: v[i], tree["blocks"])
                          for i in range(cfg.n_layers)]
    return tree


# ------------------------------------------------------------ pipeline ----

@pytest.mark.parametrize("host,n_hosts", [(0, 1), (1, 2), (3, 4)])
def test_packed_batches_equal_the_reference(host, n_hosts):
    cfg = dict(vocab=97, seq_len=32, batch=4, seed=5)
    it_j = jpipe.packed_batches(jpipe.DataConfig(**cfg), host, n_hosts)
    it_t = tpipe.packed_batches(tpipe.DataConfig(**cfg), host, n_hosts)
    for _ in range(3):
        a, b = next(it_j), next(it_t)
        for k in ("tokens", "loss_mask"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    other = next(tpipe.packed_batches(tpipe.DataConfig(**cfg), host + 1,
                                      n_hosts))
    assert not np.array_equal(other["tokens"], a["tokens"])


# --------------------------------------------------------------- AdamW ----

def test_adamw_matches_numpy_reference():
    cfg = toptim.AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8,
                             weight_decay=0.0, clip_norm=None,
                             warmup_steps=0, total_steps=10 ** 9,
                             min_lr_ratio=1.0)
    p = {"w": torch.tensor([[1.0, -2.0]])}
    g = {"w": torch.tensor([[0.5, 0.3]])}
    p1, _, _ = toptim.apply(cfg, p, g, toptim.init(p))
    mu = 0.1 * np.array([[0.5, 0.3]])
    nu = 0.01 * np.array([[0.25, 0.09]])
    want = np.array([[1.0, -2.0]]) - 0.1 * (mu / 0.1) / (
        np.sqrt(nu / 0.01) + 1e-8)
    np.testing.assert_allclose(p1["w"].numpy(), want, atol=1e-6)


def test_clip_and_schedule():
    cfg = toptim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             clip_norm=1.0)
    assert float(toptim.schedule(cfg, torch.tensor(0))) == 0.0
    assert float(toptim.schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(toptim.schedule(cfg, torch.tensor(100))) == pytest.approx(
        cfg.min_lr_ratio)
    for step in (0, 3, 10, 47, 100, 130):
        assert float(toptim.schedule(cfg, torch.tensor(step))) == \
            pytest.approx(float(joptim.schedule(cfg, jnp.array(step))),
                          rel=1e-6)
    p = {"w": torch.ones(4)}
    _, _, stats = toptim.apply(cfg, p, {"w": torch.full((4,), 100.0)},
                               toptim.init(p))
    assert float(stats["grad_norm"]) == pytest.approx(200.0)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_apply_matches_reference_on_carried_state(clip):
    """Three leaves (a 1-D one is not decayed), a state three steps in,
    clipping on and off: parameters, moments and stats within 1e-6."""
    rng = np.random.default_rng(1)
    shapes = {"a": {"w": (3, 4)}, "b": (5,), "c": (2, 3, 2)}
    mk = lambda s: jax.tree.map(  # noqa: E731
        lambda sh: rng.normal(size=sh).astype(np.float32), s,
        is_leaf=lambda x: isinstance(x, tuple))
    p, g, mu = mk(shapes), mk(shapes), mk(shapes)
    nu = jax.tree.map(np.abs, mk(shapes))
    cfg = dict(lr=0.05, weight_decay=0.1, clip_norm=clip, warmup_steps=2,
               total_steps=20)
    sj = joptim.AdamWState(jnp.array(3, jnp.int32), mu, nu)
    pj, sj2, stj = joptim.apply(joptim.AdamWConfig(**cfg), p, g, sj)
    st = opt_state_from_jax(tget("llama2-7b").smoke(), (3, mu, nu),
                            device="cpu")
    tt = lambda tr: jax.tree.map(_t, tr)  # noqa: E731
    pt, st2, stt = toptim.apply(toptim.AdamWConfig(**cfg), tt(p), tt(g), st)
    assert int(st2.step) == int(sj2.step) == 4
    for got, want in ((pt, pj), (st2.mu, sj2.mu), (st2.nu, sj2.nu)):
        for a, b in zip(ttree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for k in ("grad_norm", "lr"):
        assert float(stt[k]) == pytest.approx(float(stj[k]), rel=1e-6)


# ---------------------------------------------------------- checkpoints ----

def _ck_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    t = _ck_tree()
    p = str(tmp_path / "ck" / "ckpt_1.npz")
    tckpt.save(p, t, step=1, extra={"note": "x"})
    loaded, man = tckpt.load(p, t)
    assert man["step"] == 1 and man["extra"]["note"] == "x"
    for a, b in zip(ttree.leaves(t), ttree.leaves(loaded)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    p = str(tmp_path / "ckpt_1.npz")
    tckpt.save(p, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.load(p, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="leaf count"):
        tckpt.load(p, {"a": torch.ones(2), "b": torch.ones(1)})


def test_checkpoint_retention_and_latest(tmp_path):
    d = str(tmp_path)
    for s in (10, 20, 30, 40):
        tckpt.save(tckpt.step_path(d, s), {"a": torch.ones(1)}, step=s)
    assert tckpt.latest_step(d) == 40
    tckpt.retain(d, keep=2)
    left = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    assert left == ["ckpt_30.npz", "ckpt_40.npz"]
    assert tckpt.latest_step(str(tmp_path / "nope")) is None


def _adapter_state_pair(cfg_j, cfg_t, dtype="bfloat16", rank=4):
    """A reference adapter with a seeded nonzero B and a state two steps
    in, in bf16, and their port copies."""
    rng = np.random.default_rng(3)
    ad = jtrain.init_lora_adapter(cfg_j, rank, jax.random.PRNGKey(1))
    ad = {t: {"a": ab["a"], "b": jnp.asarray(rng.normal(
        size=ab["b"].shape).astype(np.float32) * 0.05)} for t, ab in ad.items()}
    ad = jax.tree.map(lambda x: x.astype(dtype), ad)
    st = joptim.init(ad)
    st = joptim.AdamWState(jnp.array(2, jnp.int32),
                           jax.tree.map(lambda m: m + 0.01, st.mu),
                           jax.tree.map(lambda m: m + 0.02, st.nu))
    ct = dataclasses.replace(cfg_t, dtype=dtype)
    return ({"model": ad, "opt": st},
            {"model": adapter_from_jax(ct, _np_tree(ad), device="cpu"),
             "opt": opt_state_from_jax(ct, _np_tree(st), device="cpu")})


def test_checkpoint_written_by_the_reference_loads_in_the_port(tmp_path):
    cj, ct = jget("llama2-7b").smoke(), tget("llama2-7b").smoke()
    tj, tt = _adapter_state_pair(cj, ct)
    p = str(tmp_path / "ckpt_7.npz")
    jckpt.save(p, tj, step=7)
    got, man = tckpt.load(p, ttree.map_(torch.zeros_like, tt))
    assert man["step"] == 7
    assert len(ttree.leaves(got)) == len(jax.tree.leaves(tj))
    for a, b in zip(ttree.leaves(got), jax.tree.leaves(tj)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    for a, b in zip(ttree.leaves(got), ttree.leaves(tt)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_written_by_the_port_loads_in_the_reference(tmp_path):
    cj, ct = jget("llama2-7b").smoke(), tget("llama2-7b").smoke()
    tj, tt = _adapter_state_pair(cj, ct)
    p = str(tmp_path / "ckpt_7.npz")
    tckpt.save(p, tt, step=7)
    got, man = jckpt.load(p, jax.tree.map(jnp.zeros_like, tj))
    assert man["step"] == 7
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def _full_ft_pair(arch):
    """A reference full fine-tune's {"model", "opt"} tree (the moments
    made nonzero) and a port trainer holding the same parameters and
    state in its own layout (`params_from_jax`, `opt_state_from_jax`)."""
    cj, ct, pj, pt = _both(arch)
    st = joptim.init(pj)
    st = joptim.AdamWState(jnp.array(3, jnp.int32),
                           jax.tree.map(lambda m: m + 0.01, st.mu),
                           jax.tree.map(lambda m: m + 0.02, st.nu))
    trainer = tlaunch.Trainer(ct, device="cpu", params=pt)
    trainer.state = opt_state_from_jax(ct, _np_tree(st), device="cpu")
    return {"model": pj, "opt": st}, trainer


def _assert_port_tree_equals(ct, got, tj):
    """A port-layout {"model", "opt"} tree bitwise equal to the
    reference's after the layout map (its uniform stack unstacked)."""
    want = {"model": _unstack(ct, tj["model"]),
            "opt": joptim.AdamWState(tj["opt"].step,
                                     _unstack(ct, tj["opt"].mu),
                                     _unstack(ct, tj["opt"].nu))}
    g, w = ttree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.detach().float().numpy(),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("arch", ["llama2-7b", "dbrx-132b"])
def test_full_ft_checkpoint_written_by_the_reference_loads_in_the_port(
        tmp_path, arch):
    tj, trainer = _full_ft_pair(arch)
    p = str(tmp_path / "ckpt_3.npz")
    jckpt.save(p, tj, step=3)
    got, man = trainer.load_checkpoint(p)
    assert man["step"] == 3 and int(got["opt"].step) == 3
    assert isinstance(got["model"]["blocks"], list)
    _assert_port_tree_equals(trainer.cfg, got, tj)
    # and equal to the trainer's own tree, leaf for leaf
    for a, b in zip(ttree.leaves(got), ttree.leaves(
            {"model": trainer.trained(), "opt": trainer.state})):
        assert a.dtype == b.dtype and torch.equal(a, b.detach())


@pytest.mark.parametrize("arch", ["llama2-7b", "dbrx-132b"])
def test_full_ft_checkpoint_written_by_the_port_loads_in_the_reference(
        tmp_path, arch):
    tj, trainer = _full_ft_pair(arch)
    p = str(tmp_path / "ckpt_3.npz")
    tckpt.save(p, trainer.checkpoint_tree(), step=3)
    got, man = jckpt.load(p, jax.tree.map(jnp.zeros_like, tj))
    assert man["step"] == 3
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tj)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    # a round trip through the port's own loader gives the trainer's tree
    back, _ = trainer.load_checkpoint(p)
    _assert_port_tree_equals(trainer.cfg, back, tj)


# ----------------------------------------------------------------- loss ----

@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_matches_reference(arch):
    """Masked next-token cross-entropy (+ 0.01 x the MoE aux summed over
    layers on dbrx), the VLM after its patch embeddings, in f32."""
    cj, ct, pj, pt = _both(arch)
    bj, bt = _batch(ct, B=2, L=12, seed=len(arch),
                    prefix=ct.family == "vlm")
    lj, auxj = jmodel.loss(cj, pj, bj)
    lt, auxt = tmodel.loss(ct, pt, bt)
    assert float(lt) == pytest.approx(float(lj), rel=1e-4)
    assert float(auxt["ce"]) == pytest.approx(float(auxj["ce"]), rel=1e-4)
    if ct.moe:      # the aux term is there, and is what tells them apart
        assert float(lt) - float(auxt["ce"]) > 1e-3


def test_prefill_returns_the_moe_aux_summed_over_layers():
    _, ct, _, pt = _both("dbrx-132b")
    _, bt = _batch(ct, B=2, L=12)
    x = ttransformer.embed_tokens(ct, pt, bt["tokens"])
    want = 0.0
    pos = torch.arange(12).expand(2, 12)
    for p_l in pt.blocks:
        x, _, a = ttransformer.block_apply(
            ct, p_l, x, pos, rope_cs=ttransformer._rope(ct, pos),
            lora_layer=None, lora_idx=None, lora_ranks=None,
            lora_mode="none", decode=False, need_aux=True)
        want = want + a
    _, _, aux = ttransformer.prefill(ct, pt, bt["tokens"], return_aux=True)
    assert float(aux) == pytest.approx(float(want), rel=1e-6)
    assert float(aux) > 0


# ------------------------------------------------------ training steps ----

def _j_lora_loss(cj, pj, batch, rank):
    def loss_fn(adapter):
        pool = {t: {"a": adapter[t]["a"][:, None],
                    "b": adapter[t]["b"][:, None]} for t in adapter}
        pool["ranks"] = jnp.full((1,), rank, jnp.int32)
        lora = {"pool": pool,
                "idx": jnp.zeros((batch["tokens"].shape[0],), jnp.int32),
                "mode": "bgmv"}
        return jmodel.loss(cj, pj, batch, lora=lora)[0]
    return loss_fn


def test_lora_step_matches_reference(llama):
    """From the reference's adapter after one step (nonzero B) and its
    optimizer state: the loss and every adapter gradient, then 5 steps of
    the port beside 5 of the reference."""
    cj, ct, pj, pt = llama
    rank = 4
    ocfg = dict(lr=1e-2, warmup_steps=0, total_steps=100, weight_decay=0.1)
    bj, bt = _batch(ct)
    step_j = jax.jit(jtrain.make_lora_train_step(
        cj, joptim.AdamWConfig(**ocfg), rank))
    ad = jtrain.init_lora_adapter(cj, rank, jax.random.PRNGKey(1))
    ad, sj, _ = step_j(ad, joptim.init(ad), pj, bj)
    assert float(jnp.abs(ad["q"]["b"]).max()) > 0
    at = adapter_from_jax(ct, _np_tree(ad), device="cpu")
    st = opt_state_from_jax(ct, _np_tree(sj), device="cpu")

    lj, gj = jax.value_and_grad(_j_lora_loss(cj, pj, bj, rank))(ad)
    lt, gt = ttrain.lora_loss_and_grads(ct, pt, at, bt, rank)
    assert float(lt) == pytest.approx(float(lj), rel=1e-4)
    _close_tree(gt, gj, 1e-4)
    assert float(gt["q"]["a"].abs().max()) > 0    # B != 0: A learns too

    step_t = ttrain.make_lora_train_step(ct, toptim.AdamWConfig(**ocfg),
                                         rank)
    for i in range(5):
        bj, bt = _batch(ct, seed=10 + i)
        ad, sj, mj = step_j(ad, sj, pj, bj)
        at, st, mt = step_t(at, st, pt, bt)
        assert float(mt["loss"]) == pytest.approx(float(mj["loss"]),
                                                  rel=1e-3)
    assert int(st.step) == int(sj.step)
    for a, b in zip(ttree.leaves(at), jax.tree.leaves(ad)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3)


def test_full_finetuning_step_matches_reference(llama):
    """Every parameter's gradient, then one full step (weight decay on,
    from a carried-across state one step in) beside the reference's."""
    cj, ct, pj, pt = llama
    ocfg = dict(lr=1e-3, warmup_steps=0, total_steps=100)
    bj, bt = _batch(ct, seed=5)
    step_j = jax.jit(jtrain.make_train_step(
        cj, joptim.AdamWConfig(**ocfg), accum=1))
    pj1, sj, _ = step_j(pj, joptim.init(pj), _batch(ct, seed=6)[0])
    pt1 = params_from_jax(ct, _np_tree(pj1), device="cpu")
    st = opt_state_from_jax(ct, _np_tree(sj), device="cpu")

    lj, gj = jax.value_and_grad(lambda p: jmodel.loss(cj, p, bj)[0])(pj1)
    tree = ttree.param_tree(pt1)
    leaves = ttree.leaves(tree)
    with ttrain.trainable(leaves):
        lt, _ = tmodel.loss(ct, pt1, bt)
        gt = ttrain.grads(lt, leaves, ttree.paths(tree))
    assert all(not p.requires_grad for p in leaves)
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-4)
    _close_tree(ttree.unflatten(tree, gt), _unstack(cj, gj), 1e-4)

    pj2, _, mj = step_j(pj1, sj, bj)
    step_t = ttrain.make_train_step(ct, toptim.AdamWConfig(**ocfg), accum=1)
    pt2, st2, mt = step_t(pt1, st, bt)
    assert pt2 is pt1                          # updated in place
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-4)
    assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]),
                                                   rel=1e-4)
    got = ttree.leaves(ttree.param_tree(pt2))
    want = ttree.leaves(_unstack(cj, _np_tree(pj2)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=5e-3)


@pytest.mark.parametrize("kind", ["lora", "full"])
def test_in_place_steps_equal_the_functional_ones_and_the_reference(
        llama, kind):
    """Three steps through `Trainer.step` (the in-place step a card runs
    as a CUDA graph, its batch in static buffers, its metrics in 0-d
    buffers) equal three of the functional step bitwise on the CPU, and
    the reference's jitted step within this file's tolerances (as in
    test_lora_step_matches_reference / test_full_finetuning_step_matches_
    reference: losses rel 1e-3 / 1e-4, leaves atol 5e-3); the trainer's
    leaves and batch buffers keep their storage."""
    cj, ct, pj, pt = llama
    rank = 4
    batches = [_batch(ct, seed=30 + i) for i in range(3)]
    trainer = tlaunch.Trainer(ct, lora_rank=rank if kind == "lora" else 0,
                              steps=3, lr=1e-2, device="cpu",
                              params=params_from_jax(ct, _np_tree(pj),
                                                     device="cpu"))
    o = trainer.opt_cfg
    ocfg = dict(lr=o.lr, warmup_steps=o.warmup_steps,
                total_steps=o.total_steps)
    if kind == "lora":
        ad = jtrain.init_lora_adapter(cj, rank, jax.random.PRNGKey(1))
        step_j = jax.jit(jtrain.make_lora_train_step(
            cj, joptim.AdamWConfig(**ocfg), rank))
        ad, sj, _ = step_j(ad, joptim.init(ad), pj, batches[0][0])
        with torch.no_grad():      # the reference's state, in place
            for dst, src in zip(
                    ttree.leaves({"a": trainer.adapter, "s": trainer.state}),
                    ttree.leaves({"a": adapter_from_jax(
                        ct, _np_tree(ad), device="cpu"),
                        "s": opt_state_from_jax(ct, _np_tree(sj),
                                                device="cpu")})):
                dst.copy_(src)
        fn_t = ttrain.make_lora_train_step(ct, toptim.AdamWConfig(**ocfg),
                                           rank)
        fn_tree = ttree.map_(torch.clone, trainer.adapter)
        fn_state = toptim.clone(trainer.state)
        ref = (ad, sj)
    else:
        step_j = jax.jit(jtrain.make_train_step(
            cj, joptim.AdamWConfig(**ocfg), accum=1))
        ref = (pj, joptim.init(pj))
        fn_t = ttrain.make_train_step(ct, toptim.AdamWConfig(**ocfg),
                                      accum=1)
        fn_params = params_from_jax(ct, _np_tree(pj), device="cpu")
        fn_state = toptim.clone(trainer.state)
    held = [t.data_ptr() for t in ttree.leaves(
        {"m": trainer.trained(), "o": trainer.state})] + \
        [t.data_ptr() for t in trainer.metrics.values()]
    for bj, bt in batches:
        m = trainer.step({k: v.numpy() for k, v in bt.items()})
        if kind == "lora":
            fn_tree, fn_state, mf = fn_t(fn_tree, fn_state, pt, bt)
            aj, stj, mj = step_j(*ref, pj, bj)
            rel = 1e-3
        else:
            fn_params, fn_state, mf = fn_t(fn_params, fn_state, bt)
            aj, stj, mj = step_j(*ref, bj)
            rel = 1e-4
        ref = (aj, stj)
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(m[k], mf[k].reshape(())), k
        assert float(m["loss"]) == pytest.approx(float(mj["loss"]), rel=rel)
    got = ttree.leaves({"m": trainer.trained(), "o": trainer.state})
    fn = ttree.leaves({"m": fn_tree if kind == "lora"
                       else ttree.param_tree(fn_params), "o": fn_state})
    assert len(got) == len(fn)
    assert all(torch.equal(a, b) for a, b in zip(got, fn))
    want = ref[0] if kind == "lora" else _unstack(cj, _np_tree(ref[0]))
    for a, b in zip(ttree.leaves(trainer.trained()), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=5e-3)
    assert int(trainer.state.step) == int(ref[1].step)
    assert held == [t.data_ptr() for t in ttree.leaves(
        {"m": trainer.trained(), "o": trainer.state})] + \
        [t.data_ptr() for t in trainer.metrics.values()]
    e = trainer.graphs.entries["train"]
    assert (e.builds, e.calls) == (1, 3)


def test_trainer_retrace_catches_a_rebound_adapter_leaf(llama):
    """Under the sanitizers the trainer's `train` key is watched: an
    adapter leaf rebound after steady state is a re-capture that raises."""
    from repro_torch.analysis import sanitizers
    from repro_torch.analysis.retrace import RetraceError
    _, ct, _, pt = llama
    with sanitizers.force(True):
        trainer = tlaunch.Trainer(ct, lora_rank=4, steps=4, device="cpu",
                                  params=pt)
    batch = {k: v.numpy() for k, v in _batch(ct, seed=3)[1].items()}
    trainer.step(batch)
    trainer.retrace_san.mark_steady()
    trainer.step(batch)
    trainer.retrace_san.assert_clean()
    q = trainer.adapter["q"]
    q["b"] = q["b"].clone()
    trainer.step(batch)
    with pytest.raises(RetraceError, match=r"train: graph cache grew 1 -> 2"):
        trainer.retrace_san.assert_clean()


def test_decay_mask_follows_the_reference_layout(llama):
    """A layer's norm scale is 1-D in the port and 2-D (stacked) in the
    reference, so it is decayed; the final norm is not."""
    _, ct, _, pt = llama
    m = ttrain.decay_mask(ct, ttree.param_tree(pt))
    assert m["blocks"][0]["norm1"]["scale"] is True
    assert m["final_norm"]["scale"] is False
    assert m["embed"] is True


def test_grad_accumulation_equals_one_batch(llama):
    """accum=2 on batch 4 == accum=1 (same total gradient). Every token
    counts, as in the reference's test: each microbatch's loss is its own
    masked mean, so with a ragged mask the two differ by design."""
    _, ct, pj, _ = llama
    ocfg = toptim.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                              clip_norm=None, weight_decay=0.0)
    _, bt = _batch(ct, seed=9)
    bt["loss_mask"] = torch.ones_like(bt["loss_mask"])
    outs = []
    for accum in (1, 2):
        pt = params_from_jax(ct, _np_tree(pj), device="cpu")
        state = toptim.init(ttree.param_tree(pt))
        pt, _, m = ttrain.make_train_step(ct, ocfg, accum=accum)(pt, state,
                                                                 bt)
        outs.append((ttree.leaves(ttree.param_tree(pt)), float(m["loss"])))
    assert outs[0][1] == pytest.approx(outs[1][1], rel=1e-5)
    for a, b in zip(outs[0][0], outs[1][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3)


def test_remat_on_equals_off(llama, monkeypatch):
    """Activation checkpointing recomputes each layer in the backward and
    changes no number; with remat on, every layer goes through it."""
    _, ct, pj, pt = llama
    _, bt = _batch(ct, seed=4)
    at = ttrain.init_lora_adapter(ct, 8, torch.Generator().manual_seed(0))
    at["k"]["b"] = torch.randn(at["k"]["b"].shape,
                               generator=torch.Generator().manual_seed(1))
    calls = []
    real = ttransformer.checkpoint

    def spy(fn, *a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *a, **kw)

    monkeypatch.setattr(ttransformer, "checkpoint", spy)
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(ct, remat=remat)
        out[remat] = ttrain.lora_loss_and_grads(cfg, pt, at, bt, 8)
    assert calls == [False] * ct.n_layers
    assert float(out[True][0]) == float(out[False][0])
    for a, b in zip(ttree.leaves(out[True][1]), ttree.leaves(out[False][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_serving_takes_no_checkpoint_and_no_moe_aux(monkeypatch):
    """Under torch.no_grad() (as the serving backend runs) prefill and
    decode call no checkpoint and compute no MoE aux."""
    _, ct, _, pt = _both("dbrx-132b")
    assert ct.remat

    def no_checkpoint(*a, **kw):
        raise AssertionError("checkpointed path under no_grad")

    seen = []
    real = tmoe.moe_apply

    def spy(cfg, p, x, need_aux=True):
        y, aux = real(cfg, p, x, need_aux=need_aux)
        seen.append(aux)
        return y, aux

    monkeypatch.setattr(ttransformer, "checkpoint", no_checkpoint)
    monkeypatch.setattr(ttransformer, "moe_apply", spy)
    _, bt = _batch(ct, B=2, L=8)
    with torch.no_grad():
        logits, cache = tmodel.prefill(ct, pt, bt, cache_slots=16)
        tmodel.decode(ct, pt, cache, bt["tokens"][:, :1],
                      torch.full((2,), 8, dtype=torch.int32))
    assert logits.shape == (2, 8, ct.vocab)
    assert len(seen) == 2 * ct.n_layers and all(a is None for a in seen)


def test_a_missing_kernel_gradient_raises(llama, monkeypatch):
    """A LoRA delta or an attention whose output has no grad_fn (as a
    kernel launched without its autograd Function would give) cuts the
    graph: the step raises and names the leaves, never a zero gradient."""
    _, ct, _, pt = llama
    _, bt = _batch(ct)
    at = ttrain.init_lora_adapter(ct, 8, torch.Generator().manual_seed(0))
    real = ops.lora_delta
    monkeypatch.setattr(ops, "lora_delta",
                        lambda *a, **kw: real(*a, **kw).detach())
    with pytest.raises(RuntimeError, match="no gradient"):
        ttrain.lora_loss_and_grads(ct, pt, at, bt, 8)
    monkeypatch.setattr(ops, "lora_delta", real)
    real_attn = ttransformer.attn_prefill
    monkeypatch.setattr(ttransformer, "attn_prefill",
                        lambda *a, **kw: real_attn(*a, **kw).detach())
    step = ttrain.make_train_step(ct, toptim.AdamWConfig())
    state = toptim.init(ttree.param_tree(pt))
    with pytest.raises(RuntimeError, match=r"no gradient reaches.*wq"):
        step(pt, state, bt)
    assert not any(p.requires_grad for p in pt.parameters())


def test_lora_training_fits_a_fixed_batch_and_moves_only_the_adapter(
        llama):
    _, ct, _, pt = llama
    before = [p.clone() for p in pt.parameters()]
    adapter = ttrain.init_lora_adapter(ct, 4,
                                       torch.Generator().manual_seed(1))
    assert float(adapter["q"]["b"].abs().max()) == 0.0
    assert float(adapter["q"]["a"][..., 4:].abs().max()) == 0.0
    step = ttrain.make_lora_train_step(
        ct, toptim.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=100,
                               weight_decay=0.0), rank=4)
    _, bt = _batch(ct, seed=2)
    state = toptim.init(adapter)
    a1, state, m1 = step(adapter, state, pt, bt)
    a2, state, m2 = step(a1, state, pt, bt)
    assert float(m2["loss"]) < float(m1["loss"])
    assert float(a2["q"]["b"].abs().max()) > 0.0
    assert all(torch.equal(a, b) for a, b in zip(before, pt.parameters()))


def test_train_cli_runs_on_cpu(tmp_path, capsys):
    recs = tlaunch.main(["--smoke", "--device", "cpu", "--lora-rank", "8",
                         "--steps", "5", "--seq", "32", "--batch", "4",
                         "--log-every", "2", "--ckpt-dir", str(tmp_path),
                         "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "ms/step" in out and "tok/s" in out and "done: 5 steps" in out
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(r["loss"]) and r["tok_s"] > 0 for r in recs)
    assert tckpt.latest_step(str(tmp_path)) == 4
    # the checkpoint loads back into the trainer's structure
    trainer = tlaunch.Trainer(tget("llama2-7b").smoke(), lora_rank=8,
                              device="cpu")
    tree, man = tckpt.load(tckpt.step_path(str(tmp_path), 4),
                           {"model": trainer.trained(),
                            "opt": trainer.state})
    assert man["step"] == 4 and int(tree["opt"].step) == 4


def test_train_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--smoke", "--steps", "1"])
