"""The kernels' launch model (`repro_torch.analysis.kernel_model`): every
registered config is taken by every kernel on its path, and so are the
MQA, hd-80 and LoRA-tail mutations; head dims past 256 and r_max past
MAX_R are refused by the rule the wrapper raises on; and max_rank 12, no
multiple of 8, runs after the pool pads it to 16 columns — it serves
token for token with the reference (bgmv and mbgmv, f32) and a rank-12
LoRA step's gradients equal the reference's. The card checks of
`kernel_verify` (canaries, mutants) are marked `cuda` and skip here."""
import dataclasses
import importlib
import inspect
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.analysis import kernel_model  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.engine import InferenceServer  # noqa: E402
from repro_torch.core.lora import AdapterSpec  # noqa: E402
from repro_torch.core.timing import Hardware  # noqa: E402
from repro_torch.kernels import bgmv, flash, paged  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.weights import (adapter_from_jax,  # noqa: E402
                                        opt_state_from_jax, params_from_jax)
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import train as ttrain  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    """The reference package (JAX on the CPU), for the parity tests only:
    this file also holds a card test, and the card's machine has no JAX."""
    pytest.importorskip("jax")
    mods = {"jax": "jax", "jnp": "jax.numpy",
            "base": "repro.configs.base", "engine": "repro.core.engine",
            "lora": "repro.core.lora", "timing": "repro.core.timing",
            "model": "repro.models.model", "param": "repro.models.param",
            "request": "repro.serving.request",
            "ckpt": "repro.training.checkpoint",
            "optim": "repro.training.optim", "train": "repro.training.train"}
    return SimpleNamespace(**{k: importlib.import_module(v)
                              for k, v in mods.items()})


CONFIGS = list(kernel_model.CONFIGS) + [
    "whisper-tiny", "recurrentgemma-2b", "dbrx-132b", "mistral-large-123b",
    "phi-3-vision-4.2b", "command-r-35b", "yi-9b", "grok-1-314b",
    "mamba2-130m", "qwen2-72b"]


def _case(name):
    return kernel_model.case_from_config(get_config(name))


def test_config_cases_cover_every_registered_config():
    assert [c.config for c in kernel_model.config_cases()] == CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_every_kernel_on_the_path_takes_the_config(name):
    case = _case(name)
    launches = kernel_model.launches(case)
    assert [x.label for x in launches if x.refusal] == []
    kinds = {x.kernel for x in launches}
    assert {"lora_shrink", "lora_expand"} <= kinds
    assert ("flash_attention" in kinds) == case.attention
    assert ("paged_attention" in kinds) == case.paged
    # both launch paths of each LoRA kernel, from the wrappers' own plans:
    # the shrink's row tiles in bf16 at these widths are the persistent
    # wgmma kernel's, in clusters of `split` d slices
    paths = {(x.kernel, x.path) for x in launches}
    assert {("lora_shrink", "decode"), ("lora_expand", "decode"),
            ("lora_expand", "row tiles")} <= paths
    assert any(k == "lora_shrink" and p.startswith("persistent x")
               for k, p in paths)


def _refused(case, kernel):
    return [x for x in kernel_model.launches(case) if x.kernel == kernel
            and x.refusal]


@pytest.mark.parametrize("mutation", ["flash hd 320", "paged hd 320",
                                      "r_max above MAX_R"])
def test_mutated_configs_are_refused_by_the_wrappers_rule(mutation):
    """Each mutation is refused by the named rule, and that function is
    the one the wrapper raises through on the card: a head dim past 256
    (flash's O accumulator and paged attention's one-warp score sum) and
    an r_max past MAX_R, which the padded pool never passes."""
    case = _case("llama2-7b")
    if mutation == "flash hd 320":
        case = dataclasses.replace(case, hd=320, paged=False)
        kernel, rule, wrapper = "flash_attention", flash.shape_refusal, \
            flash._forward
        want = rule(320, torch.bfloat16)
    elif mutation == "paged hd 320":
        case = dataclasses.replace(case, hd=320, attention=False)
        kernel, rule, wrapper = "paged_attention", paged.shape_refusal, \
            paged.paged_attention
        want = rule(1, 320)
    else:
        r = bgmv.MAX_R + bgmv.RANK_ALIGN
        case = dataclasses.replace(case, r_pad=r, lora=(("q", 4096, 4096),))
        kernel, rule, wrapper = "lora_shrink", bgmv.shrink_refusal, \
            bgmv._shrink
        want = rule(4096, r)
    bad = _refused(case, kernel)
    assert bad and want
    assert {(x.rule, x.refusal) for x in bad} == {
        (f"{rule.__module__.rsplit('.', 1)[1]}.{rule.__name__}", want)}
    assert f"{rule.__name__}(" in inspect.getsource(wrapper)
    others = [x.label for x in kernel_model.launches(case)
              if x.refusal and not x.kernel.startswith(kernel[:4])]
    assert others == []


@pytest.mark.parametrize("mutation", ["hd 80", "GQA 32 at hd 128",
                                      "d_in 4100"])
def test_once_refused_mutations_are_taken_by_every_launch(mutation):
    """The three shapes the reference's kernels take and the Hopper kernels
    refused before group tiles, padded widths and LoRA tails: every launch
    on the mutated config's path is taken, through the wrapper's own
    rule, and lands on the new launch (the group kernel, which holds the
    whole group of 32 in one block, a padded flash width, the LoRA
    kernels' element-copy instantiations)."""
    case = _case("llama2-7b")
    if mutation == "hd 80":
        case = dataclasses.replace(case, hd=80)
        want = "flash_attention[bf16 wgmma hd 80 at 96]"
    elif mutation == "GQA 32 at hd 128":
        case = dataclasses.replace(case, n_heads=32, n_kv_heads=1)
        want = "paged_attention[4 splits + combine G 32 hd 128 on the " \
            "group kernel]"
    else:
        case = dataclasses.replace(case, lora=(("q", 4100, 4096),))
        want = "lora_shrink[decode tail]"
    launches = kernel_model.launches(case)
    assert [x.label for x in launches if x.refusal] == []
    assert f"{case.config} {want}" in [x.label for x in launches]


def test_paged_rule_copy_matches_its_documented_edge():
    """`paged.fits` (the CPU's copy of rt_paged_attention_fits): any GQA
    group >= 1 and hd 1 to 256 (a head's pow2(hd / 8) lanes in one warp);
    `group_tiles` cuts a group past one block of 256 threads. The card
    holds both copies equal to the library's over a grid."""
    assert paged.fits(1, 1) and paged.fits(160, 256) and paged.fits(71, 12)
    assert not paged.fits(1, 257) and not paged.fits(1, 0)
    assert not paged.fits(0, 128) and not paged.fits(4, 320)
    assert paged.group_tiles(16, 128) == 1 and paged.group_tiles(17, 128) == 2
    assert paged.group_tiles(32, 64) == 1 and paged.group_tiles(33, 64) == 2
    assert paged.group_tiles(8, 256) == 1 and paged.group_tiles(9, 256) == 2
    assert paged.group_tiles(71, 64) == 3 and paged.group_tiles(32, 100) == 2
    assert "hd 1 to 256" in paged.shape_refusal(1, 260)


@pytest.mark.parametrize("G,hd,dtype,want", [
    (1, 128, torch.bfloat16, 0),         # MHA: the lane kernel
    (2, 128, torch.bfloat16, 1),         # the smallest group
    (8, 128, torch.bfloat16, 1),         # yi-9b, llama2-70b, qwen2-72b
    (71, 64, torch.bfloat16, 1),         # falcon-7b's MQA
    (128, 256, torch.bfloat16, 1),       # GROUP_MAX_G: 8 M tiles
    (129, 64, torch.bfloat16, 0),        # past it: lane tiles
    (8, 128, torch.float32, 0),          # f32 stays on the lane kernel
    (32, 12, torch.bfloat16, 1),         # hd no multiple of 8 or 16
    (8, 257, torch.bfloat16, -1),        # refused, as paged.fits
    (0, 128, torch.bfloat16, -1),
    (8, 128, torch.float16, -1)])
def test_paged_route_copy_matches_its_documented_edges(G, hd, dtype, want):
    """`paged.route` (the CPU's copy of rt_paged_attention_route): the
    group kernel for bf16 at groups 2 to GROUP_MAX_G, the lane kernel for
    MHA, f32 and larger groups, -1 where the kernels refuse. The group
    route takes one block a KV head (`launch_tiles` 1); the lane route
    keeps `group_tiles`. The card holds the copy to the library's."""
    assert paged.route(G, hd, dtype) == want
    if want == 1:
        assert paged.launch_tiles(G, hd, dtype) == 1
    elif want == 0:
        assert paged.launch_tiles(G, hd, dtype) == paged.group_tiles(G, hd)


@pytest.mark.parametrize("B,KV,W,want", [
    (8, 4, 128, 32),                     # yi-9b's long row: 32 splits
    (8, 8, 16, 4),                       # mistral-large, W 16
    (8, 1, 16, 4),                       # MQA at W 16
    (8, 32, 16, 1),                      # llama2-7b: 256 blocks fill it
    (4, 2, 7, 1),                        # W < 2 x SPLIT_PAGES
    (68, 2, 80, 1), (64, 2, 80, 8), (1, 1, 4096, 1024)])
def test_paged_split_plan_at_one_tile(B, KV, W, want):
    """split_plan with tiles = 1 (the group route): splits of at least
    SPLIT_PAGES columns until B x KV x splits blocks reach
    MAX_SPLIT_BLOCKS_PER_SM an SM, none left empty, one split where B x
    KV blocks fill the card."""
    n = paged.split_plan(B, KV, W, kernel_model.H100_SMS, 1)
    assert n == want
    per = -(-W // n)
    assert (n - 1) * per < W                 # no split is empty
    assert n == 1 or per >= paged.SPLIT_PAGES
    assert B * KV * n <= max(paged.MAX_SPLIT_BLOCKS_PER_SM *
                             kernel_model.H100_SMS, B * KV)


@pytest.mark.parametrize("name,route", [
    ("llama2-7b", "lanes"), ("llama2-13b", "lanes"),
    ("phi-3-vision-4.2b", "lanes"), ("yi-9b", "group"),
    ("llama2-70b", "group"), ("qwen2-72b", "group"),
    ("command-r-35b", "group"), ("mistral-large-123b", "group"),
    ("dbrx-132b", "group"), ("grok-1-314b", "group")])
def test_paged_launch_of_each_config_names_its_route(name, route):
    """Each paged config's decode launch, as the kernel model describes it
    to phase S, lands on the kernel `paged.route` gives: MHA on the lane
    kernel in one group tile, every GQA group on the group kernel, one
    block a KV head."""
    case = _case(name)
    [launch] = [x for x in kernel_model.launches(case)
                if x.kernel == "paged_attention"]
    assert paged.ROUTES[paged.route(case.group, case.hd, case.dtype)] == \
        route
    assert ("on the group kernel" in launch.label) == (route == "group")
    assert "group tiles" not in launch.label
    assert paged.launch_tiles(case.group, case.hd, case.dtype) == 1


@pytest.mark.parametrize("name", ["llama2-7b", "yi-9b",
                                  "recurrentgemma-2b", "phi-3-vision-4.2b"])
def test_flash_launch_carries_what_its_grid_and_walk_depend_on(name):
    """The flash launch the model gives phase S holds every argument of
    `rt_flash_attention_info` (B, H, Lq, Lk, hd, causal, window: the grid
    is min(work tiles, SMs), the walk's weights come from Lk and the
    masks), and its persistent grid never passes the SMs."""
    from repro_torch.kernels import build
    [launch] = [x for x in kernel_model.launches(_case(name))
                if x.kernel == "flash_attention"]
    a = launch.args
    assert set(a) == {"B", "H", "Lq", "Lk", "hd", "causal", "window"}
    # the shape arguments, the dtype and the out array
    assert len(build._SIGNATURES["rt_flash_attention_info"]) == len(a) + 2
    sms = kernel_model.H100_SMS
    grid = flash.persistent_grid(a["B"], a["H"], a["Lq"], sms)
    assert grid == min(-(-a["Lq"] // flash.BQ) * a["H"] * a["B"], sms)
    walks = flash.work_walks(a["B"], a["H"], a["Lq"], a["Lk"], a["hd"],
                             bool(a["causal"]), a["window"] or None, sms)
    assert len(walks) == grid


class _OrderLibrary:
    """rt_flash_attention_order answered by a Python walk, for the check
    that holds `flash.tile_order` to the library's."""

    def __init__(self, walk):
        self.walk = walk

    def rt_flash_attention_order(self, Lq, Lk, hd, causal, window, out):
        for i, m in enumerate(self.walk(Lq, Lk, bool(causal), window or None,
                                        flash.key_tile(hd))):
            out[i] = m
        return 0


@pytest.mark.parametrize("walk", ["the copy", "plain ascending",
                                  "ties to the earlier tile"])
def test_flash_walk_check_fires_on_a_walk_that_differs(walk):
    """`kernel_verify.flash_order_findings` (phase S1's check of the bf16
    flash kernel's walk) is clean against the kernel's own rule and fires
    on another order: query tiles in index order, or the two cursors
    breaking ties to the earlier tile."""
    from repro_torch.analysis import kernel_verify

    def earlier_on_ties(Lq, Lk, causal, window, bk):
        w = flash.tile_weights(Lq, Lk, causal, window, bk)
        return sorted(range(len(w)), key=lambda m: (-w[m], m))

    fn = {"the copy": flash.tile_order,
          "plain ascending": lambda Lq, *_: list(range(-(-Lq // flash.BQ))),
          "ties to the earlier tile": earlier_on_ties}[walk]
    found = kernel_verify.flash_order_findings(_OrderLibrary(fn))
    assert (found == []) == (walk == "the copy"), found


def test_max_rank_12_is_taken_after_the_pad():
    """The kernels' 16-byte rows need r_max a multiple of 8: 12 itself is
    refused, the pool's padded 16 columns are taken on every path."""
    case = dataclasses.replace(_case("llama2-7b"), max_rank=12,
                               r_pad=bgmv.padded_rank(12))
    assert case.r_pad == 16 and bgmv.padded_rank(20) == 24
    assert bgmv.shrink_refusal(4096, 12) and bgmv.expand_refusal(12, 4096)
    lora = [x for x in kernel_model.launches(case)
            if x.kernel.startswith("lora")]
    # each LoRA kernel at the decode batches and at each prefill row count
    assert len(lora) == 2 * (len(kernel_model.DECODE_ROWS)
                             + len(kernel_model.PREFILL_ROWS))
    assert not [x for x in lora if x.refusal]
    assert {x.args["r_max"] for x in lora} == {16}


@pytest.mark.cuda
def test_canaries_and_mutants_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (CUDA kernels have no "
                    "CPU mode)")
    from repro_torch.analysis import kernel_verify
    from repro_torch.kernels import build
    lib = build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, found = kernel_verify.canaries(lib, sms)
    assert found == []
    assert kernel_verify.paged_rule_findings(lib) == []
    assert all(f for _, f in kernel_verify.mutants(lib, sms))


FAKE_NVCC = """#!/bin/sh
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then : > "$2"; fi
  shift
done
echo "ptxas info    : Used 40 registers, 0 bytes spill stores"
"""


class _FakeLibrary:
    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        return SimpleNamespace()


def test_a_library_found_built_still_gives_its_ptxas_report(tmp_path,
                                                            monkeypatch):
    """The footprint's spill check reads nvcc's report: the build writes it
    beside the library, a later process that finds the library built (a
    second run in one checkout) loads it, and a library found without its
    report is built again. nvcc and the loader are stand-ins here."""
    import ctypes
    from repro_torch.kernels import build
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "ctypes", SimpleNamespace(
        CDLL=_FakeLibrary, c_int=ctypes.c_int))

    def fresh_process(find_nvcc):
        monkeypatch.setattr(build, "_lib", None)
        monkeypatch.setattr(build, "build_log", "")
        monkeypatch.setattr(build, "build_seconds", None)
        monkeypatch.setattr(build, "_nvcc", find_nvcc)

    def no_nvcc():
        raise AssertionError("a library found built was built again")

    fresh_process(lambda: str(nvcc))
    build.library()
    report = build.build_log
    assert "Used 40 registers" in report and build.build_seconds is not None
    assert build.log_path(build.library_path()).read_text() == report
    fresh_process(no_nvcc)
    build.library()
    assert build.build_log == report and build.build_seconds is None
    build.log_path(build.library_path()).unlink()
    fresh_process(lambda: str(nvcc))
    build.library()
    assert build.build_log == report and build.build_seconds is not None


# ----------------------------------------------- max_rank 12, on the CPU ----

def _with_max_rank(cfg, r):
    return dataclasses.replace(cfg, lora=dataclasses.replace(
        cfg.lora, max_rank=r))


def _trace(seed=5, n=6):
    rng = np.random.default_rng(seed)
    return [(i, f"ad{i % 4}",
             rng.integers(0, 512, int(rng.integers(4, 16))).astype(np.int32),
             int(rng.integers(3, 14)), float(i * 3)) for i in range(n)]


@pytest.mark.parametrize("kernel", ["bgmv", "mbgmv"])
def test_max_rank_12_serves_the_references_tokens(ref, kernel):
    """A pool of max_rank 12 (the reference's 12 columns, the port's 16)
    with adapters of ranks up to 12: every request's tokens equal the
    reference's."""
    cj = _with_max_rank(ref.base.get_config("llama2-7b").smoke(), 12)
    ct = _with_max_rank(get_config("llama2-7b").smoke(), 12)
    kw = {"mode": "caraserve", "kernel": kernel, "max_batch": 4,
          "cache_slots": 64, "seed": 0}
    js = ref.engine.InferenceServer(cj, **kw)
    hw = Hardware(**dataclasses.asdict(ref.timing.V5E))
    ts = InferenceServer(ct, device="cpu", hw=hw, params=params_from_jax(
        ct, ref.jax.tree.map(np.asarray, js.params), device="cpu"), **kw)
    for i, r in enumerate((12, 5, 8, 3)):
        js.register_adapter(ref.lora.AdapterSpec(f"ad{i}", r, cj.name))
        ts.register_adapter(AdapterSpec(f"ad{i}", r, ct.name))
    assert ts.backend.pool.pool["q"]["a"].shape[-1] == 16
    trace = _trace()
    js.run([ref.request.Request(*t) for t in trace])
    ts.run([Request(*t) for t in trace])
    assert {s.req.rid: s.generated for s in ts.states} == \
        {s.req.rid: s.generated for s in js.states}


def test_rank_12_lora_step_gradients_equal_the_references(ref):
    """From the reference's adapter after one step (nonzero B), carried
    across (padded to 16 columns): the loss and every adapter gradient
    equal the reference's on its 12 columns, and the 4 pad columns get
    zero gradients."""
    rank = 12
    jax, jnp = ref.jax, ref.jnp
    cj = _with_max_rank(ref.base.get_config("llama2-7b").smoke(), rank)
    ct = _with_max_rank(get_config("llama2-7b").smoke(), rank)
    pj = ref.param.split(ref.model.init_params(cj, jax.random.PRNGKey(0)))[0]
    pt = params_from_jax(ct, jax.tree.map(np.asarray, pj), device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, ct.vocab, (4, 16)).astype(np.int32)
    mask = (rng.random((4, 16)) > 0.2).astype(np.int32)
    bj = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)}
    bt = {"tokens": torch.from_numpy(toks),
          "loss_mask": torch.from_numpy(mask)}
    step_j = jax.jit(ref.train.make_lora_train_step(
        cj, ref.optim.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10),
        rank))
    ad = ref.train.init_lora_adapter(cj, rank, jax.random.PRNGKey(1))
    ad, _, _ = step_j(ad, ref.optim.init(ad), pj, bj)

    def loss_fn(adapter):
        pool = {t: {"a": adapter[t]["a"][:, None],
                    "b": adapter[t]["b"][:, None]} for t in adapter}
        pool["ranks"] = jnp.full((1,), rank, jnp.int32)
        lora = {"pool": pool, "idx": jnp.zeros((4,), jnp.int32),
                "mode": "bgmv"}
        return ref.model.loss(cj, pj, bj, lora=lora)[0]

    lj, gj = jax.value_and_grad(loss_fn)(ad)
    at = adapter_from_jax(ct, jax.tree.map(np.asarray, ad), device="cpu")
    assert at["q"]["a"].shape[-1] == 16 and at["q"]["b"].shape[1] == 16
    lt, gt = ttrain.lora_loss_and_grads(ct, pt, at, bt, rank)
    assert float(lt) == pytest.approx(float(lj), rel=1e-4)
    for t in gt:
        for n, axis in (("a", -1), ("b", 1)):
            g = gt[t][n].double().numpy()
            w = np.asarray(gj[t][n], np.float64)
            lim = 1e-4 * max(np.abs(w).max(), 1e-30)
            assert np.abs(np.take(g, range(rank), axis) - w).max() <= lim
            assert not np.take(g, range(rank, 16), axis).any()


def test_rank_12_checkpoints_cross_between_the_packages(ref, tmp_path):
    """The port writes an adapter and its moments trimmed to max_rank (the
    reference loads them), and `Trainer.load_checkpoint` reads both
    packages' back padded; `checkpoint.load` itself still refuses any
    shape that differs."""
    rank, jax = 12, ref.jax
    cj = _with_max_rank(ref.base.get_config("llama2-7b").smoke(), rank)
    ct = _with_max_rank(get_config("llama2-7b").smoke(), rank)
    trainer = tlaunch.Trainer(ct, lora_rank=rank, device="cpu", steps=4)
    trainer.step(next(trainer.batches(4, 16)))
    p = str(tmp_path / "ckpt_1.npz")
    tckpt.save(p, trainer.checkpoint_tree(), step=1)
    ad = ref.train.init_lora_adapter(cj, rank, jax.random.PRNGKey(1))
    like = {"model": ad, "opt": ref.optim.init(ad)}
    got, _ = ref.ckpt.load(p, jax.tree.map(ref.jnp.zeros_like, like))
    np.testing.assert_array_equal(
        np.asarray(got["model"]["q"]["a"]),
        trainer.adapter["q"]["a"][..., :rank].numpy())
    held = {"model": trainer.adapter, "opt": trainer.state}
    back, _ = trainer.load_checkpoint(p)
    for a, b in zip(ttree.leaves(back), ttree.leaves(held)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load(p, held)
    # the reference's own file (12 columns) reads back into 16
    pj = str(tmp_path / "ckpt_2.npz")
    ref.ckpt.save(pj, got, step=2)
    back, man = trainer.load_checkpoint(pj)
    assert man["step"] == 2
    for a, b in zip(ttree.leaves(back), ttree.leaves(held)):
        assert torch.equal(a, b)
    st = opt_state_from_jax(ct, jax.tree.map(np.asarray, got["opt"]),
                            device="cpu")
    assert st.mu["q"]["a"].shape[-1] == 16
