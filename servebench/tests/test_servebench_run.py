"""Whole runs at a CPU test's size: the harness's look for a card is
skipped (`harness.run` with device="cpu"), everything else is a run.

- a sound run comes out correct;
- with the timed path broken underneath, `correct` comes out false: a
  token altered where it is sampled; a decode step that returns its state
  unchanged; half of the batch's rows left out of the LoRA delta;
- a configuration, a mix, a cell, a per-layer metric and a kernel family
  added as files in a copy of the benchmark are found without an edit;
- no module of the JAX package (top-level names compared whole) is
  loaded by a run.
"""
import json
import shutil
import subprocess
import sys
import time

import pytest

from servebench import harness
from servebench.cell import forbidden_modules
from servebench.model_config import spec_from_dict

from conftest import ROOT, SB, tiny_config, tiny_mix

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_run(cell="yi-9b.chat-backlog", seconds=1.5, trace=False, seed=7,
             bench=BENCH, root=SB, mix=None, control=False):
    import torch
    torch.manual_seed(0)
    wl = harness.workload(bench, cell)
    return harness.run(
        bench, cell, seed, seconds, trace, time.perf_counter(),
        device="cpu", root=root, log=lambda m: None, control=control,
        cell_kw=dict(spec=spec_from_dict(tiny_config(wl["config"])),
                     mix=mix or tiny_mix(wl["traffic"])))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_sound_run_is_correct(cell):
    out = tiny_run(cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["max_logit_gap"]["value"] < 1e-3   # f32 both
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0


def test_the_control_is_what_the_run_compares():
    """In a control run the float8 reference's tokens, not the served
    ones, go through the comparison that decides `correct`."""
    out = tiny_run(control=True)
    got = out["checks"]["max_logit_gap"]
    assert got["value"] > out["program_max_logit_gap"]
    assert out["correct"] == (got["value"] <= got["limit"]
                              and out["checks"]["ranks_missing"]["value"]
                              == 0)
    assert out["program_correct"]


def _sample_altered(monkeypatch):
    from repro_torch.core import backend
    real = backend.sample

    def altered(logits, **kw):
        return (real(logits, **kw) + 1) % logits.shape[-1]
    monkeypatch.setattr(backend, "sample", altered)


def _state_unchanged(monkeypatch):
    from repro_torch.core.backend import NumericsBackend
    monkeypatch.setattr(NumericsBackend, "_fused_step",
                        lambda self, lora, active: self.pipe.last_tok.clone())


def _half_rows_dropped(monkeypatch):
    from repro_torch.models import transformer
    real = transformer.lora_apply

    def half(x, layer, target, idx, ranks, mode, rank_block, live):
        if idx is not None:
            idx = idx.clone()
            idx[1::2] = -1
        return real(x, layer, target, idx, ranks, mode, rank_block, None)
    monkeypatch.setattr(transformer, "lora_apply", half)


@pytest.mark.parametrize("fault", [_sample_altered, _state_unchanged,
                                   _half_rows_dropped])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = tiny_run()
    assert not out["correct"], out["checks"]


def test_new_files_are_found_without_an_edit(tmp_path):
    sb = tmp_path / "servebench"
    shutil.copytree(SB, sb, ignore=shutil.ignore_patterns("__pycache__",
                                                          "tests"))
    cfg = tiny_config("qwen2-72b-pp4")
    cfg["name"] = "tiny-model"
    (sb / "configs" / "tiny-model.json").write_text(json.dumps(cfg))
    mix = tiny_mix("chat-backlog")
    mix["prompt"].update(median=40, min=24, max=60)
    (sb / "traffic" / "tiny-mix.json").write_text(json.dumps(mix))
    (sb / "limits" / "tiny-model.tiny-mix.json").write_text(
        json.dumps({"max_logit_gap": 0.01}))
    (sb / "metrics" / "engine.requests_seen.new.py").write_text(
        "def read(ctx):\n    return float(len(ctx.reqs))\n")
    (sb / "kernels" / "newfam.json").write_text(
        json.dumps({"patterns": ["^newfam_"]}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-model", "source": "x",
                             "file": "servebench/configs/tiny-model.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny-model.tiny-mix",
                               "config": "tiny-model", "traffic": "tiny-mix",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "engine.requests_seen.new",
                               "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "engine",
                               "moves": "tokens_per_s",
                               "workloads": ["tiny-model.tiny-mix"]})
    import torch
    wl = harness.workload(bench, "tiny-model.tiny-mix")
    out = harness.run(bench, wl["name"], 3, 4.0, True, time.perf_counter(),
                      device="cpu", root=sb, log=lambda m: None)
    # the new limits file is read (a short window on a busy CPU need not
    # finish a request of every rank)
    assert out["checks"]["max_logit_gap"]["limit"] == 0.01
    assert out["checks"]["max_logit_gap"]["value"] <= 0.01
    assert out["metrics"]["engine.requests_seen.new"]["value"] > 0
    from servebench import trace
    assert "newfam" in trace.load_families(sb)
    plain = harness.run(bench, wl["name"], 3, 1.0, False,
                        time.perf_counter(), device="cpu", root=sb,
                        log=lambda m: None)
    assert set(plain["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    del torch


def test_forbidden_modules_compares_whole_top_level_names():
    mods = ["repro_torch", "repro_torch.core.engine", "jaxtyping",
            "reprolib", "servebench.cell", "numpy"]
    assert forbidden_modules(mods) == []
    assert forbidden_modules(mods + ["repro.core.engine"]) == \
        ["repro.core.engine"]
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client",
                              "flax.linen"]) == \
        ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client"]


def test_a_run_loads_nothing_of_the_jax_package():
    code = (
        "import sys, time; sys.path[:0] = ['src', '.']\n"
        "sys.path.insert(0, 'servebench/tests')\n"
        "import test_servebench_run as t\n"
        "t.tiny_run(seconds=0.5)\n"
        "from servebench.cell import forbidden_modules\n"
        "import servebench.reference.dense_lora\n"
        "print('BAD', forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout
    # the benchmark's and the reference's sources import none of it either
    for f in SB.rglob("*.py"):
        if "tests" in f.parts:
            continue
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                top = s.split()[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "repro",
                                   "benchmarks"), (f, s)


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(cuda):
    """The control at the first cell's size: with the float8 reference's
    tokens in the program's place, the run's own comparison says not
    correct, while the program's tokens on the same run read within the
    limit (one seed, a short window: what a test run on the card can
    hold)."""
    out = subprocess.run(
        [sys.executable, "servebench/calibrate.py", "--workload",
         BENCH["workloads"][0]["name"], "--seconds", "6", "--seeds",
         "2147483659"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("calibrate ")][-1]
    got = json.loads(line[len("calibrate "):])
    assert got["correct"] is False
    assert got["program_correct"] is True


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints no
    result, from the checkout and from a directory holding only the
    benchmark's files."""
    only = tmp_path / "only"
    only.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", only)
    shutil.copytree(SB, only / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, only):
        out = subprocess.run(
            [sys.executable, "servebench/run.py", "--workload",
             BENCH["workloads"][0]["name"], "--seed", "5", "--seconds",
             "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout
