"""The port's lint (`python -m repro_torch.analysis.lint`): each rule fires
on a minimal positive and stays silent on its negative, in a throwaway
package under tmp_path; waivers suppress and are audited; the JSON report
round-trips; and src/repro_torch lints clean with --strict-waivers."""
import json
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import lint

ROOT = Path(__file__).resolve().parents[1]

BACKEND_HEAD = """\
import torch
from repro_torch.models import layers
"""
# each rule: (rule, a hot-path body that must fire, one that must not)
CASES = {
    "item": ("host-sync", "def f(x):\n    return x.item()\n",
             "def f(x):\n    return x.shape[0]\n"),
    "to-cpu": ("host-sync", "def f(x):\n    return x.to('cpu')\n",
               "def f(x, d):\n    return x.to(d)\n"),
    "synchronize": ("host-sync",
                    "def f():\n    torch.cuda.synchronize()\n",
                    "def f():\n    torch.cuda.current_stream()\n"),
    "nonzero": ("host-sync", "def f(x):\n    return x.nonzero()\n",
                "def f(x):\n    return x.sum()\n"),
    "int-of-tensor": ("host-sync",
                      "def f():\n    t = torch.zeros(3)\n"
                      "    return int(t.sum())\n",
                      "def f():\n    t = torch.zeros(3)\n"
                      "    return int(t.shape[0])\n"),
    "if-on-tensor": ("host-sync",
                     "def f():\n    t = torch.ones(3)\n"
                     "    if (t > 0).any():\n        return 1\n",
                     "def f():\n    t = torch.ones(3)\n"
                     "    if t.dim() > 1:\n        return 1\n"),
    "upload-from-numpy": ("host-sync",
                          "def f(a, d):\n"
                          "    return torch.from_numpy(a).to(d)\n",
                          "def f(a):\n"
                          "    return torch.from_numpy(a).to(torch.float32)"
                          "\n"),
    "upload-made-with-device": ("host-sync",
                                "def f(a, d):\n"
                                "    return torch.as_tensor(a, device=d)\n",
                                "def f(a):\n    return torch.as_tensor("
                                "a, device='cpu')\n"),
    "upload-of-a-bound-name": ("host-sync",
                               "def f(a):\n    t = torch.tensor(a)\n"
                               "    return t.cuda()\n",
                               "def f(d):\n"
                               "    t = torch.zeros(3, device=d)\n"
                               "    return t.to(d)\n"),
    "reached-model-code": ("host-sync",
                           "def f(x):\n    return layers.g(x)\n",
                           "def f(x):\n    return x\n"),
    "bare-assert": ("bare-assert", "def f(x):\n    assert x\n",
                    "def f(x):\n    if not x:\n"
                    "        raise ValueError(x)\n"),
}
LAYERS = "def g(x):\n    return x.tolist()\n"


def _package(root: Path, backend: str, kernel_ref: str = "",
             kernel: str = "", extra=None) -> str:
    src = root / "src"
    files = {**(extra or {}),
             "repro_torch/__init__.py": "",
             "repro_torch/core/__init__.py": "",
             "repro_torch/core/backend.py": BACKEND_HEAD + backend,
             "repro_torch/models/__init__.py": "",
             "repro_torch/models/layers.py": LAYERS,
             "repro_torch/kernels/__init__.py": "",
             "repro_torch/kernels/ref.py": kernel_ref,
             "repro_torch/kernels/foo.py": kernel}
    for name, text in files.items():
        p = src / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return str(src)


def _rules(report):
    return sorted({f.rule for f in report.findings})


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_fires_on_positive_and_not_on_negative(tmp_path, case):
    rule, pos, neg = CASES[case]
    report = lint.run_lint_report(_package(tmp_path / "pos", pos))
    assert _rules(report) == [rule], report.findings
    where = "layers.py" if case == "reached-model-code" else "backend.py"
    assert report.findings[0].path.endswith(where)
    assert lint.run_lint_report(
        _package(tmp_path / "neg", neg)).findings == []


def test_model_code_off_the_hot_path_is_not_linted(tmp_path):
    """layers.g syncs, but nothing on the hot path reaches it."""
    assert lint.run_lint_report(
        _package(tmp_path, "def f(x):\n    return x\n")).findings == []


WRAPPER = """\
def foo(x, y):
    lib = object()
    return lib.rt_foo(x, y)


def fits(x):
    return lib.rt_foo_fits(x)
"""


@pytest.mark.parametrize("oracle,fires", [
    ("", True),                                        # missing
    ("def foo_ref(x):\n    return x\n", True),          # drifted
    ("def foo_ref(x, y):\n    return x\n", False)],     # matching
    ids=["missing", "drifted", "matching"])
def test_kernel_oracle(tmp_path, oracle, fires):
    report = lint.run_lint_report(_package(
        tmp_path, "def f(x):\n    return x\n", oracle, WRAPPER))
    assert _rules(report) == (["kernel-oracle"] if fires else [])


STEP = """\
class NumericsBackend:
    def _fused_step(self, pipe, t):
{}

    def other(self, t):
{}
"""
# the captured step's rules: (rule, a body that must fire, one that must
# not); a body is (the step's lines, other's lines), in backend.py
STEP_CASES = {
    # a host-sync waiver does not waive the captured step's rule
    "tracer-if": ("tracer-if",
                  ("        t = torch.ones(3)\n"
                   "        # lint: allow-host-sync — a designed read\n"
                   "        if (t > 0).any():\n            return t",
                   "        return t"),
                  ("        return t",
                   "        t = torch.ones(3)\n"
                   "        # lint: allow-host-sync — off the step\n"
                   "        if (t > 0).any():\n            return t")),
    "tracer-if-item": ("tracer-if",
                       ("        t = torch.ones(3)\n"
                        "        # lint: allow-host-sync — a designed read\n"
                        "        return t.sum().item()",
                        "        return t"),
                       ("        t = torch.ones(3)\n"
                        "        return t.sum()",
                        "        return t")),
    "rebind-pipe": ("donated-reuse",
                    ("        pipe.last_tok = t", "        return t"),
                    ("        pipe.last_tok.copy_(t)", "        return t")),
    "rebind-cache": ("donated-reuse",
                     ("        return t", "        self.cache = t"),
                     ("        return t", "        self.cache[0] += t")),
    "rebind-pool-leaf": ("donated-reuse",
                         ("        return t",
                          "        self.pool.pool['q']['a'] = t"),
                         ("        return t",
                          "        self.pool.pool['ranks'][t] = 3")),
    "rebind-static-input": ("donated-reuse",
                            ("        return t", "        si.flat = t"),
                            ("        return t", "        si.flat.copy_(t)")),
    "rebind-static-input-view": ("donated-reuse",
                                 ("        return t",
                                  "        si.views['tokens'] = t"),
                                 ("        return t",
                                  "        si.views['tokens'][0] = t")),
    "rebind-staging-pool-leaf": ("donated-reuse",
                                 ("        return t",
                                  "        self.stage['q']['a'] = t"),
                                 ("        return t",
                                  "        self.stage['q']['a'][t] = 3")),
    "rebind-trainer-adapter": ("donated-reuse",
                               ("        return t",
                                "        trainer.adapter = t"),
                               ("        return t",
                                "        trainer.adapter['q']['a'].copy_(t)")),
    "capture-outside-graphs": ("jit-spec",
                               ("        return torch.cuda.CUDAGraph()",
                                "        return t"),
                               ("        return t", "        return t")),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_captured_step_rules(tmp_path, case):
    rule, pos, neg = STEP_CASES[case]
    report = lint.run_lint_report(_package(tmp_path / "pos",
                                           STEP.format(*pos)))
    assert _rules(report) == [rule], report.findings
    assert report.findings[0].path.endswith("backend.py")
    report = lint.run_lint_report(_package(tmp_path / "neg",
                                           STEP.format(*neg)))
    assert report.findings == [], report.findings


CAPTURED = """\
class {}:
    def {}(self, t):
        t = torch.ones(3)
        # lint: allow-host-sync — a designed read
        if (t > 0).any():
            return t
"""


@pytest.mark.parametrize("where,cls,method", [
    ("core/backend.py", "NumericsBackend", "_prefill_step"),
    ("core/backend.py", "NumericsBackend", "_chunk_step"),
    ("launch/train.py", "Trainer", "_captured_step")])
def test_tracer_if_covers_every_captured_step(tmp_path, where, cls,
                                              method):
    """The prefill, chunk and training graphs' closures are roots of the
    captured-step rules, as the decode step is."""
    body = CAPTURED.format(cls, method)
    if where == "core/backend.py":
        root = _package(tmp_path, body)
    else:
        root = _package(tmp_path, "def f(x):\n    return x\n", extra={
            "repro_torch/launch/__init__.py": "",
            "repro_torch/launch/train.py": "import torch\n\n\n" + body})
    report = lint.run_lint_report(root)
    assert _rules(report) == ["tracer-if"], report.findings
    assert report.findings[0].path.endswith(where.split("/")[-1])


def test_capture_in_core_graphs_and_init_allocations_pass(tmp_path):
    """core/graphs.py is where captures go; __init__ allocates the step's
    buffers."""
    graphs = "import torch\n\n\ndef g():\n    return torch.cuda.CUDAGraph()\n"
    init = ("class DecodePipeline:\n    def __init__(self, t):\n"
            "        self.last_tok = t\n        self.pos = t\n")
    report = lint.run_lint_report(_package(
        tmp_path, init, extra={"repro_torch/core/graphs.py": graphs}))
    assert report.findings == []


def test_waivers_suppress_and_are_audited(tmp_path):
    body = ("def f(x):\n"
            "    # lint: allow-host-sync — the designed readback\n"
            "    a = x.item()\n"
            "    b = x.tolist()  # lint: allow-host-sync\n"
            "    # lint: allow-host-sync — nothing syncs here\n"
            "    return a, b, x.shape\n")
    report = lint.run_lint_report(_package(tmp_path, body))
    assert report.findings == []
    assert len(report.waived) == 2
    audit = sorted((f.line, f.message) for f in report.unused_waivers)
    assert [m.split(" ")[-1] for _, m in audit] == ["reason", "marker"]
    assert "gives no reason" in audit[0][1]
    assert "matched no finding" in audit[1][1]


def test_json_report_round_trips(tmp_path):
    out = tmp_path / "lint.json"
    rc = lint.main([str(ROOT / "src"), "--json", str(out)])
    payload = json.loads(out.read_text())
    assert rc == payload["exit"] == 0
    back = lint.LintReport.from_dict(payload)
    assert back.to_dict() == {k: payload[k] for k in
                              ("findings", "waived", "unused_waivers")}
    assert back == lint.run_lint_report(str(ROOT / "src"),
                                        [str(ROOT / "src")])


def test_cli_refuses_a_missing_path(tmp_path):
    """A path that does not exist would filter every finding away."""
    with pytest.raises(SystemExit):
        lint.main([str(tmp_path / "no-such-dir")])


def test_the_port_lints_clean_with_strict_waivers(capsys):
    """No finding, no stale waiver, a reason on every waiver; the designed
    syncs are the waived ones: the readback drain, the per-step pipeline's
    readback and swap-out (the backend's step metadata, and the rows and
    page ids of the cache's writes, go up through pinned staging, without
    a sync); the one designed rebinding is a trainer's batch buffer for a
    batch of a new shape (a new signature of the step)."""
    assert lint.main([str(ROOT / "src"), "--strict-waivers"]) == 0
    report = lint.run_lint_report()
    sites = sorted({(Path(f.path).name, f.rule) for f in report.waived})
    assert sites == [("backend.py", "host-sync"), ("cache.py", "host-sync"),
                     ("train.py", "donated-reuse")]
    names = {f.message.split("(in ")[1].split(",")[0]
             for f in report.waived if f.rule == "host-sync"}
    assert names == {"DecodePipeline._drain_one",
                     "NumericsBackend._decode_perstep", "extract_pages"}
