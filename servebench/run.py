"""The port's serving benchmark: one run of one cell.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration
(`servebench/configs/`), its traffic mix (`servebench/traffic/`), its
per-layer metrics (`servebench/metrics/`) and its limits
(`servebench/limits/`) are found by their names in `BENCHMARK.json`. The
last line of standard output is the result; progress goes to earlier
lines, and the numbers compared with their limits to the last lines of
standard error. Without a CUDA device, or with fewer than the cell asks
for, the run exits with code 2 and prints no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from servebench import harness

    bench = harness.load_benchmark(ROOT)
    wl = harness.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        out = harness.run(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), T_PROCESS,
                          log=lambda m: print(m, flush=True))
    except harness.RunError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    from servebench.cell import forbidden_modules
    bad = forbidden_modules()
    if bad:
        print("no result: modules of the JAX package or its libraries "
              "loaded: " + ", ".join(bad), file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
