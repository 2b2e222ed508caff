"""Readings for a cell's limit: runs of the cell, each followed by the
check with its control in the program's place (the float8 reference's
first choices at the same prompts and served tokens), one process,
several seeds. `correct` is the control's: the comparison has to fail it.

    python3 servebench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Prints one line a seed: the program's widest logit gap, the control's,
the control's `correct` and the program's, and the run's end-to-end
metrics. The benchmark's own runs never run the
control.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from servebench import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_benchmark(ROOT)
    t = T_PROCESS
    for seed in args.seeds:
        out = harness.run(bench, args.workload, seed, args.seconds, False, t,
                          control=True, log=lambda m: print(m, flush=True))
        print("calibrate " + json.dumps(
            {"workload": args.workload, "seed": seed,
             "program_max_logit_gap": out["program_max_logit_gap"],
             "control_max_logit_gap": out["checks"]["max_logit_gap"]["value"],
             "correct": out["correct"],
             "program_correct": out["program_correct"],
             "metrics": out["metrics"],
             "memory_peak_bytes": out["device"]["memory_peak_bytes"]}),
            flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
