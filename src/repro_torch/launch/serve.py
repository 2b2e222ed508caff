"""Serving launcher: run one CaraServe inference server of the port over a
generated trace and report the paper's three metrics.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda

The timeline is the analytic simulator, so every latency and rate printed
here is *simulated*; the tokens are computed for real on `--device`. The
scheduler-fronted cluster (`--cluster` in the reference) is not ported.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.core.engine import InferenceServer
from repro_torch.core.timing import TimingModel
from repro_torch.traces import gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model (2 layers, width 128)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mode", default="caraserve",
                    choices=["cached", "ondemand", "slora", "caraserve"])
    ap.add_argument("--kernel", default="bgmv", choices=["bgmv", "mbgmv"])
    ap.add_argument("--rps", type=float, default=6.0)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--n-adapters", type=int, default=8)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--cache-slots", type=int, default=512)
    ap.add_argument("--trace", default="maf", choices=["maf", "synthetic"])
    ap.add_argument("--slo-scale", type=float, default=1.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    serve_cfg = cfg.smoke() if args.smoke else cfg
    rng = np.random.default_rng(args.seed)
    adapters = gen.make_adapters(args.n_adapters, cfg.name, rng,
                                 uniform_rank=args.rank)
    tm = TimingModel(cfg)
    # decode-iteration SLO from the simulator: a full batch at max rank
    slo = args.slo_scale * (tm.base_decode_ms(args.max_batch)
                            + tm.lora_decode_ms([64] * args.max_batch,
                                                args.kernel))
    mk = gen.maf_trace if args.trace == "maf" else gen.synthetic_trace
    reqs = mk(adapters, rps=args.rps, duration_s=args.duration,
              vocab=serve_cfg.vocab, seed=args.seed, slo_tpt_ms=slo,
              max_prompt=args.cache_slots // 2)
    print(f"{len(reqs)} requests, simulated SLO={slo:.1f} ms/token")

    srv = InferenceServer(serve_cfg, mode=args.mode, kernel=args.kernel,
                          max_batch=args.max_batch,
                          cache_slots=args.cache_slots, seed=args.seed,
                          device=args.device)
    for ad in adapters:
        srv.register_adapter(ad)
    out = srv.run(reqs)

    print("simulated serving metrics (analytic timeline, not measured):")
    for k, v in out.items():
        print(f"  {k:16s} {v:.3f}" if isinstance(v, float) else
              f"  {k:16s} {v}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"simulated": out}, f, indent=1)


if __name__ == "__main__":
    main()
