"""Serving launcher: run one CaraServe inference server of the port (or a
scheduler-fronted cluster) over a generated trace and report the paper's
three metrics.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
      --arch dbrx-132b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --cluster 4 \\
      --policy rank_aware

`--arch` names a config the port serves: llama2-7b (default), llama2-13b,
llama2-70b, yi-9b, qwen2-72b, command-r-35b, mistral-large-123b, the
MoE configs dbrx-132b and grok-1-314b, phi-3-vision-4.2b (text-only
requests, as the reference's server sends), recurrentgemma-2b and
mamba2-130m (on the dense plane). One card holds llama2-13b and the last
three whole; the larger ones fit it only with `--smoke` or cut in depth.
whisper-tiny is refused on one server: a request carries no encoder
input (it runs through `models.model.prefill` / `decode`); a timing-only
`--cluster` takes it.

The timeline is the analytic simulator, so every latency and rate printed
here is *simulated*. On one server the tokens are computed for real on
`--device`. `--cluster N` runs N timing-only servers (no numerics, no
device) behind the rank-aware router or a baseline (`--policy`), as the
reference's cluster does.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.core.cluster import Cluster
from repro_torch.core.engine import InferenceServer
from repro_torch.core.perf_model import ServerPerfModel
from repro_torch.core.scheduler import make_scheduler
from repro_torch.traces import gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model (2 layers, width 128)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where one server computes its tokens")
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
    ap.add_argument("--cluster", type=int, default=0,
                    help="run N servers behind the scheduler (timing-only)")
    ap.add_argument("--policy", default="rank_aware",
                    choices=["rank_aware", "most_idle", "first_fit",
                             "random"])
    ap.add_argument("--slo-scale", type=float, default=1.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.family in ("audio", "encdec") and not args.cluster:
        ap.error(f"{cfg.name} is an encoder-decoder model: a served request "
                 "carries tokens only, not the encoder input (enc_embeds) "
                 "its prefill needs; drive it through models.model.prefill "
                 "/ decode, or time it with --cluster")
    serve_cfg = cfg.smoke() if args.smoke else cfg
    rng = np.random.default_rng(args.seed)
    adapters = gen.make_adapters(args.n_adapters, cfg.name, rng,
                                 uniform_rank=args.rank)
    # decode-iteration SLO from the router's performance model (Algorithm
    # 1's DecPerf): a full batch at max rank
    perf = ServerPerfModel(cfg, kernel=args.kernel)
    slo = args.slo_scale * perf.dec_perf([64] * args.max_batch)
    mk = gen.maf_trace if args.trace == "maf" else gen.synthetic_trace
    # one server holds each prompt in its KV rows; timing-only cluster
    # servers hold none, so their prompts keep the trace's own lengths
    kw = {} if args.cluster else {"max_prompt": args.cache_slots // 2}
    reqs = mk(adapters, rps=args.rps, duration_s=args.duration,
              vocab=serve_cfg.vocab, seed=args.seed, slo_tpt_ms=slo, **kw)
    print(f"{len(reqs)} requests, simulated SLO={slo:.1f} ms/token")

    if args.cluster:
        servers = []
        for _ in range(args.cluster):
            srv = InferenceServer(cfg, mode=args.mode, kernel=args.kernel,
                                  max_batch=args.max_batch, hw=perf.hw,
                                  numerics=False)
            for ad in adapters:
                srv.register_adapter(ad)
            servers.append(srv)
        sched = make_scheduler(args.policy, perf, slo_ms=slo) \
            if args.policy == "rank_aware" else make_scheduler(args.policy)
        out, _ = Cluster(servers, sched).run(reqs)
    else:
        srv = InferenceServer(serve_cfg, mode=args.mode, kernel=args.kernel,
                              max_batch=args.max_batch,
                              cache_slots=args.cache_slots, seed=args.seed,
                              hw=perf.hw, device=args.device)
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
