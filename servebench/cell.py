"""One run of one cell: set-up, warm-up, the measured window driven by the
host's wall clock, and the check.

The window drives the port's `InferenceServer.submit` and `.step` as a
backlog: before each `step()` the queue is topped up to at least
`max_batch` requests beyond the free rows, each submitted with
`arrival_ms` set to the server's clock, so the virtual admission gate
never holds one back. The server's virtual clock stays the engine's
internal clock and no metric reads it. After each `step()` every token
newly in a request's `generated` list is stamped with
`time.perf_counter()` (the port reads tokens back one step behind the
dispatch, so that is when a user would see it). The rows are filled
before the window, PREROLL_ROWS a step (set-up), so the window opens on
full rows.
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from servebench import gen, stats
from servebench.model_config import ModelSpec, load_spec

HERE = Path(__file__).resolve().parent
# the JAX package and the libraries it runs on: none may be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# rows a pre-roll step fills, a few at a time as the window admits them
PREROLL_ROWS = 8
# the largest eager prefill warmed (its allocations stay cached)
WARM_EAGER_TOKENS = 16384


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (the part before the first
    dot) is, as a whole word, one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


class Cell:
    """The parts of a run, step by step (see `run`)."""

    def __init__(self, workload: dict, seed: int, seconds: float, *,
                 device: str = "cuda",
                 spec: Optional[ModelSpec] = None, mix: Optional[dict] = None,
                 root: Path = HERE, log: Callable = print):
        import torch
        self.torch = torch
        self.name = workload["name"]
        self.spec = spec or load_spec(workload["config"], root)
        self.mix = mix or gen.load_mix(workload["traffic"], root)
        self.srv = self.mix["server"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.root = root
        self.log = log
        self.setup: Dict[str, float] = {}
        self.traffic = gen.Traffic(self.mix, self.spec.vocab, self.seed)
        self.rank_of = gen.rank_of(self.mix)
        if self.traffic.longest_context() > self.srv["cache_slots"]:
            raise ValueError(
                f"{self.name}: a context of {self.traffic.longest_context()}"
                f" tokens does not fit {self.srv['cache_slots']} cache slots")
        self.reqs: List[stats.Tracked] = []
        self.live: List[stats.Tracked] = []
        self.recorder = None

    # ----------------------------------------------------------- set-up ----
    def _lap(self, key: str, t: float) -> float:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        now = time.perf_counter()
        self.setup[key] = now - t
        return now

    def build(self, t: float) -> float:
        """Kernels, weights, adapters and the server."""
        torch = self.torch
        from repro_torch.core.engine import InferenceServer
        from repro_torch.core.lora import AdapterSpec
        from servebench import weights as wmod
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.library()
        t = self._lap("kernels", t)
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        self.weights = wmod.make_weights(self.spec, g, self.device)
        t = self._lap("weights", t)
        self.adapters = wmod.make_adapters(self.spec, self.traffic.adapters,
                                           g, self.device)
        t = self._lap("adapters", t)
        cfg = self.spec.port_config()
        s = self.srv
        self.server = InferenceServer(
            cfg, mode=s["mode"], kernel=s["kernel"],
            max_batch=s["max_batch"], cache_slots=s["cache_slots"],
            params=wmod.port_params(self.weights), pipeline=s["pipeline"],
            megastep=s["megastep"], memory=s["memory"],
            page_size=s["page_size"], chunk_budget=s["chunk_budget"],
            device=self.device, graphs=s["graphs"])
        # the store has no public entry that takes weights: its maps
        store = self.server.store
        for a in self.traffic.adapters:
            store.specs[a.uid] = AdapterSpec(a.uid, a.rank, cfg.name)
            store._weights[a.uid] = self.adapters[a.uid]
            store.registered_ms[a.uid] = 0.0
        return self._lap("server", t)

    def _serve(self, reqs) -> None:
        srv = self.server
        for r in reqs:
            r.arrival_ms = srv.clock
            srv.submit(r)
        while srv.busy():
            srv.step()
        srv.backend.flush_readback()

    def warm(self, t: float) -> float:
        """Every prefill bucket of this mix that runs as a graph, twice (a
        key's first call runs eagerly, its second is captured); the
        largest eager bucket of at most WARM_EAGER_TOKENS once (the
        allocator's high-water mark). Requests of one adapter, zero
        tokens, two new tokens."""
        from repro_torch.serving.request import Request
        be = self.server.backend
        s = self.srv
        ad = self.traffic.adapters[0].uid
        rid = [-1]

        def reqs(nb, lp, new=2):
            out = []
            for _ in range(nb):
                out.append(Request(rid[0], ad, np.zeros(lp, np.int32), new))
                rid[0] -= 1
            return out

        buckets = gen.prefill_buckets(self.mix, s["max_batch"],
                                      s["cache_slots"])
        graphed = [b for b in buckets if b[0] * b[1] <= be.graph_tokens]
        for nb, lp in graphed:
            for _ in range(2):
                self._serve(reqs(nb, lp))
        eager = [b for b in buckets if be.graph_tokens < b[0] * b[1]
                 <= WARM_EAGER_TOKENS]
        if eager:
            self._serve(reqs(*max(eager, key=lambda b: b[0] * b[1])))
        t = self._lap("warmup", t)
        st = be.graphs.stats()
        self.setup["captures_s"] = sum(sum(v["capture_s"])
                                       for v in st.values())
        self.warm_keys = {k for k, v in st.items() if v["captures"]}
        return t

    # ----------------------------------------------------------- window ----
    def _submit(self, p: gen.Planned) -> stats.Tracked:
        if self.recorder is not None:
            with self.recorder.span("sb.submit"):
                return self._submit_now(p)
        return self._submit_now(p)

    def _submit_now(self, p: gen.Planned) -> stats.Tracked:
        from repro_torch.serving.request import Request
        tr = stats.Tracked(p.rid, p.adapter, self.rank_of[p.adapter],
                           len(p.prompt), p.max_new, time.perf_counter())
        req = Request(p.rid, p.adapter, p.prompt, p.max_new,
                      arrival_ms=self.server.clock)
        try:
            tr.state = self.server.submit(req)
            self.live.append(tr)
        except ValueError as e:
            tr.failed = True
            self.log(f"submit refused request {p.rid}: {e}")
        self.reqs.append(tr)
        return tr

    def _stamp(self) -> None:
        if self.recorder is not None:
            with self.recorder.span("sb.stamp"):
                return self._stamp_now()
        return self._stamp_now()

    def _stamp_now(self) -> None:
        now = time.perf_counter()
        keep = []
        for tr in self.live:
            n = len(tr.state.generated)
            if n > len(tr.stamps):
                tr.stamps.extend([now] * (n - len(tr.stamps)))
            if not tr.done:
                keep.append(tr)
        self.live = keep

    def _step(self) -> None:
        rec = self.recorder
        if rec is None:
            self.server.step()
        else:
            t0 = time.perf_counter()
            with rec.span("sb.step"):
                self.server.step()
            rec.steps.append((t0, time.perf_counter()))
        self._stamp()

    def preroll(self, t: float) -> float:
        """Fill the rows, PREROLL_ROWS a step."""
        self._stream = self.traffic.stream()
        for _ in range(-(-self.srv["max_batch"] // PREROLL_ROWS)):
            for _ in range(PREROLL_ROWS):
                self._submit(next(self._stream))
            self._step()
        return self._lap("preroll", t)

    def window(self) -> None:
        rec = self.recorder
        srv = self.server
        mb = self.srv["max_batch"]
        span = self.mix.get("trace_span_s", 2.0)
        self.t0 = time.perf_counter()
        self.t1 = self.t0 + self.seconds
        # the traced span is the window's last `span` seconds, so that
        # what stopping the profiler costs falls on nothing measured; a
        # traced run's window is stretched to give the span its length
        self.t_prof = self.t1 - min(span, self.seconds / 2)
        profiling = False
        while True:
            now = time.perf_counter()
            if now >= self.t1:
                break
            if rec is not None and not profiling and now >= self.t_prof:
                rec.profile_start()
                profiling = True
                self.t1 = max(self.t1, time.perf_counter()
                              + min(span, self.seconds / 2))
            free = sum(r is None for r in srv.rows)
            while len(srv.queue) < mb + free:
                self._submit(next(self._stream))
            self._step()
        if profiling:
            rec.profile_stop()
        self.t_close = time.perf_counter()

    # ------------------------------------------------------------- after ----
    def e2e(self) -> Dict[str, float]:
        t0, t1 = self.t0, self.t1
        return {
            "tokens_per_s": stats.tokens_per_s(self.reqs, t0, t1),
            "tpot_p90_ms": stats.tpot_p90_ms(self.reqs, t0, t1),
        }

    def attempted(self) -> int:
        return sum(1 for r in self.reqs if self.t0 <= r.submitted <= self.t1)

    def failed(self) -> int:
        return sum(1 for r in self.reqs
                   if r.failed and self.t0 <= r.submitted <= self.t1)

    def finished(self) -> List[stats.Tracked]:
        return [r for r in self.reqs if r.done and not r.failed
                and r.stamps[-1] <= self.t_close]

    def free_program(self) -> None:
        """Drop the server and everything it holds on the device; the
        benchmark's weights and adapters stay."""
        self.server.backend.flush_readback()
        if self.recorder is not None:
            self.recorder.server = None
        for r in self.reqs:
            if r.state is not None:
                r.state.kv_pages = []
        self.server = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
