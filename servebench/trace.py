"""Spans around the calls into the port's layers, recorded from the
benchmark's own code, and the device trace of a span of the window.

`Recorder.wrap(backend)` replaces the backend's entry points (prefill,
chunk, decode, megastep) with wrappers that, around each call, take the
host clock, record a CUDA event on the stream at its start and end (no
host synchronization added: a copy of `chip_smoke.time_backend_calls`),
name the call for the profiler (`record_function("sb.<kind>")`), and keep
what the call computed (rows, positions, ranks, adapters) for the FLOP
and byte counts. `Recorder.profile_*` runs `torch.profiler` (CUPTI) over
a fixed span of the window, synchronized at both ends, and reads its
Chrome trace: every kernel, copy and fill on the device, each attributed
to the backend call whose host range launched it (through the launch's
correlation id), and the host range that covered each idle gap.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Call:
    kind: str                  # prefill | chunk | decode
    host_start: float
    host_end: float
    events: object             # (start, end) CUDA events, or None
    rows: list                 # prefill: (tokens, rank); decode: (pos, rank, n)
    adapters: list
    iters: int                 # decode iterations (megastep: K)
    in_profile: bool = False

    def device_ms(self) -> Optional[float]:
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])


@dataclasses.dataclass
class Kernel:
    name: str
    start: float               # us, the trace's clock
    end: float
    call: str                  # the backend call kind that launched it, or ""


@dataclasses.dataclass
class Profile:
    window_s: float
    busy_s: float
    kernels: List[Kernel]
    gaps: Dict[str, float]     # idle seconds by the host range covering them


def load_families(root: Path = HERE) -> Dict[str, List[re.Pattern]]:
    """Kernel families: `servebench/kernels/<family>.json`, each
    {"patterns": [regex, ...], "order": n} over kernel symbol names; a
    name takes the first family that matches, by (order, name), order 0
    unless given (the catch-alls come last)."""
    found = []
    for f in (root / "kernels").glob("*.json"):
        d = json.loads(f.read_text())
        found.append((d.get("order", 0), f.stem,
                      [re.compile(p) for p in d["patterns"]]))
    return {name: pats for _, name, pats in sorted(found, key=lambda x: x[:2])}


def family_of(name: str, families) -> str:
    for fam, pats in families.items():
        if any(p.search(name) for p in pats):
            return fam
    return "other"


class Recorder:
    def __init__(self, torch, server, rank_of: Dict[str, int]):
        self.torch = torch
        self.server = server
        self.rank_of = rank_of
        self.calls: List[Call] = []
        self.steps: List[Tuple[float, float]] = []
        self.profiling = False
        self.prof = None
        self.profile: Optional[Profile] = None
        self.cuda = server.backend.device.type == "cuda"

    # ------------------------------------------------------------ spans ----
    def wrap(self):
        be = self.server.backend
        adm = self.server.admission
        rank = self.rank_of

        def prefill_rows(states):
            return [(st.req.prompt_len, rank[st.req.adapter_uid])
                    for st in states], \
                [st.req.adapter_uid for st in states], 0

        def chunk_rows(st, row_pages, start, n, final):
            return [(n, rank[st.req.adapter_uid])], [st.req.adapter_uid], 0

        def decode_rows(ready, *a, **kw):
            return [(int(adm.row_pos[st.row]), rank[st.req.adapter_uid], 1)
                    for st in ready], [st.req.adapter_uid for st in ready], 1

        def mega_rows(ready, nsteps, K, *a, **kw):
            return [(int(adm.row_pos[st.row]), rank[st.req.adapter_uid], n)
                    for st, n in zip(ready, nsteps)], \
                [st.req.adapter_uid for st in ready], K

        for attr, kind, rows in (("prefill_admitted", "prefill", prefill_rows),
                                 ("prefill_chunk", "chunk", chunk_rows),
                                 ("decode", "decode", decode_rows),
                                 ("megastep", "decode", mega_rows)):
            setattr(be, attr, self._timed(getattr(be, attr), kind, rows))

    def _timed(self, fn, kind, rows):
        torch = self.torch

        def run(*a, **kw):
            r, ads, iters = rows(*a, **kw)
            ev = None
            with torch.profiler.record_function(f"sb.{kind}"):
                t0 = time.perf_counter()
                if self.cuda:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                out = fn(*a, **kw)
                if ev is not None:
                    ev[1].record()
                t1 = time.perf_counter()
            self.calls.append(Call(kind, t0, t1, ev, r, ads, iters,
                                   self.profiling))
            return out
        return run

    @contextlib.contextmanager
    def span(self, name: str):
        with self.torch.profiler.record_function(name):
            yield

    # ---------------------------------------------------------- profile ----
    def profiler_init(self):
        """Start and stop the profiler once in set-up: its first start
        (CUPTI's initialisation) takes seconds."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if self.cuda else [])
        with profile(activities=acts):
            torch.ones(8, device=self.server.backend.device).sum()

    def profile_start(self):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.start()
        self._span = torch.profiler.record_function("sb.profile")
        self._span.__enter__()
        self.profiling = True

    def profile_stop(self):
        if self.cuda:
            self.torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.prof.stop()
        self.profiling = False

    def read_profile(self):
        """Export and read the span's trace (after the window: the export
        takes seconds)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        self.profile = read_trace(trace)


def read_trace(trace: dict) -> Profile:
    """A Kineto Chrome trace -> the device's kernels, each attributed to
    the `sb.<kind>` host range that launched it, the busy time, and the
    idle gaps labelled by the innermost `sb.*` host range at their
    start."""
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    ranges, launches, device = [], {}, []
    span = None
    for e in evs:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and e["name"].startswith("sb."):
            if e["name"] == "sb.profile":
                span = (ts, ts + dur)
            else:
                ranges.append((ts, ts + dur, e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(e)
    if span is None:
        raise RuntimeError("the trace holds no sb.profile range")
    calls = sorted((s, e, n) for s, e, n in ranges
                   if n[3:] in ("prefill", "chunk", "decode"))
    starts = [c[0] for c in calls]

    def call_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and calls[i][0] <= t <= calls[i][1]:
            return calls[i][2][3:]
        return ""

    kernels = []
    for e in device:
        s = max(float(e["ts"]), span[0])
        end = min(float(e["ts"]) + float(e.get("dur", 0.0)), span[1])
        if end <= s:
            continue
        corr = e.get("args", {}).get("correlation")
        t = launches.get(corr)
        kernels.append(Kernel(e["name"], s, end,
                              call_at(t) if t is not None else ""))
    busy = sorted((k.start, k.end) for k in kernels)
    merged: List[List[float]] = []
    for s, e in busy:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    gaps: Dict[str, float] = {}
    edges = [span[0]] + [x for m in merged for x in m] + [span[1]]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            lab = _innermost(ranges, g0)
            gaps[lab] = gaps.get(lab, 0.0) + (g1 - g0) / 1e6
    return Profile((span[1] - span[0]) / 1e6, busy_us / 1e6, kernels, gaps)


def _innermost(ranges, t) -> str:
    best = None
    for s, e, n in ranges:
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    return best[2] if best else "harness loop (outside any sb.* range)"
