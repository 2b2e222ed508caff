"""Fault-injection plane: seeded, scripted failures for the cluster
simulator (the CaraServe reproduction's chaos harness).

The fleet so far was fair-weather: servers never died, uploads never
failed, links never degraded. This module scripts exactly those events —
fully deterministically, so a chaos run is as replayable as a fault-free
one — and the cluster/engine recovery paths (crash drain + failover
re-admission via drop-and-recompute, upload retry with backoff, CPU-assist
degraded decode, SLO shedding) are what the injected faults exercise.

Fault model (fail-stop + transient):

  * ``crash`` / ``restart`` — fail-stop loss of one server: its device
    state (KV pages, adapter pool, in-flight uploads) vanishes; queued and
    in-flight requests are drained back to the router and re-admitted on
    surviving replicas. ``restart`` brings the server back empty; the
    cluster re-registers its placement-hosted adapters and warms the
    hottest through the normal prefetch path (warm rejoin, not cold).
  * ``upload_flaky`` — a window during which uploads *retiring* on a
    server's host link fail with probability ``fail_prob``. Failures are
    decided by a content hash (seed, server, uid, attempt, seq), not by
    draw order, so the decision set is independent of event interleaving.
  * ``brownout`` — a window scaling a server's host-link transfer times
    by ``slowdown`` (the `LoadTracker` applies it to every transfer that
    *starts* inside the window).

Crash/restart events ride the cluster event heap (kind ``FAULT``, ordered
before same-time arrivals); the window faults are installed up front on
each server's ``LoadTracker`` by ``attach()`` — windows are pure functions
of time, so nothing about them needs to be event-driven.

``log`` records every applied fault and every injected upload failure in
event order: two same-seed runs must produce byte-identical logs
(the determinism gate of the fault tests).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import List, Sequence, Tuple

FAULT_KINDS = ("crash", "restart", "upload_flaky", "brownout")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault. Point faults (crash/restart) fire at ``t_ms``;
    window faults (upload_flaky/brownout) are active on
    ``[t_ms, until_ms)``."""
    t_ms: float
    kind: str
    server: int
    until_ms: float = 0.0       # window faults: end of the window
    fail_prob: float = 0.0      # upload_flaky: P(one retirement fails)
    slowdown: float = 1.0       # brownout: transfer-time multiplier

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind in ("upload_flaky", "brownout") \
                and self.until_ms <= self.t_ms:
            raise ValueError(
                f"{self.kind} window must end after it starts "
                f"({self.t_ms} .. {self.until_ms})")
        if self.kind == "upload_flaky" \
                and not 0.0 <= self.fail_prob <= 1.0:
            raise ValueError(f"fail_prob must be in [0, 1], "
                             f"got {self.fail_prob}")
        if self.kind == "brownout" and self.slowdown < 1.0:
            raise ValueError(
                f"brownout slows the link down (slowdown >= 1.0), "
                f"got {self.slowdown}")


def _unit(seed: int, *parts) -> float:
    """Deterministic unit-interval draw from a content hash — independent
    of evaluation order, so two runs (or a run and its replay) agree on
    every failure decision without sharing RNG state."""
    key = ":".join(str(p) for p in (seed,) + parts).encode()
    return zlib.crc32(key) / 2.0 ** 32


class FaultPlane:
    """A scripted fault schedule plus the hooks that inject it.

    * ``timed_events()`` — the crash/restart events the cluster pushes on
      its heap (kind ``FAULT``).
    * ``attach(cluster)`` — installs the window faults: per-server
      upload-failure hooks and brownout windows on each ``LoadTracker``.
    * ``record(...)``/``log`` — the applied-fault timeline; the cluster
      appends crash/restart/failover entries, the upload hook appends
      every injected failure. Same seed + same trace => identical log.
    """

    def __init__(self, events: Sequence[FaultEvent], seed: int = 0):
        self.events = sorted(events,
                             key=lambda e: (e.t_ms, e.server, e.kind))
        self.seed = seed
        self.log: List[Tuple] = []
        self.stats = {"upload_failures": 0}

    # ---------------------------------------------------------- views ----
    def timed_events(self) -> List[FaultEvent]:
        """Point faults for the event heap (crash/restart)."""
        return [e for e in self.events
                if e.kind in ("crash", "restart")]

    def windows(self, kind: str, server: int) -> List[FaultEvent]:
        return [e for e in self.events
                if e.kind == kind and e.server == server]

    # ------------------------------------------------------- recording ----
    def record(self, t_ms: float, kind: str, server: int, detail: str = ""):
        self.log.append((round(float(t_ms), 6), kind, int(server), detail))

    # ------------------------------------------------------ installation ----
    def attach(self, cluster):
        """Install the window faults on every server's link tracker. The
        cluster calls this once at the start of ``run()`` — re-attaching
        (a second ``run`` on the same cluster) is idempotent."""
        for i, srv in enumerate(cluster.servers):
            tr = srv.cold.tracker
            tr.brownouts = [(w.t_ms, w.until_ms, w.slowdown)
                            for w in self.windows("brownout", i)]
            flaky = self.windows("upload_flaky", i)
            tr.fail_hook = self._hook(i, flaky) if flaky else None
            # deterministic per-server backoff jitter stream
            tr.retry_seed = self.seed * 1_000_003 + i

    def _hook(self, server: int, windows: Sequence[FaultEvent]):
        def fails(ev) -> bool:
            for w in windows:
                if w.t_ms <= ev.finish_ms < w.until_ms:
                    if _unit(self.seed, server, ev.uid, ev.attempt,
                             ev.seq) < w.fail_prob:
                        self.stats["upload_failures"] += 1
                        self.record(ev.finish_ms, "upload_fail", server,
                                    f"{ev.uid}#a{ev.attempt}")
                        return True
            return False
        return fails


def chaos_schedule(n_servers: int, duration_ms: float, seed: int = 0,
                   n_crashes: int = 1, downtime_ms: float = 1500.0,
                   fail_prob: float = 0.4,
                   slowdown: float = 3.0) -> List[FaultEvent]:
    """Canned deterministic chaos scenario for benches/tests:
    ``n_crashes`` crash+restart pairs in the middle 40% of the run (victims
    drawn from servers 1..N-1, so server 0 — which carries the brownout —
    always survives), fleet-wide flaky uploads over the middle 60%, and
    one browned-out link on server 0."""
    if n_servers < 1:
        raise ValueError("need at least one server")
    evs: List[FaultEvent] = []
    for c in range(n_crashes):
        if n_servers > 1:
            victim = 1 + int(_unit(seed, "victim", c) * (n_servers - 1))
            victim = min(victim, n_servers - 1)
        else:
            victim = 0
        t = duration_ms * (0.3 + 0.4 * _unit(seed, "crash_t", c))
        evs.append(FaultEvent(t, "crash", victim))
        evs.append(FaultEvent(t + downtime_ms, "restart", victim))
    if fail_prob > 0.0:
        for i in range(n_servers):
            evs.append(FaultEvent(duration_ms * 0.2, "upload_flaky", i,
                                  until_ms=duration_ms * 0.8,
                                  fail_prob=fail_prob))
    if slowdown > 1.0:
        evs.append(FaultEvent(duration_ms * 0.4, "brownout", 0,
                              until_ms=duration_ms * 0.7,
                              slowdown=slowdown))
    return evs
