"""Env-gated runtime sanitizers for the port's serving hot paths.

Enable with ``REPRO_SANITIZE=1`` (or `force(True)` in tests). All hooks are
installed at construction time of the instrumented objects — when disabled,
the production code carries a ``None`` attribute and a falsy branch, nothing
else.

* **PageSan** — shadow ownership map over ``serving.cache.PageAllocator``.
  Detects double-claim (a page handed out while the shadow map says it is
  live), double-free (freeing a page the shadow map says is dead — even if
  the allocator's own book-keeping was corrupted back to "owned"),
  use-after-free (touching a freed page before re-claim; freed pages are
  *quarantined* — kept out of the free list until capacity pressure — so
  stale block-table entries keep pointing at dead pages long enough to be
  caught), and KV/adapter aliasing (a page reached through a KV block table
  while owned by an adapter, or vice versa). Quarantine is capacity-neutral:
  ``free_pages`` counts quarantined pages and ``claim`` recycles them
  (oldest first) under pressure, so allocator-visible accounting is
  identical with and without the sanitizer.

* **LinkSan** — happens-before checker over ``core.cold_start.LoadTracker``.
  Asserts the scheduled link's invariants after every mutation: queued
  uploads carry a self-consistent provisional schedule, started uploads are
  frozen (start/finish never move once a lane took them), retired finish
  times are monotone non-decreasing (globally, hence per class), and under
  the ``preempt`` policy a manager-mediated demand upload is never delayed
  behind queued speculative prefetch (the ``demand_delayed_by_prefetch``
  counter must not move, and no queued prefetch may survive the begin).
  The failure plane (``core/faults.py``) adds two retry-aware
  happens-before rules: a retried upload must be *requested* after — and
  retire strictly past — the failed attempt's finish, and an upload
  canceled by a crash (or failed outright) must never retire.

A copy of `repro.analysis.sanitizers`, changed only in its imports. The
third sanitizer, RetraceSan (`analysis.retrace`), watches the decode
step's CUDA graphs for a re-capture after steady state, where the
reference's watches jit trace caches.
"""
from __future__ import annotations

import contextlib
import os
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Tuple

_EPS = 1e-6

_FORCED: Optional[bool] = None


def enabled() -> bool:
    """True when the sanitizers should be active (REPRO_SANITIZE=1, or a
    `force(...)` override in tests)."""
    if _FORCED is not None:
        return _FORCED
    return os.environ.get("REPRO_SANITIZE", "") == "1"


@contextlib.contextmanager
def force(on: bool):
    """Override the env gate for the duration of a test block."""
    global _FORCED
    prev = _FORCED
    _FORCED = on
    try:
        yield
    finally:
        _FORCED = prev


class SanitizerError(RuntimeError):
    """Base class for every sanitizer violation."""


class PageSanError(SanitizerError, ValueError):
    """Also a ValueError: the allocator's own double-free check raises
    ValueError, and enabling the sanitizer must sharpen the diagnostic
    without changing the exception contract callers rely on."""


class LinkSanError(SanitizerError):
    pass


# ------------------------------------------------------------- PageSan ----

class PageSan:
    """Shadow ownership map + quarantine for one `PageAllocator`."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.owner: Dict[int, str] = {}
        self.freed_by: Dict[int, str] = {}      # tombstones: page -> owner
        self.quarantine: Deque[int] = deque()
        self.claims = 0
        self.frees = 0
        self.access_checks = 0

    # -- allocator hooks ----------------------------------------------------
    def on_claim(self, ids: Iterable[int], owner: str) -> None:
        for i in ids:
            if i in self.owner:
                raise PageSanError(
                    f"PageSan: double-claim of page {i} for '{owner}' — "
                    f"shadow map says it is live under "
                    f"'{self.owner[i]}'")
            self.owner[i] = owner
            self.freed_by.pop(i, None)
        self.claims += 1

    def pre_free(self, ids: Iterable[int]) -> None:
        for i in ids:
            if i not in self.owner:
                was = self.freed_by.get(i)
                detail = (f" (already freed by '{was}')" if was is not None
                          else " (never claimed)")
                raise PageSanError(
                    f"PageSan: double-free of page {i}{detail}")

    def on_free(self, ids: Iterable[int]) -> None:
        for i in ids:
            self.freed_by[i] = self.owner.pop(i)
            self.quarantine.append(i)
        self.frees += 1

    def take_quarantined(self, n: int) -> List[int]:
        """Recycle up to `n` quarantined pages, oldest first (capacity
        pressure — the allocator's free list ran short)."""
        out = []
        while self.quarantine and len(out) < n:
            out.append(self.quarantine.popleft())
        return out

    # -- access checks ------------------------------------------------------
    def check_access(self, ids: Iterable[int], expect_prefix: Optional[str],
                     op: str) -> None:
        """Validate that every (non-negative) page id touched by `op` is
        live, and owned under `expect_prefix` (``"kv:"`` / ``"adapter:"``)
        when given."""
        self.access_checks += 1
        for i in ids:
            i = int(i)
            if i < 0:
                continue
            o = self.owner.get(i)
            if o is None:
                was = self.freed_by.get(i)
                if was is not None:
                    raise PageSanError(
                        f"PageSan: use-after-free — {op} touched page {i}, "
                        f"freed while owned by '{was}'")
                raise PageSanError(
                    f"PageSan: {op} touched unclaimed page {i}")
            if expect_prefix is not None and not o.startswith(expect_prefix):
                raise PageSanError(
                    f"PageSan: aliasing — {op} expected a "
                    f"'{expect_prefix}' page but page {i} is owned by "
                    f"'{o}'")


# ------------------------------------------------------------- LinkSan ----

class LinkSan:
    """Happens-before checker over one `LoadTracker`."""

    def __init__(self):
        self._frozen: Dict[int, Tuple[float, float]] = {}   # seq -> (s, f)
        self._last_retired: float = float("-inf")
        self._last_retired_cls: Dict[int, float] = {}
        # failure plane: seqs that must never retire, and per-retry floors
        # (the failed attempt's finish the retry must move strictly past)
        self._dead: set = set()
        self._retry_floor: Dict[int, float] = {}
        self.checks = 0

    def on_start(self, ev) -> None:
        """A lane took `ev`: its schedule is final from here on."""
        self._frozen[ev.seq] = (ev.start_ms, ev.finish_ms)

    def check_schedule(self, tracker) -> None:
        """Queued/running split and provisional schedules are consistent."""
        self.checks += 1
        for ev in tracker._queued:
            if ev.started:
                raise LinkSanError(
                    f"LinkSan: started upload '{ev.uid}' (seq {ev.seq}) "
                    "still sits in the queue")
            if ev.start_ms < ev.request_ms - _EPS:
                raise LinkSanError(
                    f"LinkSan: upload '{ev.uid}' scheduled to start at "
                    f"{ev.start_ms:.3f}ms, before its request at "
                    f"{ev.request_ms:.3f}ms")
            want = ev.start_ms + tracker._xfer_ms(ev.nbytes, ev.start_ms)
            if abs(ev.finish_ms - want) > 1e-3:
                raise LinkSanError(
                    f"LinkSan: upload '{ev.uid}' finish {ev.finish_ms:.3f}"
                    f"ms inconsistent with start + transfer "
                    f"({want:.3f}ms)")
        for ev in tracker._running:
            if not ev.started:
                raise LinkSanError(
                    f"LinkSan: un-started upload '{ev.uid}' in the "
                    "running set")
            frozen = self._frozen.get(ev.seq)
            if frozen is not None and (
                    abs(ev.start_ms - frozen[0]) > _EPS
                    or abs(ev.finish_ms - frozen[1]) > _EPS):
                raise LinkSanError(
                    f"LinkSan: started upload '{ev.uid}' moved from "
                    f"{frozen} to ({ev.start_ms}, {ev.finish_ms}) — "
                    "started uploads must never be rescheduled")

    def on_retire(self, ev) -> None:
        """Retired finish times are monotone non-decreasing — globally and
        per priority class — and match the frozen schedule. An upload the
        failure plane killed (crash-canceled or failed) must never come
        back through here, and a retry must retire strictly after the
        attempt it replaces."""
        if ev.canceled or ev.seq in self._dead:
            raise LinkSanError(
                f"LinkSan: canceled/failed upload '{ev.uid}' (seq "
                f"{ev.seq}) retired at {ev.finish_ms:.3f}ms — a killed "
                "upload must never retire")
        floor = self._retry_floor.pop(ev.seq, None)
        if floor is not None and ev.finish_ms <= floor + _EPS:
            raise LinkSanError(
                f"LinkSan: retry '{ev.uid}' (attempt {ev.attempt}) "
                f"retired at {ev.finish_ms:.3f}ms, not strictly after its "
                f"failed attempt's finish at {floor:.3f}ms")
        frozen = self._frozen.pop(ev.seq, None)
        if frozen is not None and abs(ev.finish_ms - frozen[1]) > _EPS:
            raise LinkSanError(
                f"LinkSan: upload '{ev.uid}' retired at {ev.finish_ms:.3f}"
                f"ms but was frozen to finish at {frozen[1]:.3f}ms")
        if ev.finish_ms < self._last_retired - _EPS:
            raise LinkSanError(
                f"LinkSan: upload '{ev.uid}' (class {ev.cls}) retired at "
                f"{ev.finish_ms:.3f}ms after a retirement at "
                f"{self._last_retired:.3f}ms — finish times must be "
                "monotone")
        prev_cls = self._last_retired_cls.get(ev.cls, float("-inf"))
        if ev.finish_ms < prev_cls - _EPS:
            raise LinkSanError(
                f"LinkSan: class-{ev.cls} finish times not monotone "
                f"({ev.finish_ms:.3f}ms after {prev_cls:.3f}ms)")
        self._last_retired = max(self._last_retired, ev.finish_ms)
        self._last_retired_cls[ev.cls] = max(prev_cls, ev.finish_ms)

    def on_fail(self, ev) -> None:
        """A finishing transfer failed: it will never retire (the tracker
        either requeues a *fresh* event or drops it), so its frozen
        schedule is dead and its seq joins the never-retire set."""
        self._frozen.pop(ev.seq, None)
        self._dead.add(ev.seq)

    def on_retry(self, failed, retry) -> None:
        """Happens-before between a failed attempt and its retry: the
        retry must be requested after the failure (backoff > 0), and —
        recorded as a floor checked at retirement — must finish strictly
        past it."""
        if retry.request_ms <= failed.finish_ms + _EPS:
            raise LinkSanError(
                f"LinkSan: retry of '{failed.uid}' requested at "
                f"{retry.request_ms:.3f}ms, not after the failed "
                f"attempt's finish at {failed.finish_ms:.3f}ms")
        if retry.attempt != failed.attempt + 1:
            raise LinkSanError(
                f"LinkSan: retry of '{failed.uid}' carries attempt "
                f"{retry.attempt}, expected {failed.attempt + 1}")
        self._retry_floor[retry.seq] = failed.finish_ms

    def on_cancel(self, events) -> None:
        """A crash aborted these uploads: drop their frozen schedules and
        remember the seqs — a canceled upload must never retire."""
        for ev in events:
            self._frozen.pop(ev.seq, None)
            self._retry_floor.pop(ev.seq, None)
            self._dead.add(ev.seq)

    def on_demand_begin(self, tracker, ev, delayed_before: int) -> None:
        """Manager-mediated demand begin under the `preempt` policy: the
        demand upload must not have been delayed by queued prefetch, and no
        queued prefetch may have survived the preemption."""
        if tracker.policy != "preempt":
            return
        delayed = tracker.stats["demand_delayed_by_prefetch"]
        if delayed > delayed_before:
            raise LinkSanError(
                f"LinkSan: demand upload '{ev.uid}' was delayed behind "
                "queued prefetch under the preempt policy "
                "(demand_delayed_by_prefetch moved "
                f"{delayed_before} -> {delayed})")
        from repro_torch.core.cold_start import CLS_PREFETCH
        survivors = [e.uid for e in tracker._queued
                     if e.cls == CLS_PREFETCH]
        if survivors:
            raise LinkSanError(
                f"LinkSan: queued prefetch {survivors} survived a "
                f"preempt-policy demand begin of '{ev.uid}'")
