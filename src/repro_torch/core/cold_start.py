"""Cold-start handling: asynchronous adapter loading + CPU-assisted prefill
(paper sec 4).

Two pieces:

``LoadTracker`` — the scheduled host→device link. The host link is a serial
resource (bandwidth `hw.load_bw`, `hw.load_concurrency` parallel lanes):
concurrent cold starts queue behind each other, so K simultaneous uploads
finish at t0 + K * load_ms rather than all at t0 + load_ms as the old
instantaneous model assumed. Beyond plain FIFO, the link is *scheduled*:
every upload carries a priority class —

  CLS_DEMAND    — a cold start with a request waiting on it,
  CLS_PROMOTED  — a speculative prefetch that a demand admission caught
                  mid-flight (promoted to demand class),
  CLS_PREFETCH  — a speculative prefetch, no request attached,

and the link policy decides how queued (not-yet-started) uploads share the
lanes:

  fifo      — strict begin order (the legacy lane model; the parity oracle).
  priority  — queued uploads run in (class, begin-order); a newly arriving
              demand upload jumps every queued prefetch. Started uploads
              always run to completion (no mid-transfer abort).
  preempt   — priority ordering, plus a demand upload *cancels* every
              queued prefetch outright, reclaiming their link time and
              (via the ColdStartManager) their reserved device slots.

Because queued uploads can be reordered, their start/finish times are
provisional: they are *recomputed on every insertion, promotion, and
cancellation*. Consumers must not cache a finish time captured at begin()
unless the upload has started or is plain CLS_DEMAND (nothing jumps that
class; a *promoted* prefetch is demand-class yet can still be jumped by a
later plain demand while queued); the engine re-derives decode gates from
`pending_for(...)` each iteration, and the cluster event heap classifies
wakes from `next_finish_ms()` at pop time.

The link is also where the failure plane bites (`core/faults.py`): a
`fail_hook` installed by a `FaultPlane` can declare a finishing transfer
failed, in which case demand-class uploads retry with exponential backoff
plus deterministic jitter (a fresh `LoadEvent`, `attempt + 1`, re-entering
the queue at its class — demand retries still jump queued prefetch) while
speculative prefetches are dropped outright (their slot reservation is
released via `drain_gave_up`). The retry budget is structural: once
`attempt` reaches `retry_budget` the hook is no longer consulted, so the
final attempt cannot fail and no request is ever stranded on a flaky
link. `brownouts` windows scale transfer times of uploads *starting*
inside the window (`_xfer_ms`), and `cancel_all` models a fail-stop crash
of the device the link feeds: every upload — queued or mid-transfer — is
aborted and must never retire. (The reference's LinkSan checks of these
invariants are not ported yet: ROADMAP.md queue 1, tooling.)

``ColdStartManager.admit`` — returns the admission timeline for a newly
admitted request under the engine's operating mode:

  CACHED     — oracle: adapter already on device, no load (paper sec 7.1).
  ONDMD      — on-demand blocking load: decode of in-flight requests stalls
               behind Load+Prefill (paper Fig 2).
  SLORA      — same loading behaviour as ONDMD (S-LoRA loads on demand); the
               kernel differs (MBGMV).
  CARASERVE  — CPU-assisted: host CPUs early-start the prefill's LoRA
               computation while the adapter uploads; the GPU/TPU runs the
               adapter-agnostic base prefill concurrently, switching the LoRA
               path to the device once the upload completes (paper Fig 1/7).

The numerics of the host-assist path are identical to the device path by
construction (same x·A·B, computed from the host copy of the weights); the
timeline model quantifies the overlap. Layer-wise coordination costs use the
sync-free-invocation and shared-memory constants (paper Figs 8, 16-18).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.lora import AdapterSpec, DevicePool, HostLoRAStore
from repro_torch.core.timing import TimingModel

MODES = ("cached", "ondemand", "slora", "caraserve")

# priority classes on the shared host link (lower = more urgent)
CLS_DEMAND, CLS_PROMOTED, CLS_PREFETCH = 0, 1, 2
LINK_POLICIES = ("fifo", "priority", "preempt")

# upload-retry defaults: a demand upload survives up to RETRY_BUDGET
# transient failures (the attempt after the budget is structurally
# infallible — liveness), backing off base * 2^attempt * (1 + jitter*u)
RETRY_BUDGET = 6
RETRY_BASE_MS = 4.0
RETRY_JITTER = 0.5


@dataclasses.dataclass
class AdmitPlan:
    prefill_ms: float          # time to produce the first token (post queue)
    ready_decode_ms: float     # absolute clock when decode iterations may include this request
    blocking_ms: float         # serial stall imposed on the whole iteration (Fig 2 "Load")
    cold: bool
    assist: bool               # CPU-assist engaged
    slot: int                  # device pool slot assigned
    load_finish_ms: Optional[float] = None  # upload completion (None: resident)


@dataclasses.dataclass
class LoadEvent:
    """One host→device adapter upload occupying the shared link.

    `start_ms`/`finish_ms` are provisional while the upload is queued (the
    link scheduler recomputes them on every insertion); they are final once
    `started` is True — a started upload is never aborted."""
    uid: str
    slot: int
    nbytes: int
    request_ms: float          # when the upload was requested
    start_ms: float            # when a link lane takes (or took) it
    finish_ms: float
    seq: int                   # begin order; deterministic tie-break
    demand: bool = True        # False: speculative prefetch, no request yet
    cls: int = CLS_DEMAND      # CLS_DEMAND | CLS_PROMOTED | CLS_PREFETCH
    started: bool = False
    canceled: bool = False
    attempt: int = 0           # 0: first try; >0: retry after a failure


class LoadTracker:
    """Priority-aware upload scheduler over the shared host→device link.

    Started uploads occupy their lane to completion; queued uploads are
    (re)ordered by the link policy — `fifo` preserves begin order, while
    `priority`/`preempt` run demand-class uploads first, so a queued
    prefetch never delays a demand cold start. `complete_until` retires
    finished uploads in deterministic (finish, begin-seq) order.

    Telemetry (`stats`): per-class begin counts, promotions, preempt
    cancellations, and `demand_delayed_by_prefetch` — the number of demand
    uploads whose start time would have been earlier had no speculative
    upload been queued ahead of them. The tracker only *schedules*;
    cancellation is orchestrated by the ColdStartManager (which owns the
    device-slot reservations), so the preempt guarantee — a demand upload
    is never delayed by a queued prefetch, counter stays 0 — holds for
    uploads begun through `ColdStartManager.load_async`, not for raw
    `begin()` calls on a bare tracker.
    """

    def __init__(self, tm: TimingModel, concurrency: Optional[int] = None,
                 policy: str = "fifo"):
        if policy not in LINK_POLICIES:
            raise ValueError(f"unknown link policy {policy!r}")
        self.tm = tm
        self.policy = policy
        n = concurrency or getattr(tm.hw, "load_concurrency", 1)
        self._lane_free_ms = [0.0] * max(1, n)
        self._seq = 0
        self._now = 0.0
        self._running: List[LoadEvent] = []
        self._queued: List[LoadEvent] = []
        self.stats = {"demand": 0, "promoted": 0, "prefetch": 0,
                      "preempted": 0, "demand_delayed_by_prefetch": 0,
                      "upload_failures": 0, "retries": 0,
                      "prefetch_dropped": 0, "crash_canceled": 0}
        # failure plane (core/faults.py installs these): fail_hook decides
        # whether a finishing transfer failed; brownouts are
        # (start, end, slowdown) windows scaling transfer times
        self.fail_hook: Optional[Callable[[LoadEvent], bool]] = None
        self.retry_budget = RETRY_BUDGET
        self.retry_base_ms = RETRY_BASE_MS
        self.retry_jitter = RETRY_JITTER
        self.retry_seed = 0
        self.brownouts: List[Tuple[float, float, float]] = []
        self._gave_up: List[LoadEvent] = []

    # --------------------------------------------------------- schedule ----
    @property
    def inflight(self) -> List[LoadEvent]:
        """Every upload not yet retired (started + queued), in begin order."""
        return sorted(self._running + self._queued, key=lambda e: e.seq)

    def _key(self, ev: LoadEvent):
        if self.policy == "fifo":
            return (0, ev.seq)
        return (ev.cls, ev.seq)

    def _pick_lane(self, free: List[float]) -> int:
        return min(range(len(free)), key=lambda i: free[i])

    def slowdown_at(self, t_ms: float) -> float:
        """Brownout factor for a transfer starting at `t_ms` (1.0 when no
        window covers it; overlapping windows take the worst factor)."""
        f = 1.0
        for t0, t1, factor in self.brownouts:
            if t0 <= t_ms < t1:
                f = max(f, factor)
        return f

    def _xfer_ms(self, nbytes: int, start_ms: float) -> float:
        """Transfer duration on this link for an upload starting at
        `start_ms` — the base model scaled by any brownout window covering
        the start. Every schedule projection (dispatch, reschedule,
        occupancy, LinkSan's replay) must use this, not `tm.load_ms`."""
        return self.tm.load_ms(nbytes) * self.slowdown_at(start_ms)

    def _take(self, free: List[float], ev: LoadEvent) -> float:
        """The one greedy lane-projection rule, shared by real dispatch and
        every provisional schedule: the earliest-free lane takes `ev`;
        returns the start time and advances that lane past the transfer.
        (No flooring at the link clock: a lane that freed in the past takes
        a queued upload at the free time, matching actual dispatch.)"""
        lane = self._pick_lane(free)
        start = max(free[lane], ev.request_ms)
        free[lane] = start + self._xfer_ms(ev.nbytes, start)
        return start

    def _dispatch(self):
        """Lanes free by the link clock take the highest-priority queued
        upload; chained so advancing far ahead drains the whole queue.
        Retries backing off (request_ms in the future) are not eligible —
        the lane must not idle reserved for them, so other queued uploads
        may jump a backing-off retry regardless of class."""
        while self._queued:
            if min(self._lane_free_ms) > self._now:
                break
            cands = [e for e in self._queued if e.request_ms <= self._now]
            if not cands:
                break
            ev = min(cands, key=self._key)
            self._queued.remove(ev)
            ev.start_ms = self._take(self._lane_free_ms, ev)
            ev.finish_ms = ev.start_ms + self._xfer_ms(ev.nbytes,
                                                       ev.start_ms)
            ev.started = True
            self._running.append(ev)

    def _advance(self, now_ms: float):
        self._now = max(self._now, now_ms)
        self._dispatch()

    def _reschedule(self):
        """Recompute provisional start/finish of every queued upload by
        projecting the policy order onto the lanes (called on insertion,
        promotion, and cancellation — queued finish times are never stale)."""
        free = list(self._lane_free_ms)
        for ev in sorted(self._queued, key=self._key):
            ev.start_ms = self._take(free, ev)
            ev.finish_ms = ev.start_ms + self._xfer_ms(ev.nbytes,
                                                       ev.start_ms)

    def _undelayed_start(self, ev: LoadEvent) -> float:
        """Start time `ev` would get with no queued prefetch ahead of it —
        the reference for the delayed-by-prefetch counter."""
        free = list(self._lane_free_ms)
        for e in sorted(self._queued, key=self._key):
            if e is ev:
                break
            if e.cls != CLS_PREFETCH:
                self._take(free, e)
        lane = self._pick_lane(free)
        return max(free[lane], ev.request_ms)

    # ----------------------------------------------------------- public ----
    def begin(self, uid: str, slot: int, nbytes: int, now_ms: float,
              demand: bool = True) -> LoadEvent:
        self._advance(now_ms)
        cls = CLS_DEMAND if demand else CLS_PREFETCH
        ev = LoadEvent(uid, slot, nbytes, now_ms, now_ms, now_ms, self._seq,
                       demand=demand, cls=cls)
        self._seq += 1
        self._queued.append(ev)
        self._dispatch()          # a lane free right now takes it immediately
        self._reschedule()
        self.stats["demand" if ev.demand else "prefetch"] += 1
        if ev.demand and not ev.started:
            if ev.start_ms > self._undelayed_start(ev) + 1e-9:
                self.stats["demand_delayed_by_prefetch"] += 1
        return ev

    def promote(self, uid: str, now_ms: float) -> Optional[LoadEvent]:
        """A demand admission found its adapter mid-prefetch: the in-flight
        upload joins the demand class (CLS_PROMOTED). A queued upload jumps
        ahead of the remaining speculative ones (priority/preempt reorder);
        a started one keeps its lane — only its class/telemetry change."""
        self._advance(now_ms)
        ev = self.pending_for(uid)
        if ev is None or ev.demand:
            return ev
        ev.cls = CLS_PROMOTED
        ev.demand = True
        self.stats["promoted"] += 1
        self._reschedule()
        return ev

    def cancel_queued_prefetch(self) -> List[LoadEvent]:
        """Drop every queued (not-yet-started) speculative upload — the
        `preempt` policy reclaims the link for demand traffic; the caller
        must release the canceled events' device-slot reservations."""
        out = [e for e in self._queued if e.cls == CLS_PREFETCH]
        for e in out:
            e.canceled = True
            self._queued.remove(e)
        self.stats["preempted"] += len(out)
        self._reschedule()
        return out

    def cancel_one_queued_prefetch(self) -> Optional[LoadEvent]:
        """Drop the *last-scheduled* queued speculative upload (the one the
        policy would run last) — the `priority` policy's minimal slot
        reclaim: earlier speculative work survives."""
        cands = [e for e in self._queued if e.cls == CLS_PREFETCH]
        if not cands:
            return None
        ev = max(cands, key=self._key)
        ev.canceled = True
        self._queued.remove(ev)
        self.stats["preempted"] += 1
        self._reschedule()
        return ev

    def _backoff_ms(self, ev: LoadEvent) -> float:
        """Exponential backoff with deterministic jitter: the jitter draw
        is a hash of (uid, attempt, retry_seed), so two same-seed runs
        back off identically regardless of event interleaving."""
        u = zlib.crc32(f"{ev.uid}:{ev.attempt}:{self.retry_seed}"
                       .encode()) / 2.0 ** 32
        return self.retry_base_ms * (2.0 ** ev.attempt) \
            * (1.0 + self.retry_jitter * u)

    def _upload_fails(self, ev: LoadEvent) -> bool:
        """Consult the fault plane's hook — but never for a demand-class
        upload that has exhausted its retry budget: the escalated final
        attempt is structurally infallible, so no request waiting on an
        adapter (or KV swap-in) can be stranded by a flaky link."""
        if self.fail_hook is None or ev.canceled:
            return False
        if ev.cls != CLS_PREFETCH and ev.attempt >= self.retry_budget:
            return False
        return bool(self.fail_hook(ev))

    def _handle_failure(self, ev: LoadEvent) -> bool:
        """A transfer reached its finish time and failed. Demand-class
        uploads requeue as a fresh LoadEvent (attempt + 1) requested at
        failure + backoff — still demand class, so the retry jumps queued
        prefetch under priority/preempt. Speculative prefetches are simply
        dropped (parked on `_gave_up` until the manager releases their slot
        reservation). Returns True when a retry was requeued."""
        self.stats["upload_failures"] += 1
        if ev.cls == CLS_PREFETCH:
            ev.canceled = True
            self.stats["prefetch_dropped"] += 1
            self._gave_up.append(ev)
            return False
        t_retry = ev.finish_ms + self._backoff_ms(ev)
        retry = LoadEvent(ev.uid, ev.slot, ev.nbytes, t_retry, t_retry,
                          t_retry, self._seq, demand=ev.demand, cls=ev.cls,
                          attempt=ev.attempt + 1)
        self._seq += 1
        self._queued.append(retry)
        self.stats["retries"] += 1
        return True

    def complete_until(self, now_ms: float) -> List[LoadEvent]:
        """Retire uploads finished by `now_ms`, strictly one at a time in
        (finish, seq) order. With a fault plane attached a finishing
        transfer may fail instead of retiring — demand uploads requeue
        with backoff, prefetches drop — and a requeued retry whose backoff
        expires inside this same window can start, finish, and retire
        *before* a longer transfer already in flight; taking the global
        minimum each step keeps retirements monotone in finish time."""
        self._advance(now_ms)
        done: List[LoadEvent] = []
        while True:
            cands = [e for e in self._running if e.finish_ms <= now_ms]
            if not cands:
                break
            ev = min(cands, key=lambda e: (e.finish_ms, e.seq))
            self._running.remove(ev)
            if self._upload_fails(ev):
                if self._handle_failure(ev):
                    self._reschedule()
                self._dispatch()
            else:
                done.append(ev)
        return done

    def drain_gave_up(self) -> List[LoadEvent]:
        """Prefetch uploads dropped by the fault plane since the last
        drain; the manager releases their device-slot reservations."""
        out, self._gave_up = self._gave_up, []
        return out

    def cancel_all(self) -> List[LoadEvent]:
        """Fail-stop crash of the device this link feeds: every upload —
        queued or mid-transfer — is aborted. Canceled events never retire
        (LinkSan enforces it); the caller owns the device-slot cleanup.
        Lanes reset to the link clock: the restarted device gets a fresh
        link."""
        out = sorted(self._running + self._queued, key=lambda e: e.seq)
        for e in out:
            e.canceled = True
        self._running = []
        self._queued = []
        self._lane_free_ms = [self._now] * len(self._lane_free_ms)
        self.stats["crash_canceled"] += len(out)
        return out

    def pending_for(self, uid: str) -> Optional[LoadEvent]:
        for e in self._running:
            if e.uid == uid:
                return e
        for e in self._queued:
            if e.uid == uid:
                return e
        return None

    def next_finish_ms(self) -> Optional[float]:
        """Earliest upload completion under the *current* schedule. Queued
        uploads contribute their provisional finish — a later insertion can
        move it, so event loops must re-derive at pop time, never cache."""
        return min((e.finish_ms for e in self._running + self._queued),
                   default=None)

    # -------------------------------------------------------- telemetry ----
    def link_busy_until_ms(self, cls: int = CLS_DEMAND) -> float:
        """Earliest time a NEW upload of class `cls` could start: when the
        first lane drains of its running upload plus every queued upload
        the policy schedules ahead of the newcomer (fifo: all of them;
        priority/preempt: only classes <= `cls`). 0.0 when the link is
        idle. This is the earliest-*free*-lane delay — with
        `load_concurrency > 1` an idle lane means no queueing at all (the
        old max-over-lanes answer overestimated it)."""
        if not self._running and not self._queued:
            return 0.0
        newcomer = (0, self._seq) if self.policy == "fifo" \
            else (cls, self._seq)
        free = list(self._lane_free_ms)
        for e in sorted(self._queued, key=self._key):
            if self._key(e) <= newcomer:   # else the newcomer jumps it
                self._take(free, e)
        return min(free)

    def class_busy_ms(self, now_ms: float) -> Dict[int, float]:
        """Remaining link occupancy per priority class: transfer-ms still
        to move past `now_ms` for started uploads, full duration for queued
        ones."""
        out = {CLS_DEMAND: 0.0, CLS_PROMOTED: 0.0, CLS_PREFETCH: 0.0}
        for e in self._running:
            out[e.cls] += max(0.0, e.finish_ms - max(now_ms, e.start_ms))
        for e in self._queued:
            out[e.cls] += self._xfer_ms(e.nbytes, e.start_ms)
        return out

    def demand_busy_ms(self, now_ms: float) -> float:
        cb = self.class_busy_ms(now_ms)
        return cb[CLS_DEMAND] + cb[CLS_PROMOTED]

    def prefetch_busy_ms(self, now_ms: float) -> float:
        return self.class_busy_ms(now_ms)[CLS_PREFETCH]


class ColdStartManager:
    def __init__(self, tm: TimingModel, store: HostLoRAStore,
                 pool: DevicePool, mode: str = "caraserve",
                 tracker: Optional[LoadTracker] = None,
                 link_policy: str = "fifo"):
        if mode not in MODES:
            raise ValueError(f"unknown cold-start mode {mode!r}")
        self.tm = tm
        self.store = store
        self.pool = pool
        self.mode = mode
        self.tracker = tracker if tracker is not None \
            else LoadTracker(tm, policy=link_policy)
        self._completed: List[LoadEvent] = []

    # ------------------------------------------------------ async plane ----
    def poll(self, now_ms: float) -> List[LoadEvent]:
        """Retire uploads finished by `now_ms`; their slots become ready
        (eviction-eligible, prefetch-visible). Returns the events; they are
        also queued for `drain_completions` so the engine can flip in-flight
        requests to the device LoRA path even when a retire happened inside
        `admit`."""
        done = self.tracker.complete_until(now_ms)
        if done:
            for ev in done:
                # KV swap-in uploads (preemption resume) ride the link with
                # no device-pool slot (slot < 0): nothing to commit
                if ev.slot >= 0:
                    self.pool.commit(ev.slot)
            self._completed.extend(done)
        # speculative prefetches the fault plane failed are dropped, not
        # retried: give their reserved slots back to the evictable set
        for ev in self.tracker.drain_gave_up():
            if ev.slot >= 0:
                self.pool.release(ev.slot)
        return done

    def drain_completions(self) -> List[LoadEvent]:
        done, self._completed = self._completed, []
        return done

    def pending_completions(self) -> int:
        """Completions retired by a poll but not yet drained by the engine
        (cluster telemetry: a wake with these pending is a load_done)."""
        return len(self._completed)

    def _cancel_queued_prefetch(self):
        """Preempt queued speculative uploads and release their reserved
        device slots (the reservation never landed; the slot returns to the
        evictable set)."""
        for ev in self.tracker.cancel_queued_prefetch():
            self.pool.release(ev.slot)

    def load_async(self, uid: str, now_ms: float, pinned=(),
                   demand: bool = True) -> Optional[LoadEvent]:
        """Reserve a slot and start an asynchronous upload (cold starts:
        demand=True; speculative prefetch: demand=False). Under the
        `preempt` link policy a demand upload first cancels every queued
        prefetch — reclaiming their link time and device slots. Returns
        None when every evictable slot is taken."""
        spec = self.store.specs[uid]
        nbytes = spec.nbytes(self.tm.cfg)
        w = self.store.weights(uid) if self.pool.materialize else None
        if demand and self.tracker.policy == "preempt":
            self._cancel_queued_prefetch()
        slot = self.pool.reserve(uid, w, spec.rank, pinned=pinned,
                                 nbytes=nbytes)
        if slot is None and demand and self.tracker.policy == "priority":
            # priority does not preempt eagerly: a demand admission blocked
            # only by queued speculative reservations cancels them one at a
            # time — last-scheduled first — until a slot frees up, so
            # earlier speculative work survives the reclaim
            while slot is None:
                ev = self.tracker.cancel_one_queued_prefetch()
                if ev is None:
                    break
                self.pool.release(ev.slot)
                slot = self.pool.reserve(uid, w, spec.rank, pinned=pinned,
                                         nbytes=nbytes)
        if slot is None:
            return None
        ev = self.tracker.begin(uid, slot, nbytes, now_ms, demand=demand)
        return ev

    def upload_kv(self, rid: int, nbytes: int, now_ms: float) -> LoadEvent:
        """Schedule a preempted request's KV swap-in on the host link. The
        payload competes for lanes as demand-class traffic (a request is
        waiting on it) but owns no device-pool slot — `poll` skips the
        commit for slot < 0. Under `preempt` it reclaims queued speculative
        link time exactly like an adapter cold start."""
        if self.tracker.policy == "preempt":
            self._cancel_queued_prefetch()
        ev = self.tracker.begin(f"kvswap:{rid}", -1, nbytes, now_ms,
                                demand=True)
        return ev

    def _insert(self, uid: str, pinned=()) -> Optional[int]:
        """Synchronous insert (CACHED oracle: no upload modeled)."""
        spec = self.store.specs[uid]
        w = self.store.weights(uid) if self.pool.materialize else None
        return self.pool.insert(uid, w, spec.rank, pinned=pinned,
                                nbytes=spec.nbytes(self.tm.cfg))

    # ------------------------------------------------------- admission ----
    def admit(self, uid: str, now_ms: float, prompt_tokens: int,
              pinned=()) -> Optional[AdmitPlan]:
        self.poll(now_ms)        # uploads finished by now have landed
        spec = self.store.specs[uid]
        tm = self.tm
        base = tm.base_prefill_ms(prompt_tokens)
        gpu_lora = tm.lora_prefill_gpu_ms(prompt_tokens, spec.rank)
        slot = self.pool.lookup(uid)
        if slot is not None or self.mode == "cached":
            cold = slot is None
            if slot is None:
                slot = self._insert(uid, pinned)
                if slot is None:
                    return None          # no evictable slot: defer admission
            pre = base + gpu_lora
            if self.pool.is_ready(slot):
                return AdmitPlan(pre, now_ms + pre, 0.0, cold, False, slot)
            # resident but still uploading (admitted moments ago by another
            # request, or prefetched): no new transfer, but decode must wait
            # for the in-flight upload to land. A speculative prefetch hit
            # is *promoted* to demand class — a request now rides it, so
            # link policies and free-ride accounting must see a demand
            # upload (and under priority/preempt it jumps the queue).
            ev = self.tracker.pending_for(uid)
            if ev is not None and not ev.demand:
                ev = self.tracker.promote(uid, now_ms)
            finish = ev.finish_ms if ev else now_ms
            rem = max(0.0, finish - now_ms)
            if self.mode in ("ondemand", "slora"):
                # the blocking stall `rem` is charged into the iteration
                # *now*, from the schedule as of this admission. A queued
                # promoted upload can still be jumped by a later plain
                # demand (its finish moves), but a serial stall already
                # folded into the timeline cannot be retro-extended — the
                # engine's per-step re-derivation raises the row's decode
                # gate to the true landing, so only the stall accounting
                # (not decode correctness) is approximate under
                # priority/preempt. Exact under fifo.
                pre = rem + base + gpu_lora
                return AdmitPlan(pre, now_ms + pre, rem, False, False, slot,
                                 load_finish_ms=finish)
            cpu_lora = tm.cpu_lora_prefill_ms(prompt_tokens, spec.rank)
            pre = max(base, min(cpu_lora, rem + gpu_lora))
            ready = max(now_ms + pre, finish)
            return AdmitPlan(pre, ready, 0.0, False, rem > 0.0, slot,
                             load_finish_ms=finish)

        # true cold start: the upload queues on the shared host link — its
        # effective duration includes waiting behind concurrent uploads
        ev = self.load_async(uid, now_ms, pinned)
        if ev is None:
            return None                   # no evictable slot: defer admission
        slot = ev.slot
        t_load = ev.finish_ms - now_ms
        if self.mode in ("ondemand", "slora"):
            pre = t_load + base + gpu_lora
            return AdmitPlan(pre, now_ms + pre, t_load, True, False, slot,
                             load_finish_ms=ev.finish_ms)

        # caraserve: overlap upload with prefill; switch to device LoRA when
        # the upload finishes mid-prefill if that is faster than pure host.
        cpu_lora = tm.cpu_lora_prefill_ms(prompt_tokens, spec.rank)
        lora_path = min(cpu_lora, t_load + gpu_lora)
        pre = max(base, lora_path)
        ready = max(now_ms + pre, ev.finish_ms)
        return AdmitPlan(pre, ready, 0.0, True, True, slot,
                         load_finish_ms=ev.finish_ms)
