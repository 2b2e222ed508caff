"""Multi-server cluster simulation (paper sec 7.5): N inference servers, a
front-end scheduler, trace-driven arrivals.

Event-driven: a global event heap orders request arrivals, per-server wake
events (iteration completions / adapter load completions, classified at pop
time from the tracker's state), and periodic placement-rebalance passes;
each server advances its own virtual clock only when an event fires for it,
replacing the old lockstep advance-everyone-to-the-next-arrival loop. The
lockstep engine is kept (``engine="lockstep"``) as a cross-check oracle —
the event loop must reproduce its summary metrics within tolerance
(tests/test_torch_cluster.py).

Placement plane (core/placement.py): when a ``Placement`` is given, each
adapter lives on a *subset* of servers and the scheduler routes only among
live hosting replicas. When no replica is alive — or every replica would
break the decode SLO (``RankAwareScheduler.saturated``) — the cluster falls
back to **register-on-miss**: the candidate set opens to every live server
with a one-time install cost (``ServerStats.miss_install_ms``) charged in
the routing score, the winner's host store installs the adapter mid-run
(``InferenceServer.install_adapter``; the host-side install is charged in
routing but approximated as instantaneous on the timeline — the device
upload it triggers pays the real link cost through the existing
``LoadTracker``), and the placement map gains the replica. A rebalance pass
driven by the admission plane's popularity EWMA adds replicas of hot
adapters (warmed by a speculative link upload) and drops surplus replicas
of cooled ones over simulated time.

Servers are InferenceServer instances (numerics usually disabled at cluster
scale — same timeline engine the single-server evaluation uses, matching the
paper's simulator methodology). The scheduler observes in-flight loads
(ServerStats.loading_ranks / link_busy_ms plus the per-class
demand_link_ms / prefetch_link_ms split) so rank-aware routing can steer
cold starts away from servers whose host link is saturated with demand
traffic — under the priority/preempt link policies, speculative prefetch
occupancy is jumped/canceled by a demand upload and correctly does not
count against the server. Upload finish times are recomputed by the link
scheduler on every insertion, so WAKE events never carry a cached
load_done timestamp: they are classified at pop time from
``next_finish_ms()`` / ``pending_completions()``.

Failure plane (core/faults.py): a ``FaultPlane`` injects scripted server
crashes, restarts, flaky-upload windows and a link brownout into the same
event heap (FAULT events order *before* same-time arrivals — a request
never routes to a server that died at its own arrival instant). A crash
fail-stops the victim's device: finished uploads land, live and queued
requests drain back through the router with a forced drop-and-recompute
resume plan and are adopted by survivors (``failovers``), in-flight uploads
are canceled (they never retire). A restart rejoins warm:
the host store survived, so the cluster re-warms the victim's hottest
hosted adapters through the normal prefetch path. Under
``shed_policy="slo"`` the router sheds fresh arrivals when every alive
candidate is decode-SLO-saturated (brownout back-pressure); crash
failovers are exempt — a recovered request is never shed.

A copy of the reference's `repro.core.cluster` over the port's servers.
Timing-only servers (``numerics=False``) touch no device; servers with
numerics compute every token on their own device (the card, or the CPU
when built with ``device="cpu"``), and may share one weight set
(``params=``) while each keeps its own KV and adapter pools.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.core.cold_start import (CLS_DEMAND, CLS_PREFETCH,
                                         CLS_PROMOTED)
from repro_torch.core.engine import InferenceServer
from repro_torch.core.faults import FaultPlane
from repro_torch.core.lora import AdapterSpec
from repro_torch.core.placement import Placement, replica_target
from repro_torch.core.scheduler import ServerStats
from repro_torch.serving.request import Request, RequestState, summarize

# event kinds, in tie-break priority order at equal timestamps: faults
# land first (a server that crashes at t is already dead to a t-arrival),
# arrivals must be routed before a server iterates past them, and a
# rebalance pass sees the popularity updates of same-time arrivals. WAKE
# events are generic "server makes progress" events — whether one is an
# iteration or a load completion is classified at *pop* time from the
# tracker's state (an upload can begin or retire between push and pop).
FAULT, ARRIVAL, REBALANCE, WAKE = 0, 1, 2, 3

# default one-time host-store install cost charged (in the routing score
# only) when a request must be placed on a server that does not host its
# adapter — stands in for the registry fetch that precedes the upload
MISS_INSTALL_MS = 25.0


class Cluster:
    def __init__(self, servers: Sequence[InferenceServer], scheduler,
                 engine: str = "events",
                 placement: Optional[Placement] = None,
                 specs: Optional[Sequence[AdapterSpec]] = None,
                 rebalance_every_ms: Optional[float] = None,
                 replica_spread: float = 1.5,
                 max_replicas: Optional[int] = None,
                 rebalance_max_adds: int = 8,
                 miss_install_ms: float = MISS_INSTALL_MS,
                 faults: Optional[FaultPlane] = None,
                 shed_policy: str = "none"):
        if engine not in ("events", "lockstep"):
            raise ValueError(f"unknown engine {engine!r}")
        if shed_policy not in ("none", "slo"):
            raise ValueError(f"unknown shed_policy {shed_policy!r}")
        if faults is not None and engine == "lockstep":
            raise ValueError("fault injection needs the event engine: the "
                             "lockstep oracle has no timeline to crash into")
        self.servers = list(servers)
        self.scheduler = scheduler
        self.engine = engine
        self.placement = placement
        self.rebalance_every_ms = rebalance_every_ms
        self.replica_spread = replica_spread
        self.max_replicas = max_replicas
        self.rebalance_max_adds = rebalance_max_adds
        self.miss_install_ms = miss_install_ms
        self.faults = faults
        self.shed_policy = shed_policy
        self.down: Set[int] = set()
        self.shed_states: List[RequestState] = []
        self.fault_stats = {"crashes": 0, "restarts": 0, "drained": 0,
                            "failovers": 0, "shed": 0}
        self.event_counts = {"arrival": 0, "iter": 0, "load_done": 0,
                             "rebalance": 0, "fault": 0}
        self.placement_stats = {"miss_installs": 0, "replica_adds": 0,
                                "replica_drops": 0, "replica_readds": 0}
        # cluster-wide adapter registry (rank lookup + late installs)
        self.specs: Dict[str, AdapterSpec] = {}
        for sp in specs or ():
            self.specs[sp.uid] = sp
        for s in self.servers:
            self.specs.update(s.store.specs)
        if placement is not None:
            if placement.n_servers != len(self.servers):
                raise ValueError(
                    f"placement spans {placement.n_servers} servers but the "
                    f"cluster has {len(self.servers)}")
            # materialize the assignment: each hosting server registers its
            # shard (servers may be built bare)
            for uid in list(self.specs):
                for i in placement.hosts(uid):
                    self.servers[i].install_adapter(self.specs[uid])

    # ----------------------------------------------------------- health ----
    def set_down(self, i: int, now_ms: Optional[float] = None):
        """Mark server `i` unhealthy. A busy server holds live requests
        that silently marking it down would strand forever (they would
        never be stepped again yet still count as submitted): pass
        `now_ms` to crash-drain them back through the router — failover
        semantics, identical to an injected crash — or get a
        RuntimeError."""
        if now_ms is not None:
            self._crash(i, now_ms)
            return
        if self.servers[i].busy():
            raise RuntimeError(
                f"server {i} is busy: set_down would strand its in-flight "
                "requests — pass now_ms to drain-and-requeue them "
                "(crash semantics)")
        self.down.add(i)

    def set_up(self, i: int):
        self.down.discard(i)

    def _crash(self, i: int, t: float) -> Set[int]:
        """Fail-stop server `i` at `t`: drain its queue and live rows and
        re-admit every drained request on a survivor through the normal
        router (never shed — failover must not be undermined by brownout
        back-pressure). Returns the set of adopting servers so the event
        loop can wake them."""
        if i in self.down:
            return set()
        self.down.add(i)
        drained = self.servers[i].crash(t)
        self.fault_stats["crashes"] += 1
        self.fault_stats["drained"] += len(drained)
        if self.faults is not None:
            self.faults.record(t, "crash", i, f"drained={len(drained)}")
        woken: Set[int] = set()
        for st in drained:
            st.recovered += 1
            try:
                idx = self._route(st.req, now_ms=t, allow_shed=False)
            except LookupError:
                # no alive replica and no placement map to open the
                # candidate set: fail over to the least-loaded survivor
                idx = min(self._alive(), key=self._server_load)
            srv = self.servers[idx]
            uid = st.req.adapter_uid
            if uid not in srv.store:   # placement-free clusters still heal
                srv.install_adapter(self.specs[uid], t)
            srv.adopt(st, t)
            self.fault_stats["failovers"] += 1
            woken.add(idx)
        return woken

    def _restart(self, i: int, t: float):
        """Rejoin server `i` at `t` with an empty device but a surviving
        host store: re-warm its hottest hosted adapters (cluster-wide
        popularity order) through the normal prefetch path, so the rejoin
        is warm, not cold — the first post-restart arrivals find their
        adapters already riding the link."""
        if i not in self.down:
            return
        self.down.discard(i)
        srv = self.servers[i]
        srv.restart(t)
        self.fault_stats["restarts"] += 1
        if self.faults is not None:
            self.faults.record(t, "restart", i)
        pop: Dict[str, float] = {}
        for s in self.servers:
            for u, v in s.admission.popularity(t).items():
                pop[u] = pop.get(u, 0.0) + v
        if self.placement is not None:
            hosted = [u for u in self.specs
                      if i in self.placement.hosts(u)]
        else:
            hosted = [u for u in srv.store.specs]
        hosted.sort(key=lambda u: pop.get(u, 0.0), reverse=True)
        t0 = max(t, srv.clock)
        pinned = tuple(srv.admission.pinned_slots())
        for uid in hosted[:srv.pool.n_slots]:
            if srv.pool.lookup(uid) is not None:
                continue
            if srv.cold.load_async(uid, t0, pinned=pinned,
                                   demand=False) is None:
                break                  # pool full: warmest slots claimed

    def _alive(self) -> List[int]:
        return [i for i in range(len(self.servers)) if i not in self.down]

    def _server_load(self, i: int) -> int:
        s = self.servers[i]
        return len(s.queue) + sum(r is not None for r in s.rows)

    # ------------------------------------------------------------ stats ----
    def _stats(self, uid: str, now_ms: float,
               hosting: Optional[Set[int]] = None,
               req: Optional[Request] = None) -> List[ServerStats]:
        out = []
        for i, s in enumerate(self.servers):
            # retire uploads that finished (in simulated time) by the
            # arrival: an idle server's tracker is only polled inside
            # step(), so its resident/loading view can be stale here. A
            # server mid-iteration can be ahead of the arrival; its link
            # occupancy is measured from the same reference, since a
            # request routed there cannot start before the server's clock
            ref = max(now_ms, s.clock)
            s.cold.poll(ref)
            cb = s.cold.tracker.class_busy_ms(ref)
            itl = s.itl_stats()
            ranks_run = s.running_ranks()
            ranks_q = [s.store.specs[r.req.adapter_uid].rank
                       for r in s.queue]
            slot = s.pool.lookup(uid)
            hosts = (i in hosting) if hosting is not None \
                else uid in s.store
            out.append(ServerStats(
                running_ranks=ranks_run,
                queued_ranks=ranks_q,
                hosts_adapter=hosts and i not in self.down,
                free_rows=sum(r is None for r in s.rows),
                n_requests=len(ranks_run) + len(ranks_q),
                loading_ranks=s.loading_ranks(),
                link_busy_ms=max(0.0, s.cold.tracker.link_busy_until_ms()
                                 - ref),
                demand_link_ms=cb[CLS_DEMAND] + cb[CLS_PROMOTED],
                prefetch_link_ms=cb[CLS_PREFETCH],
                link_policy=s.link_policy,
                adapter_ready=slot is not None and s.pool.is_ready(slot),
                adapter_loading=slot is not None
                and not s.pool.is_ready(slot),
                free_pages=s.free_pages(),
                # memory-demand steering (paged servers): the request's KV
                # pages plus, when the adapter is not yet resident, the
                # pages its upload would claim from the same unified pool
                req_pages=(s.kv_page_demand(req)
                           + (0 if slot is not None or uid not in s.store
                              else s.pool.pages_for(
                                  s.store.specs[uid].nbytes(s.cfg))))
                if req is not None else 0,
                # KV over-subscription telemetry: lifetime counters plus
                # the windowed preemption rate calc_cost charges as extra
                # per-token cost (steering arrivals off thrashing pools)
                preemptions=s.preempt_stats["preemptions"],
                swapped_kv_pages=s.preempt_stats["swapped_pages"],
                recompute_tokens=s.preempt_stats["recompute_tokens"],
                oversub_ratio=s.oversub_ratio(),
                preempt_pressure=s.preempt_pressure(ref),
                # prefill plane: decode commitment depth + chunk budget let
                # calc_cost price the interference a routed prompt's
                # prefill inflicts on the resident decode batch
                decode_commit_tokens=s.decode_commit_tokens(),
                chunk_budget=s.chunk_budget,
                itl_p50_ms=itl.get("itl_p50_ms", 0.0),
                itl_p99_ms=itl.get("itl_p99_ms", 0.0),
                # failure plane: a browned-out link stretches the cold
                # start terms in calc_cost; fault/retry history steers
                # arrivals off flaky or freshly-restarted servers only
                # through the truthful occupancy stats above
                link_slowdown=s.cold.tracker.slowdown_at(ref),
                crashes=s.fault_stats["crashes"],
                restarts=s.fault_stats["restarts"],
                upload_retries=s.cold.tracker.stats["retries"],
                shed_requests=s.admission.shed_count,
                adopted_requests=s.fault_stats["adopted_requests"],
            ))
        return out

    def _rank(self, uid: str) -> Optional[int]:
        sp = self.specs.get(uid)
        if sp is None:            # registered on a server after __init__
            for s in self.servers:
                if uid in s.store:
                    sp = s.store.specs[uid]
                    self.specs[uid] = sp
                    break
        return sp.rank if sp is not None else None

    # ---------------------------------------------------------- routing ----
    def _should_shed(self, req: Request, rank: Optional[int],
                     stats: List[ServerStats]) -> bool:
        """Brownout back-pressure (`shed_policy="slo"`): when *every*
        alive server is decode-SLO-saturated, admitting one more request
        only deepens the violation — reject it at the router instead, a
        controlled SLO miss counted by `summarize`. Crash failovers never
        reach here (`allow_shed=False`): a recovered request always
        lands."""
        if self.shed_policy != "slo" or rank is None:
            return False
        sat = getattr(self.scheduler, "saturated", None)
        alive = [stats[i] for i in self._alive()]
        return sat is not None and bool(alive) \
            and sat(rank, alive, prefill_tokens=req.prompt_len)

    def _route(self, req: Request, now_ms: Optional[float] = None,
               allow_shed: bool = True) -> Optional[int]:
        """Pick a server for `req`; returns None when the request is shed
        (only possible with `shed_policy="slo"` and `allow_shed`).
        `now_ms` overrides the stats reference time for re-routing after
        a crash — the failover decision must see link/batch occupancy at
        crash time, not at the original arrival."""
        uid = req.adapter_uid
        rank = self._rank(uid)
        t0 = req.arrival_ms if now_ms is None else now_ms
        if self.placement is None:
            stats = self._stats(uid, t0, req=req)
            if allow_shed and self._should_shed(req, rank, stats):
                return None
            return self.scheduler.route(rank, stats,
                                        prefill_tokens=req.prompt_len)
        hosting = {i for i in self.placement.hosts(uid)
                   if i not in self.down}
        stats = self._stats(uid, t0, hosting, req=req)
        if allow_shed and self._should_shed(req, rank, stats):
            return None
        if hosting:
            sat = getattr(self.scheduler, "saturated", None)
            if sat is None or not sat(rank, [stats[i]
                                             for i in sorted(hosting)],
                                      prefill_tokens=req.prompt_len):
                return self.scheduler.route(rank, stats,
                                            prefill_tokens=req.prompt_len)
        # register-on-miss: no live replica, or every replica SLO-saturated.
        if uid not in self.specs:
            raise LookupError(f"unknown adapter {uid!r}: not registered "
                              "with the cluster")
        # Open the candidate set to every live server; servers whose host
        # store lacks the adapter are charged the one-time install on top
        # of the cold upload (a replica dropped from the routing map keeps
        # its store weights — and possibly a ready pool slot — so its
        # truthful adapter_ready/adapter_loading stats stand)
        for i in self._alive():
            if i in hosting:
                continue
            stats[i].hosts_adapter = True
            if uid not in self.servers[i].store:
                stats[i].miss_install_ms = self.miss_install_ms
        idx = self.scheduler.route(rank, stats,
                                   prefill_tokens=req.prompt_len)
        if idx not in hosting:
            if uid not in self.servers[idx].store:
                self.servers[idx].install_adapter(self.specs[uid], t0)
                self.placement_stats["miss_installs"] += 1
            else:
                self.placement_stats["replica_readds"] += 1
            self.placement.add_replica(uid, idx)
        return idx

    # -------------------------------------------------------- rebalance ----
    def _rebalance(self, now_ms: float):
        """Popularity-EWMA-driven replica add/drop pass: an adapter carrying
        share p of the aggregate EWMA targets
        ``ceil(p * n_alive * replica_spread)`` replicas (>=1, capped)."""
        if self.placement is None:
            return
        pop: Dict[str, float] = {}
        for s in self.servers:
            # time-indexed snapshot: every server's EWMA is faded to the
            # same instant, so a server whose traffic dried up does not
            # contribute a frozen peak score
            for u, v in s.admission.popularity(now_ms).items():
                pop[u] = pop.get(u, 0.0) + v
        total = sum(pop.values())
        alive = self._alive()
        if total <= 0.0 or not alive:
            return
        n = len(alive)
        adds_left = self.rebalance_max_adds
        for uid in sorted(pop, key=pop.get, reverse=True):
            if uid not in self.specs:
                continue
            target = replica_target(pop[uid] / total, n,
                                    self.replica_spread, self.max_replicas)
            hosts = [i for i in self.placement.hosts(uid)
                     if i not in self.down]
            while len(hosts) < target and adds_left > 0:
                cands = [i for i in alive
                         if i not in self.placement.hosts(uid)]
                if not cands:
                    break
                i = min(cands, key=self._server_load)
                srv = self.servers[i]
                srv.install_adapter(self.specs[uid], now_ms)
                self.placement.add_replica(uid, i)
                self.placement_stats["replica_adds"] += 1
                adds_left -= 1
                # warm the new replica: a speculative (prefetch-class)
                # upload rides the link; slots of running requests are
                # pinned (never the victim); if no slot is evictable the
                # first demand admit pays the upload instead. Under the
                # preempt link policy a demand cold start may cancel this
                # warm-up while it is still queued — the replica then warms
                # on first admission. A re-added replica may still be
                # resident from before its drop — no second upload then
                if srv.pool.lookup(uid) is None:
                    srv.cold.load_async(uid, max(now_ms, srv.clock),
                                        pinned=tuple(
                                            srv.admission.pinned_slots()),
                                        demand=False)
                hosts.append(i)
            while len(hosts) > target and len(hosts) > 1:
                i = max(hosts, key=self._server_load)
                if not self.placement.drop_replica(uid, i):
                    break
                self.placement_stats["replica_drops"] += 1
                hosts.remove(i)

    # ------------------------------------------------------ event-driven ----
    def run(self, requests: List[Request], max_iters: int = 2_000_000):
        if self.engine == "lockstep":
            return self._run_lockstep(requests, max_iters)
        pending = sorted(requests, key=lambda r: r.arrival_ms)
        heap: list = []
        seq = 0
        for req in pending:
            heapq.heappush(heap, (req.arrival_ms, ARRIVAL, seq, -1, req))
            seq += 1
        if pending and self.placement is not None \
                and self.rebalance_every_ms:
            t0 = pending[0].arrival_ms + self.rebalance_every_ms
            heapq.heappush(heap, (t0, REBALANCE, seq, -1, None))
            seq += 1
        if self.faults is not None:
            # flaky windows + brownouts hook the trackers directly; only
            # crash/restart are timeline events
            self.faults.attach(self)
            for fe in self.faults.timed_events():
                heapq.heappush(heap, (fe.t_ms, FAULT, seq, fe.server, fe))
                seq += 1
        n_arrived = 0                 # arrivals pop in time order: a pointer
        scheduled = [False] * len(self.servers)
        iters = 0

        def schedule(i: int, t: float):
            nonlocal seq
            if scheduled[i]:
                return
            t = max(t, self.servers[i].clock)
            heapq.heappush(heap, (t, WAKE, seq, i, None))
            scheduled[i] = True
            seq += 1

        while heap and iters < max_iters:
            t, kind, _, i, payload = heapq.heappop(heap)
            if kind == FAULT:
                self.event_counts["fault"] += 1
                if payload.kind == "crash":
                    for j in self._crash(i, t):
                        schedule(j, t)   # survivors adopt drained work now
                else:
                    self._restart(i, t)
                    schedule(i, t)       # harmless if it has nothing to do
                continue
            if kind == ARRIVAL:
                self.event_counts["arrival"] += 1
                n_arrived += 1
                idx = self._route(payload)
                if idx is None:          # brownout shed: controlled miss
                    st = RequestState(payload)
                    st.phase = "shed"
                    st.shed = True
                    self.shed_states.append(st)
                    self.fault_stats["shed"] += 1
                    if self.faults is not None:
                        self.faults.record(t, "shed", -1,
                                           f"rid={payload.rid}")
                    continue
                self.servers[idx].submit(payload)
                schedule(idx, t)
                continue
            if kind == REBALANCE:
                self.event_counts["rebalance"] += 1
                self._rebalance(t)
                if n_arrived < len(pending) \
                        or any(s.busy() for s in self.servers):
                    heapq.heappush(heap, (t + self.rebalance_every_ms,
                                          REBALANCE, seq, -1, None))
                    seq += 1
                continue
            # WAKE: classify from the cold-start plane's state *now* — an
            # upload that began (or retired) since the event was pushed is
            # labeled by what the server actually wakes to: a finish due
            # by t, or completions a routing-time poll already retired but
            # the engine has not drained yet
            scheduled[i] = False
            if i in self.down:
                continue                 # stale wake for a crashed server
            s = self.servers[i]
            nf = s.cold.tracker.next_finish_ms()
            load_done = (nf is not None and nf <= t) \
                or s.cold.pending_completions() > 0
            self.event_counts["load_done" if load_done else "iter"] += 1
            if not s.busy():
                continue
            if s.clock < t:
                s.clock = t          # idle server woken by a later event
            horizon = pending[n_arrived].arrival_ms \
                if n_arrived < len(pending) else None
            s.step(horizon_ms=horizon)
            iters += 1
            if s.busy():
                schedule(i, s.clock)
        return self._summarize()

    def _summarize(self):
        for s in self.servers:
            if s.backend:                # drain async token readbacks
                s.backend.flush_readback()
        states = [st for s in self.servers for st in s.states]
        states += self.shed_states       # zero-lost: n + shed == submitted
        return summarize(states), states

    # --------------------------------------------------- lockstep oracle ----
    def _advance(self, until_ms: float):
        for s in self.servers:
            while s.busy() and s.clock < until_ms:
                s.step(horizon_ms=until_ms)
            if s.clock < until_ms:
                s.clock = until_ms

    def _run_lockstep(self, requests: List[Request],
                      max_iters: int = 2_000_000):
        # placement-aware routing (incl. register-on-miss) is shared with
        # the event engine via _route; the rebalance pass is event-driven
        # only — lockstep is the static-placement oracle
        pending = sorted(requests, key=lambda r: r.arrival_ms)
        for req in pending:
            self._advance(req.arrival_ms)
            self.servers[self._route(req)].submit(req)
        iters = 0
        while any(s.busy() for s in self.servers) and iters < max_iters:
            for s in self.servers:
                if s.busy():
                    s.step()
            iters += 1
        return self._summarize()
