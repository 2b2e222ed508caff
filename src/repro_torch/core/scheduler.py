"""Rank-aware request scheduling (paper sec 5, Algorithm 1) + baselines.

Upon each arrival the scheduler gathers (running_batch, queue) from every
candidate server (base model + adapter + memory match), computes a cost score
from the performance models — the *additional* prefill time amortized over the
average response length plus the additional per-token decode time — adds a
large penalty if admitting would break the decode-latency SLO, weights by the
server's request count, and routes to the arg-min server.

Baselines (sec 7.5): MOSTIDLE (least workload), FIRSTFIT (first-fit bin
packing, Punica's policy), RANDOM.

Also the victim policy a single server runs when its page pool runs dry
mid-decode (`select_victim`). A copy of the reference's
`repro.core.scheduler`; its performance models default to the card the
port runs on (`core.perf_model`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.perf_model import ServerPerfModel

PENALTY = 1e6


@dataclasses.dataclass
class ServerStats:
    """Scheduler's view of one inference server."""
    running_ranks: List[int]
    queued_ranks: List[int]
    hosts_adapter: bool
    free_rows: int
    n_requests: int
    # async-load observability (LoadTracker): adapters mid-upload on the
    # host link, the link's remaining occupancy, and whether this request's
    # adapter is resident-and-ready on the device pool. link_busy_ms is the
    # *steering* term — the queueing delay a fresh demand upload would face,
    # i.e. the earliest-free-lane time after every upload the link policy
    # schedules ahead of it (fifo: all inflight uploads; priority/preempt:
    # demand class only, queued prefetch is jumped/canceled)
    loading_ranks: List[int] = dataclasses.field(default_factory=list)
    link_busy_ms: float = 0.0
    adapter_ready: bool = True    # resident AND upload landed
    adapter_loading: bool = False  # resident, upload still on the link
    # per-class link occupancy (link scheduler telemetry): remaining
    # transfer-ms owned by demand-class (demand + promoted-prefetch) vs
    # speculative prefetch uploads
    demand_link_ms: float = 0.0
    prefetch_link_ms: float = 0.0
    # the server's host-link scheduling policy (fifo | priority | preempt):
    # under `preempt` a demand upload reclaims speculative link occupancy,
    # so calc_cost discounts prefetch_link_ms from the queueing term
    link_policy: str = "fifo"
    # placement plane: routing here requires installing the adapter into the
    # server's host store first (register-on-miss); the one-time install cost
    # is charged like the prefill terms
    miss_install_ms: float = 0.0
    # paged memory plane: free pages in the server's unified KV/LoRA pool
    # (None = dense layout, not page-gated) and the pages this request
    # would claim there at admission (prompt KV, plus the adapter's pages
    # if it is not yet resident) — admission defers when demand exceeds
    # supply, so routing treats it like an SLO break
    free_pages: Optional[int] = None
    req_pages: int = 0
    # KV over-subscription telemetry: cumulative preemption counters plus
    # the *pressure* term routing steers by — recent preemptions per
    # second of simulated time (windowed rate, not the lifetime counter,
    # so a server that thrashed an hour ago is not penalized forever)
    preemptions: int = 0
    swapped_kv_pages: int = 0
    recompute_tokens: int = 0
    # admitted lifetime KV demand / pool capacity; > 1.0 means the server
    # is running over-subscribed and mid-decode exhaustion is possible
    oversub_ratio: float = 0.0
    preempt_pressure: float = 0.0
    # prefill plane: output tokens the resident batch is still committed
    # to produce (decode commitment depth — how much decode work a routed
    # prefill would stall), the server's chunk budget (0 = monolithic
    # prefill; the spike a long prompt injects is one chunk, not the whole
    # prompt), and observed inter-token-latency percentiles
    decode_commit_tokens: int = 0
    chunk_budget: int = 0
    itl_p50_ms: float = 0.0
    itl_p99_ms: float = 0.0
    # failure plane (core/faults.py): the link's current brownout factor
    # (1.0 = healthy; calc_cost scales the cold-start link terms by it so
    # arrivals steer away from degraded links), plus fault/retry/failover
    # telemetry
    link_slowdown: float = 1.0
    crashes: int = 0
    restarts: int = 0
    upload_retries: int = 0
    shed_requests: int = 0
    adopted_requests: int = 0

# ms of routing cost charged per unit of preempt_pressure (preemptions/s):
# a server preempting once per second looks this much slower per token,
# steering arrivals away from thrashing pools before they join the thrash
PREEMPT_PRESSURE_MS = 25.0


def calc_cost(req_rank: int, stats: ServerStats, perf: ServerPerfModel,
              slo_ms: Optional[float], avg_resp_len: float,
              penalty: float = PENALTY, prefill_tokens: int = 0) -> float:
    """CalcCost of Algorithm 1 (lines 13-23), extended with the async-load
    terms: adapters mid-upload will join the decode batch as soon as their
    load lands (count them in DecPerf), and a cold start on a server whose
    host link is already saturated additionally waits out the queue before
    its own upload can start (amortized like the prefill term). The queue
    term is per-class: `link_busy_ms` is what a *demand* upload actually
    waits under the server's link policy, so under priority/preempt a
    server whose link is saturated with cancellable speculative prefetch
    (`prefetch_link_ms` high, `demand_link_ms` low) is correctly not
    penalized for it. On a `preempt`-policy server the routing score goes
    further and discounts `prefetch_link_ms` from the queueing term
    outright: queued speculative occupancy will be canceled by the demand
    upload this routing decision creates. This is deliberately optimistic
    — a speculative upload already *started* on a lane runs to completion
    (preempt never aborts mid-transfer), so the score can understate the
    wait by up to one in-flight prefetch per lane; the bias steers demand
    toward servers whose occupancy is reclaimable, which is the intent of
    the per-class split at cluster scale."""
    exists = stats.running_ranks + stats.queued_ranks + stats.loading_ranks
    d_prefill = perf.pre_perf(stats.queued_ranks + [req_rank]) \
        - perf.pre_perf(stats.queued_ranks)
    if not stats.adapter_ready and not stats.adapter_loading:
        # fresh upload: queues behind the link, then pays its own transfer.
        # A server already uploading this adapter (adapter_loading) gives the
        # request a free ride on the in-flight transfer — no extra charge.
        link_wait = stats.link_busy_ms
        if stats.link_policy == "preempt":
            link_wait = max(0.0, link_wait - stats.prefetch_link_ms)
        # a browned-out link (failure plane) pays the slowdown factor on
        # both the queue drain and this request's own transfer, steering
        # cold starts toward healthy links while the brownout lasts
        d_prefill += (link_wait + perf.load_perf(req_rank)) \
            * stats.link_slowdown
    # register-on-miss: the host-store install precedes the upload
    d_prefill += stats.miss_install_ms
    d_decode = perf.dec_perf(exists + [req_rank]) - perf.dec_perf(exists)
    cost = d_prefill / max(avg_resp_len, 1.0) + d_decode
    if slo_ms is not None and perf.dec_perf(exists + [req_rank]) > slo_ms:
        cost += penalty
    if stats.free_pages is not None and stats.req_pages > stats.free_pages:
        # page-gated server cannot admit this request right now: it would
        # queue behind retirements/reclaim, so penalize like an SLO break
        cost += penalty
    # preemption pressure: an over-subscribed pool that is actively
    # swapping/recomputing will also preempt *this* request's KV — charge
    # the recent preemption rate as extra per-token cost so routing drains
    # thrashing servers instead of piling on
    cost += stats.preempt_pressure * PREEMPT_PRESSURE_MS
    # prefill/decode interference (decode commitment depth): every prefill
    # iteration this prompt needs stalls the whole resident decode batch
    # for one spike — the whole prompt at once on a monolithic server, one
    # chunk per iteration on a chunking one. The stall is felt by at most
    # one committed token per resident row per spike, so long prompts are
    # steered away from servers with deep resident decode batches, and a
    # chunking server's many-small-spikes profile is charged accordingly.
    if prefill_tokens > 0 and stats.running_ranks:
        cb = stats.chunk_budget
        spike = perf.prefill_spike_ms(prefill_tokens, cb)
        n_spikes = -(-prefill_tokens // cb) if 0 < cb < prefill_tokens else 1
        exposed = min(stats.decode_commit_tokens,
                      n_spikes * len(stats.running_ranks))
        cost += spike * exposed / max(avg_resp_len, 1.0)
    return cost


def select_victim(states, exclude=()):
    """Victim policy for mid-decode page exhaustion: among the running
    rows, preempt the least-recently-advanced request (LRU by last token
    time — the row that has waited longest is the one whose batch slot is
    cheapest to take, matching S-LoRA's preemptive scheduling), breaking
    ties SLO-aware: prefer victims without a time-per-token SLO, then the
    loosest SLO (most slack), then the lowest rid for determinism.
    `states` are candidate RequestStates; `exclude` are states that must
    not be chosen (e.g. the row whose growth triggered the hunt). Returns
    None when no candidate remains."""
    skip = set(id(s) for s in exclude)
    cands = [s for s in states if s is not None and id(s) not in skip]
    if not cands:
        return None

    def key(st):
        last = st.token_times_ms[-1] if st.token_times_ms else (
            st.first_token_ms if st.first_token_ms is not None
            else st.req.arrival_ms)
        slack = st.req.slo_tpt_ms if st.req.slo_tpt_ms is not None \
            else float("inf")
        return (last, -slack, st.req.rid)

    return min(cands, key=key)


class RankAwareScheduler:
    """Algorithm 1."""
    name = "rank_aware"

    def __init__(self, perf: ServerPerfModel, slo_ms: Optional[float] = None,
                 avg_resp_len: float = 64.0, penalty: float = PENALTY):
        self.perf = perf
        self.slo_ms = slo_ms
        self.avg_resp_len = avg_resp_len
        self.penalty = penalty

    def route(self, req_rank: int, stats: Sequence[ServerStats],
              prefill_tokens: int = 0) -> int:
        cands = [i for i, s in enumerate(stats) if s.hosts_adapter]
        if not cands:
            raise LookupError("no server hosts the adapter")
        best, best_cost = cands[0], float("inf")
        for i in cands:
            cost = calc_cost(req_rank, stats[i], self.perf, self.slo_ms,
                             self.avg_resp_len, self.penalty,
                             prefill_tokens=prefill_tokens)
            total = cost * stats[i].n_requests   # Algo 1 line 8 (idle -> 0)
            if total < best_cost:
                best, best_cost = i, total
        return best

    def saturated(self, req_rank: int, stats: Sequence[ServerStats],
                  prefill_tokens: int = 0) -> bool:
        """True when *every* given server would break the decode SLO by
        admitting this request — the cluster's trigger for opening the
        candidate set to non-hosting servers (register-on-miss)."""
        if self.slo_ms is None or not stats:
            return False
        return all(calc_cost(req_rank, s, self.perf, self.slo_ms,
                             self.avg_resp_len, self.penalty,
                             prefill_tokens=prefill_tokens) >= self.penalty
                   for s in stats)


class MostIdleScheduler:
    name = "most_idle"

    def route(self, req_rank, stats, prefill_tokens=0):
        cands = [i for i, s in enumerate(stats) if s.hosts_adapter]
        if not cands:
            raise LookupError("no server hosts the adapter")
        return min(cands, key=lambda i: stats[i].n_requests)


class FirstFitScheduler:
    """First-fit bin packing (Punica): first candidate with a free slot,
    else the first candidate."""
    name = "first_fit"

    def route(self, req_rank, stats, prefill_tokens=0):
        cands = [i for i, s in enumerate(stats) if s.hosts_adapter]
        if not cands:
            raise LookupError("no server hosts the adapter")
        for i in cands:
            if stats[i].free_rows > 0:
                return i
        return cands[0]


class RandomScheduler:
    name = "random"

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def route(self, req_rank, stats, prefill_tokens=0):
        cands = [i for i, s in enumerate(stats) if s.hosts_adapter]
        if not cands:
            raise LookupError("no server hosts the adapter")
        return int(self.rng.choice(cands))


def make_scheduler(name: str, perf: ServerPerfModel = None, **kw):
    if name == "rank_aware":
        return RankAwareScheduler(perf, **kw)
    if name == "most_idle":
        return MostIdleScheduler()
    if name == "first_fit":
        return FirstFitScheduler()
    if name == "random":
        return RandomScheduler(kw.get("seed", 0))
    raise ValueError(name)
