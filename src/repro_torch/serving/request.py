"""Request/response types and per-request serving metrics (paper sec 7.1:
time-to-first-token, time-per-token, request latency)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    adapter_uid: str
    prompt: np.ndarray                 # (L,) int32 token ids
    max_new_tokens: int
    arrival_ms: float = 0.0
    slo_tpt_ms: Optional[float] = None # time-per-token SLO

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))


@dataclasses.dataclass
class RequestState:
    req: Request
    row: int = -1                      # batch row in the engine
    phase: str = "queued"              # queued | loading | prefill | decode | done
    generated: List[int] = dataclasses.field(default_factory=list)
    first_token_ms: Optional[float] = None
    finish_ms: Optional[float] = None
    token_times_ms: List[float] = dataclasses.field(default_factory=list)
    cold_start: bool = False
    assist_used: bool = False          # CPU-assisted prefill engaged
    ready_ms: float = 0.0              # decode may include this request after
    load_finish_ms: Optional[float] = None  # adapter upload completion
    flip_ms: Optional[float] = None    # CPU-assist -> device pool switch
    # tokens sampled on device but not yet read back to `generated` (the
    # numerics plane's async readback queue); the engine's control flow
    # counts them via `issued` so completion never waits on a host sync
    pending_tokens: int = 0
    # paged memory plane: physical KV pages claimed for this request —
    # prompt pages at admission, grown lazily as decode crosses page
    # boundaries (logical page j of the row's block table -> kv_pages[j]);
    # freed when the row is released or the request is preempted.
    kv_pages: List[int] = dataclasses.field(default_factory=list)
    # KV over-subscription: when the allocator runs dry mid-decode the
    # victim policy preempts rows — pages are freed and the request goes
    # back on the queue with a resume plan ("swap" re-uploads the saved
    # page payload through the link scheduler; "recompute" rebuilds KV by
    # re-prefilling prompt + generated-so-far). `resume_pos` is the next
    # decode position at preemption time == KV slots that must be restored.
    preempted: bool = False           # queued awaiting resume
    preemptions: int = 0              # times this request was preempted
    resume_kind: str = ""             # "swap" | "recompute" while queued
    resume_pos: int = 0
    swap_payload: Optional[object] = None   # host copy of the KV pages
    kv_resume_ms: float = 0.0         # swap-in upload completes (link time)
    # chunked prefill: prompt tokens whose KV has been materialized so far.
    # Monolithic admissions set this to prompt_len in one shot; the chunked
    # path advances it chunk by chunk, and a preemptive swap of a
    # half-prefilled row preserves it so resume restores chunk progress.
    prefill_pos: int = 0
    # failure plane (core/faults.py): `shed` marks a request the cluster
    # or admission plane rejected under brownout (phase "shed", never
    # completes — counted as an SLO miss, not a lost request); `recovered`
    # counts crash failovers (drained off a dead server and re-admitted on
    # a survivor); `assist_decode` flags a decode row currently riding the
    # CPU-assist path because its adapter upload is mid-retry.
    shed: bool = False
    recovered: int = 0
    assist_decode: bool = False

    @property
    def issued(self) -> int:
        """Tokens produced for this request, whether or not their values
        have crossed back to the host yet."""
        return len(self.generated) + self.pending_tokens

    @property
    def done(self) -> bool:
        return self.issued >= self.req.max_new_tokens

    # ------------------------------------------------------- metrics ----
    def ttft_ms(self) -> float:
        return self.first_token_ms - self.req.arrival_ms

    def tpt_ms(self) -> float:
        """Average time per output token (perceived speed)."""
        n = max(len(self.generated), 1)
        return (self.finish_ms - self.req.arrival_ms) / n

    def latency_ms(self) -> float:
        return self.finish_ms - self.req.arrival_ms

    def slo_met(self) -> bool:
        if self.req.slo_tpt_ms is None:
            return True
        return self.tpt_ms() <= self.req.slo_tpt_ms

    def itl_ms(self) -> List[float]:
        """Inter-token latencies: gaps between consecutive emitted tokens.
        The first token's wait is TTFT, not ITL, so a request contributes
        len(token_times_ms) - 1 samples."""
        ts = self.token_times_ms
        return [ts[i + 1] - ts[i] for i in range(len(ts) - 1)]


def itl_percentiles(samples) -> dict:
    """P50/P99/mean over a pool of inter-token-latency gaps (ms)."""
    arr = np.asarray(list(samples), dtype=np.float64)
    if arr.size == 0:
        return {"n_gaps": 0, "itl_mean_ms": 0.0,
                "itl_p50_ms": 0.0, "itl_p99_ms": 0.0}
    return {
        "n_gaps": int(arr.size),
        "itl_mean_ms": float(arr.mean()),
        "itl_p50_ms": float(np.median(arr)),
        "itl_p99_ms": float(np.percentile(arr, 99)),
    }


def summarize(states) -> dict:
    """Aggregate serving metrics. Shed requests (brownout rejections)
    never complete: they are excluded from the latency pools but count
    against `slo_attainment` — shedding is a controlled SLO miss, not a
    free pass — and `n + shed` accounts for every submitted request
    (the zero-lost invariant the chaos bench asserts)."""
    done = [s for s in states if s.finish_ms is not None]
    n_shed = sum(1 for s in states if getattr(s, "shed", False))
    if not done:
        return {"n": 0, "shed": int(n_shed)}
    ttft = np.array([s.ttft_ms() for s in done])
    tpt = np.array([s.tpt_ms() for s in done])
    lat = np.array([s.latency_ms() for s in done])
    met = sum(s.slo_met() for s in done)
    return {
        "n": len(done),
        "ttft_mean": float(ttft.mean()), "ttft_p50": float(np.median(ttft)),
        "ttft_p99": float(np.percentile(ttft, 99)),
        "tpt_mean": float(tpt.mean()), "tpt_p50": float(np.median(tpt)),
        "tpt_p99": float(np.percentile(tpt, 99)),
        "latency_mean": float(lat.mean()),
        "latency_p50": float(np.median(lat)),
        "latency_p99": float(np.percentile(lat, 99)),
        "slo_attainment": float(met / (len(done) + n_shed)),
        "cold_starts": int(sum(s.cold_start for s in done)),
        "assisted": int(sum(s.assist_used for s in done)),
        "flipped": int(sum(s.flip_ms is not None for s in done)),
        "preempted": int(sum(s.preemptions > 0 for s in done)),
        "preemptions": int(sum(s.preemptions for s in done)),
        "shed": int(n_shed),
        "recovered": int(sum(s.recovered > 0 for s in done)),
        "failovers": int(sum(s.recovered for s in done)),
        **itl_percentiles(g for s in done for g in s.itl_ms()),
    }
