"""Workload generators (paper sec 7.1).

* synthetic: Poisson aggregate arrivals, each request targeting a distinct
  adapter (every request cold-starts — Punica's setting).
* maf_like: MAF-style skewed adapter popularity (the offline stand-in for the
  Azure Functions trace: Zipf-distributed invocation probabilities matching
  the shape of paper Fig 12), Poisson arrivals.
* Request lengths follow an Alpaca-like distribution (lognormal prompt/output
  lengths clipped to the serving window).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.lora import AdapterSpec
from repro_torch.serving.request import Request

RANK_CHOICES = (8, 16, 32, 64)


def alpaca_lengths(rng, n, max_prompt=128, max_out=128, scale=1.0):
    """Alpaca-like prompt/response token lengths."""
    p = np.clip(rng.lognormal(3.3, 0.8, n) * scale, 4, max_prompt)
    o = np.clip(rng.lognormal(3.9, 0.9, n) * scale, 4, max_out)
    return p.astype(int), o.astype(int)


def make_adapters(n, base_model, rng, ranks=RANK_CHOICES,
                  uniform_rank: Optional[int] = None) -> List[AdapterSpec]:
    return [AdapterSpec(uid=f"lora-{i}",
                        rank=int(uniform_rank or rng.choice(ranks)),
                        base_model=base_model) for i in range(n)]


def zipf_popularity(n, a=1.1, rng=None):
    """Invocation probability mass, shaped like paper Fig 12. With `rng`
    the mass is permuted across adapters, so which adapter is hot is
    seed-dependent — without this, adapter 0 was *always* the hottest and
    placement/prefetch experiments were accidentally aligned with adapter
    registration order."""
    w = 1.0 / np.arange(1, n + 1) ** a
    p = w / w.sum()
    if rng is not None:
        p = rng.permutation(p)
    return p


def trace_popularity(requests: Sequence[Request]) -> dict:
    """Empirical per-adapter request share of a trace (the popularity prior
    handed to popularity-aware placement; a warmup prefix works too)."""
    counts: dict = {}
    for r in requests:
        counts[r.adapter_uid] = counts.get(r.adapter_uid, 0) + 1
    total = max(sum(counts.values()), 1)
    return {u: c / total for u, c in counts.items()}


def poisson_arrivals(rng, rps: float, duration_s: float):
    t, out = 0.0, []
    while True:
        t += rng.exponential(1.0 / rps)
        if t > duration_s:
            return np.array(out)
        out.append(t)


def _build_requests(rng, arrivals, plens, olens, pick, vocab,
                    slo_tpt_ms) -> List[Request]:
    """Shared request-construction loop. `pick(i, t_s)` chooses the adapter
    for the i-th arrival (called in-loop so generators that draw the
    adapter from `rng` keep their stream order)."""
    reqs = []
    for i, t in enumerate(arrivals):
        ad = pick(i, t)
        prompt = rng.integers(0, vocab, plens[i]).astype(np.int32)
        reqs.append(Request(rid=i, adapter_uid=ad.uid, prompt=prompt,
                            max_new_tokens=int(olens[i]),
                            arrival_ms=float(t * 1e3),
                            slo_tpt_ms=slo_tpt_ms))
    return reqs


def synthetic_trace(adapters: Sequence[AdapterSpec], rps: float,
                    duration_s: float, vocab: int, seed: int = 0,
                    distinct: bool = True, slo_tpt_ms: Optional[float] = None,
                    max_prompt=128, max_out=128) -> List[Request]:
    """Poisson aggregate; `distinct` cycles adapters so that every request
    triggers a load (paper sec 7.1 synthetic workload)."""
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(rng, rps, duration_s)
    plens, olens = alpaca_lengths(rng, len(arrivals), max_prompt, max_out)
    pick = (lambda i, t: adapters[i % len(adapters)]) if distinct \
        else (lambda i, t: adapters[int(rng.integers(len(adapters)))])
    return _build_requests(rng, arrivals, plens, olens, pick, vocab,
                           slo_tpt_ms)


def maf_trace(adapters: Sequence[AdapterSpec], rps: float, duration_s: float,
              vocab: int, seed: int = 0, zipf_a: float = 1.1,
              slo_tpt_ms: Optional[float] = None,
              max_prompt=128, max_out=128) -> List[Request]:
    """Skewed-popularity production-like workload (paper Fig 12/14)."""
    rng = np.random.default_rng(seed)
    pop = zipf_popularity(len(adapters), zipf_a, rng)
    arrivals = poisson_arrivals(rng, rps, duration_s)
    n = len(arrivals)
    plens, olens = alpaca_lengths(rng, n, max_prompt, max_out)
    picks = rng.choice(len(adapters), size=n, p=pop)
    return _build_requests(rng, arrivals, plens, olens,
                           lambda i, t: adapters[int(picks[i])], vocab,
                           slo_tpt_ms)


def bimodal_prompt_trace(adapters: Sequence[AdapterSpec], rps: float,
                         duration_s: float, vocab: int, seed: int = 0,
                         zipf_a: float = 1.1, long_frac: float = 0.2,
                         short_prompt: int = 64, long_prompt: int = 512,
                         long_tail: float = 2.5, max_prompt: int = 2048,
                         max_out: int = 128,
                         slo_tpt_ms: Optional[float] = None
                         ) -> List[Request]:
    """Prefill-interference workload: MAF-style skewed popularity over
    Poisson arrivals, with a *bimodal* prompt-length mixture — a
    `long_frac` share of requests carries a long prompt (Pareto-tailed
    above `long_prompt`, shape `long_tail`, clipped to `max_prompt`), the
    rest an Alpaca-like short prompt around `short_prompt`. Long prompts
    are where monolithic prefill stalls the resident decode batch; this
    trace makes that interference measurable (bench_chunked's P99
    inter-token latency gate) while keeping the arrival/popularity
    machinery of `maf_trace`."""
    rng = np.random.default_rng(seed)
    pop = zipf_popularity(len(adapters), zipf_a, rng)
    arrivals = poisson_arrivals(rng, rps, duration_s)
    n = len(arrivals)
    plens, olens = alpaca_lengths(rng, n, short_prompt, max_out)
    is_long = rng.random(n) < long_frac
    tail = (long_prompt * rng.pareto(long_tail, n) + long_prompt)
    plens = np.where(is_long, np.clip(tail, long_prompt, max_prompt),
                     plens).astype(int)
    picks = rng.choice(len(adapters), size=n, p=pop)
    return _build_requests(rng, arrivals, plens, olens,
                           lambda i, t: adapters[int(picks[i])], vocab,
                           slo_tpt_ms)


def drifting_maf_trace(adapters: Sequence[AdapterSpec], rps: float,
                       duration_s: float, vocab: int, seed: int = 0,
                       zipf_a: float = 1.1, n_phases: int = 3,
                       slo_tpt_ms: Optional[float] = None,
                       max_prompt=128, max_out=128) -> List[Request]:
    """Placement-stressing workload: MAF-style skew whose *hot set drifts* —
    the Zipf mass is re-permuted every ``duration/n_phases`` seconds, so a
    static placement tuned to the opening phase goes stale and the cluster
    must register-on-miss / rebalance replicas to follow the traffic."""
    rng = np.random.default_rng(seed)
    pops = [zipf_popularity(len(adapters), zipf_a, rng)
            for _ in range(n_phases)]
    arrivals = poisson_arrivals(rng, rps, duration_s)
    plens, olens = alpaca_lengths(rng, len(arrivals), max_prompt, max_out)
    phase_s = duration_s / n_phases

    def pick(i, t):
        pop = pops[min(int(t / phase_s), n_phases - 1)]
        return adapters[int(rng.choice(len(adapters), p=pop))]

    return _build_requests(rng, arrivals, plens, olens, pick, vocab,
                           slo_tpt_ms)
