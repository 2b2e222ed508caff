"""Rank-aware performance models (paper sec 5, Fig 9).

    Perf_BGMV(S)  = alpha_B * |S| * max_{i in S} rank(i) + beta_B
    Perf_MBGMV(S) = alpha_M * sum_{i in S} rank(i)       + beta_M

Fitted by lightweight serving-performance profiling over varying batch sizes
and heterogeneous rank mixes; the profiler here is the analytic TimingModel
(same methodology as the paper's simulator, sec 7.5). The fit quality (R^2)
reproduces Fig 9's ~0.96 when profiling noise is enabled.

A copy of the reference's `repro.core.perf_model` whose hardware defaults
to the card the port runs on (`core.timing.H100`), so the router's
DecPerf/PrePerf and the SLO derived from them describe that card's
simulated timeline. `fit_linear` also fits step times measured on the card
(chip_smoke.py phase 3e).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.timing import H100, Hardware, TimingModel


def batch_feature(ranks: Sequence[int], kernel: str) -> float:
    if not ranks:
        return 0.0
    if kernel == "bgmv":
        return len(ranks) * max(ranks)
    return float(sum(ranks))


@dataclasses.dataclass
class LinearPerfModel:
    alpha: float
    beta: float
    kernel: str               # bgmv | mbgmv
    r2: float = 1.0

    def predict(self, ranks: Sequence[int]) -> float:
        """Predicted iteration latency (ms) for a batch of adapter ranks."""
        if not ranks:
            return 0.0
        return self.alpha * batch_feature(ranks, self.kernel) + self.beta


def fit_linear(xs, ys, kernel: str) -> LinearPerfModel:
    xs = np.asarray(xs, float)
    ys = np.asarray(ys, float)
    A = np.stack([xs, np.ones_like(xs)], axis=1)
    (alpha, beta), *_ = np.linalg.lstsq(A, ys, rcond=None)
    pred = alpha * xs + beta
    ss_res = float(((ys - pred) ** 2).sum())
    ss_tot = float(((ys - ys.mean()) ** 2).sum()) or 1.0
    return LinearPerfModel(float(alpha), float(beta), kernel,
                           r2=1.0 - ss_res / ss_tot)


def profile_and_fit(cfg: ModelConfig, kernel: str, hw: Hardware = H100,
                    noise: float = 0.02, seed: int = 0,
                    rank_choices=(8, 16, 32, 64), batch_sizes=None,
                    n_samples: int = 200, avg_ctx: int = 512):
    """Profile decode iterations over random heterogeneous batches and fit
    the linear law (reproduces Fig 9)."""
    tm = TimingModel(cfg, hw)
    rng = np.random.default_rng(seed)
    batch_sizes = batch_sizes or [1, 2, 4, 8, 16, 24, 32, 48, 64]
    xs, ys = [], []
    for _ in range(n_samples):
        bs = int(rng.choice(batch_sizes))
        ranks = [int(rng.choice(rank_choices)) for _ in range(bs)]
        lat = tm.base_decode_ms(bs, avg_ctx) + tm.lora_decode_ms(ranks, kernel)
        lat *= float(1.0 + rng.normal(0, noise))
        xs.append(batch_feature(ranks, kernel))
        ys.append(lat)
    return fit_linear(xs, ys, kernel), (xs, ys)


@dataclasses.dataclass
class ServerPerfModel:
    """PrePerf / DecPerf pair used by Algorithm 1."""
    cfg: ModelConfig
    kernel: str = "bgmv"
    hw: Hardware = H100
    decode: Optional[LinearPerfModel] = None
    avg_prompt: int = 128

    def __post_init__(self):
        if self.decode is None:
            self.decode, _ = profile_and_fit(self.cfg, self.kernel, self.hw)
        self._tm = TimingModel(self.cfg, self.hw)

    def dec_perf(self, ranks: Sequence[int]) -> float:
        """Decode-iteration latency (ms) for a batch of ranks."""
        return self.decode.predict(ranks)

    def pre_perf(self, ranks: Sequence[int], tokens_each: int = None) -> float:
        """Prefill latency (ms) for queued requests (sequential prefills)."""
        if not ranks:
            return 0.0
        t = tokens_each or self.avg_prompt
        total = 0.0
        for r in ranks:
            total += self._tm.base_prefill_ms(t) \
                + self._tm.lora_prefill_gpu_ms(t, r)
        return total

    def prefill_spike_ms(self, tokens: int, chunk_budget: int = 0) -> float:
        """Worst single-iteration stall this prompt's prefill injects into
        a resident decode batch: the whole prompt at once on a monolithic
        server, one chunk (at its deepest context, where the quadratic
        attention term peaks) on a chunking server."""
        if tokens <= 0:
            return 0.0
        if 0 < chunk_budget < tokens:
            return self._tm.chunk_prefill_ms(chunk_budget,
                                             tokens - chunk_budget)
        return self._tm.base_prefill_ms(tokens)

    def load_perf(self, rank: int) -> float:
        """Host->device upload latency (ms) of a rank-`rank` adapter — the
        marginal link occupancy a cold start adds (Algorithm 1 extension for
        the async LoadTracker)."""
        from repro_torch.core.lora import AdapterSpec
        spec = AdapterSpec("_probe", rank, self.cfg.name)
        return self._tm.load_ms(spec.nbytes(self.cfg))
