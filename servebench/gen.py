"""Traffic generation: one general generator that reads a mix file
(`servebench/traffic/<mix>.json`) and makes the requests of a run from
`--seed`.

Adapted copies of the port's `traces/gen.py` (`zipf_popularity`,
`alpaca_lengths`), kept here so that the yardstick does not move when the
program does. The adaptation: every seed gets the same sizes, in another
order. Requests come in blocks of `block`; a block's prompt and output
lengths are the distribution's quantiles at (i + 0.5) / block, and its
adapters are a systematic sample of the Zipf popularity (one random
offset a block), each shuffled by the block's generator. So a run's work
depends on the seed only through its order. The harness keeps the queue
at least `max_batch` deep (a backlog): there are no arrival times.

A mix file holds:
  source   where its lengths come from
  prompt / output  {"dist": "lognormal", "median", "sigma", "min", "max"}
  adapters {"ranks": [...], "per_rank": n, "zipf_alpha": a}
  block    requests a block
  server   the InferenceServer's settings for this mix
  trace_span_s  the traced run's span (s)
"""
from __future__ import annotations

import dataclasses
import json
import statistics
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
_NORMAL = statistics.NormalDist()


def load_mix(name: str, root: Path = HERE) -> dict:
    path = root / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} at {path}")
    return json.loads(path.read_text())


# ------------------------------------------------------------ adapters ----

@dataclasses.dataclass(frozen=True)
class AdapterPlan:
    uid: str
    rank: int


def adapter_plans(mix: dict) -> List[AdapterPlan]:
    """`per_rank` adapters of each rank, in rank order: a00 .. a63."""
    ad = mix["adapters"]
    out = []
    for r in ad["ranks"]:
        for _ in range(ad["per_rank"]):
            out.append(AdapterPlan(f"a{len(out):02d}", int(r)))
    return out


def zipf_popularity(n: int, a: float, rng=None) -> np.ndarray:
    """Invocation probability mass 1 / k^a over n adapters, permuted by
    `rng` across adapters (which adapter is hot depends on the seed)."""
    w = 1.0 / np.arange(1, n + 1) ** a
    p = w / w.sum()
    if rng is not None:
        p = rng.permutation(p)
    return p


# ------------------------------------------------------------- lengths ----

def quantiles(block: int) -> np.ndarray:
    return (np.arange(block) + 0.5) / block


def lengths(spec: dict, block: int) -> np.ndarray:
    """A block's lengths: the distribution's quantiles at (i + 0.5) /
    block, clipped to [min, max] and rounded (`alpaca_lengths`, adapted:
    lognormal by its median and sigma)."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    z = np.array([_NORMAL.inv_cdf(float(v)) for v in quantiles(block)])
    x = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(int)


def zipf_picks(p_sorted: np.ndarray, block: int, u: float) -> np.ndarray:
    """Systematic sample of `block` popularity ranks from the sorted
    mass: positions (i + u) / block through the inverse CDF."""
    cdf = np.cumsum(p_sorted)
    cdf[-1] = 1.0
    pos = (np.arange(block) + u) / block
    return np.searchsorted(cdf, pos, side="right")


# ------------------------------------------------------------ requests ----

@dataclasses.dataclass
class Planned:
    rid: int
    adapter: str
    prompt: np.ndarray
    max_new: int


class Traffic:
    """The requests of one run, made block by block as they are needed.
    Block b draws from `np.random.default_rng([seed, b])`; the popularity
    permutation from `np.random.default_rng([seed, 2**32])`."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = vocab
        self.seed = int(seed)
        self.block = int(mix["block"])
        self.adapters = adapter_plans(mix)
        alpha = mix["adapters"]["zipf_alpha"]
        n = len(self.adapters)
        self.p_sorted = zipf_popularity(n, alpha)
        # popularity rank -> adapter, independent of the adapters' ranks
        self.by_rank = np.random.default_rng(
            [self.seed, 2 ** 32]).permutation(n)
        self._plens = lengths(mix["prompt"], self.block)
        self._olens = lengths(mix["output"], self.block)

    def longest_context(self) -> int:
        """The longest prompt plus the longest output: every seed's."""
        return int(self._plens.max() + self._olens.max())

    def blocks(self) -> Iterator[List[Planned]]:
        b = 0
        while True:
            rng = np.random.default_rng([self.seed, b])
            plens = rng.permutation(self._plens)
            olens = rng.permutation(self._olens)
            picks = rng.permutation(
                zipf_picks(self.p_sorted, self.block, float(rng.random())))
            out = []
            for i in range(self.block):
                prompt = rng.integers(0, self.vocab, int(plens[i]),
                                      dtype=np.int32)
                ad = self.adapters[int(self.by_rank[picks[i]])]
                out.append(Planned(b * self.block + i, ad.uid, prompt,
                                   int(olens[i])))
            yield out
            b += 1

    def stream(self) -> Iterator[Planned]:
        for blk in self.blocks():
            yield from blk


def bucket(n: int, lo: int = 8) -> int:
    """The power of two (from `lo`) that a length rounds up to, as the
    backend buckets a packed prefill."""
    b = lo
    while b < n:
        b *= 2
    return b


def rank_of(mix: dict) -> Dict[str, int]:
    return {a.uid: a.rank for a in adapter_plans(mix)}


def batch_buckets(max_batch: int) -> List[int]:
    out, n = [], 1
    while n <= max_batch:
        out.append(n)
        n *= 2
    return out


def prefill_buckets(mix: dict, max_batch: int, cache_slots: int
                    ) -> List[Tuple[int, int]]:
    """Every (Nb, Lp) the backend can bucket this mix's admissions into."""
    lps = {min(bucket(int(n)), cache_slots)
           for n in lengths(mix["prompt"], int(mix["block"]))}
    return [(nb, lp) for nb in batch_buckets(max_batch) for lp in sorted(lps)]
