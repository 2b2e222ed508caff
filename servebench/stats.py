"""End-to-end metric arithmetic over the host's wall-clock stamps.

Each request is tracked from the wall time of its submission (the
harness submits it the moment the queue needs it), and every token gets
the wall time of the end of the `step()` after which it first appeared
in the request's `generated` list (the port reads tokens back one step
behind the dispatch, so that is when a user would see it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence


@dataclasses.dataclass
class Tracked:
    rid: int
    adapter: str
    rank: int
    prompt_len: int
    max_new: int
    submitted: float                 # wall s
    state: object = None             # the port's RequestState
    stamps: List[float] = dataclasses.field(default_factory=list)
    failed: bool = False

    @property
    def done(self) -> bool:
        return len(self.stamps) >= self.max_new


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile (p in (0, 100]); infinities allowed."""
    v = sorted(values)
    if not v:
        return math.nan
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def tokens_in(reqs: Sequence[Tracked], t0: float, t1: float) -> int:
    return sum(1 for r in reqs for s in r.stamps if t0 <= s <= t1)


def tokens_per_s(reqs, t0, t1) -> float:
    return tokens_in(reqs, t0, t1) / (t1 - t0)


def tpot_ms(r: Tracked) -> float:
    return 1e3 * (r.stamps[-1] - r.stamps[0]) / (len(r.stamps) - 1)


def tpot_p90_ms(reqs, t0, t1, p: float = 90.0) -> float:
    """Over every request whose last token landed in [t0, t1]."""
    vals = [tpot_ms(r) for r in reqs if r.done and len(r.stamps) > 1
            and t0 <= r.stamps[-1] <= t1]
    return percentile(vals, p)
