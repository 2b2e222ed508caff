"""RetraceSan — steady-state re-capture detector of the port's CUDA
graphs (`core.graphs`).

A copy of the reference's `repro.analysis.retrace`, with the port's
meaning: where the reference's jitted step retraces on a new (shape,
dtype, static-arg) signature, the port's graphed step re-captures when
the signature of the tensors it reads changes: a new shape, or a buffer
rebound instead of written in place, whose stale graph would otherwise
read freed memory. `RetraceSan.observe(name, fn)` samples
``fn._cache_size()`` (the signatures a `core.graphs` entry was built for)
after each dispatch; once `mark_steady()` is called, any growth of a
previously observed entry is recorded as a violation and
`assert_clean()` raises. Warm-up captures (before `mark_steady`) are
expected and ignored: the server captures once per key (`decode`,
`megastep[K=k]`, `prefill[Nb=n,Lp=l]`, and `prefill_chunk[C=c]` /
`prefill_chunk_final[C=c]`, named as the reference's keys), the trainer
once (`train`), and each must then stay capture-stable.

Hooked into `core.backend.NumericsBackend` and `launch.train.Trainer`
behind `sanitizers.enabled()`; tests drive `mark_steady`/`assert_clean`
directly.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.analysis.sanitizers import SanitizerError


class RetraceError(SanitizerError):
    pass


def _cache_size(fn) -> Optional[int]:
    try:
        return int(fn._cache_size())
    except Exception:
        return None


class RetraceSan:
    def __init__(self):
        self._sizes: Dict[str, int] = {}
        self._steady = False
        self.violations: List[str] = []

    def observe(self, name: str, fn) -> None:
        """Record the signature-cache size of `fn` after a dispatch under
        `name`. Growth after `mark_steady()` is a violation."""
        size = _cache_size(fn)
        if size is None:
            return
        prev = self._sizes.get(name)
        if prev is not None and size > prev and self._steady:
            self.violations.append(
                f"{name}: graph cache grew {prev} -> {size} after "
                "steady state")
        self._sizes[name] = size

    def mark_steady(self) -> None:
        """Declare warm-up over: every observed step must now be
        capture-stable."""
        self._steady = True

    def reset(self) -> None:
        self._sizes.clear()
        self._steady = False
        self.violations.clear()

    def assert_clean(self) -> None:
        if self.violations:
            raise RetraceError(
                "RetraceSan: steady-state re-capture detected — "
                + "; ".join(self.violations))
