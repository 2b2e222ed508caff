"""Token sampling for the serving engine: greedy argmax on the device.

Temperature sampling is not ported yet (ROADMAP.md queue 1): the
reference draws from `jax.random.categorical`, whose stream torch cannot
reproduce, so it needs its own Philox-seeded path and a distribution test.
"""
from __future__ import annotations

import torch


def sample(logits: torch.Tensor, *, temperature: float = 0.0
           ) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32. Greedy: the first maximal index, as
    the reference's argmax."""
    if temperature > 0.0:
        raise NotImplementedError(
            "temperature sampling is not ported to repro_torch yet "
            "(ROADMAP.md queue 1)")
    return torch.argmax(logits, dim=-1).to(torch.int32)
