"""Token sampling for the serving engine, on the device.

Greedy (temperature <= 0) is the first maximal index, as the reference's
argmax. Temperature sampling is the Gumbel-max form of
`jax.random.categorical`: argmax(logits / T - log(-log(u))) with u
uniform in (0, 1), drawn in f32 from the caller's `torch.Generator` (the
backend's decode pipeline owns one, seeded like the reference's key).
Every call draws one full (rows, vocab) block whatever rows are active,
so K single decode steps consume exactly the draws of one K-step
megastep. The streams are not JAX's: they are held to the reference by
their distribution, never token for token.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, *, temperature: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32. temperature <= 0 -> greedy."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / temperature + gumbel,
                        dim=-1).to(torch.int32)
