"""The yardstick's arithmetic: the table of peaks, and the operations and
bytes of the useful work of the port's calls, counted from shapes.

Useful work only: real prompt tokens (no bucket padding), real context
lengths, each row's live LoRA rank, and the output head at the positions
that are sampled (the port gathers the last position before its head).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

# Published dense peaks (NVIDIA data sheets), bf16 tensor-core FLOP/s and
# HBM bytes/s, by the name `torch.cuda.get_device_name()` gives.
PEAKS = {
    "H100 SXM": {"flops": 989e12, "bytes": 3.35e12},
    "H100 NVL": {"flops": 835e12, "bytes": 3.9e12},
    "H100 PCIe": {"flops": 756e12, "bytes": 2.0e12},
}


def peaks(device_name: str) -> Dict[str, float]:
    if "H100" not in device_name:
        raise ValueError(f"no peaks for {device_name!r}")
    if "PCIe" in device_name:
        return PEAKS["H100 PCIe"]
    if "NVL" in device_name:
        return PEAKS["H100 NVL"]
    return PEAKS["H100 SXM"]


def lora_width(spec) -> int:
    """Sum over the LoRA targets of d_in + d_out, for one layer."""
    return sum(sum(spec.lora_dims(t)) for t in spec.lora_targets)


def token_flops(spec, ctx: int, rank: int, head: bool) -> float:
    """One token through the model at context length `ctx` (the token
    itself included): the layers' matrix products, attention over ctx
    keys (QK and PV), the LoRA factors at `rank`, and the head if the
    token is sampled."""
    L = spec.n_layers
    f = 2.0 * spec.matmul_params_a_layer() * L
    f += 4.0 * spec.n_heads * spec.hd * ctx * L
    f += 2.0 * rank * lora_width(spec) * L
    if head:
        f += 2.0 * spec.d_model * spec.vocab
    return f


def prefill_flops(spec, length: int, rank: int) -> float:
    """A prompt of `length` tokens, causal, its last position sampled."""
    L = spec.n_layers
    f = 2.0 * spec.matmul_params_a_layer() * L * length
    f += 4.0 * spec.n_heads * spec.hd * L * length * (length + 1) / 2
    f += 2.0 * rank * lora_width(spec) * L * length
    return f + 2.0 * spec.d_model * spec.vocab


def call_flops(spec, call) -> float:
    """The useful FLOPs of one backend call (`trace.Call`)."""
    if call.kind == "prefill":
        return sum(prefill_flops(spec, n, r) for n, r in call.rows)
    return sum(token_flops(spec, pos + k + 1, r, True)
               for pos, r, n in call.rows for k in range(n))


def lora_least_s(spec, rows: Sequence[Tuple[int, int, str]],
                 pk: Dict[str, float]) -> float:
    """Least time of one model step's LoRA pairs (every layer, every
    target): `rows` holds (tokens, rank, adapter) per request in the
    step. Each target's pair reads the rows of x and each distinct
    adapter's A[:, :r] and B[:r, :] once and writes the rows of y
    (bf16); it does 2 r (d_in + d_out) operations a row."""
    adapters = {a: r for _, r, a in rows}
    n = sum(t for t, _, _ in rows)
    total = 0.0
    for tgt in spec.lora_targets:
        d_in, d_out = spec.lora_dims(tgt)
        nbytes = 2.0 * (n * (d_in + d_out)
                        + sum(r * (d_in + d_out) for r in adapters.values()))
        ops = sum(2.0 * t * r * (d_in + d_out) for t, r, _ in rows)
        total += max(nbytes / pk["bytes"], ops / pk["flops"])
    return total * spec.n_layers


def call_lora_least_s(spec, call, pk) -> float:
    """The LoRA pairs' least time over one backend call: a prefill is one
    step over its prompts; a decode is one step, a megastep one step an
    iteration over the rows still producing."""
    if call.kind == "prefill":
        return lora_least_s(spec, [(n, r, a) for (n, r), a
                                   in zip(call.rows, call.adapters)], pk)
    iters = max((n for _, _, n in call.rows), default=0)
    return sum(lora_least_s(spec, [(1, r, a) for (_, r, n), a
                                   in zip(call.rows, call.adapters) if n > k],
                            pk) for k in range(iters))

