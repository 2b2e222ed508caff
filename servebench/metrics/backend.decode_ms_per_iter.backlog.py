"""Device milliseconds a decode iteration: CUDA events at the start and
end of every `decode` / `megastep` call of the window outside the traced
span, with no added synchronization, summed over the iterations they ran
(a megastep of K runs K)."""
from servebench.harness import window_calls


def read(ctx):
    calls = window_calls(ctx, "decode")
    iters = sum(c.iters for c in calls)
    if not iters or calls[0].events is None:
        return None
    return sum(c.device_ms() for c in calls) / iters
