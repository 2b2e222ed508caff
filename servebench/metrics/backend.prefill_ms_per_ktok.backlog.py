"""Device milliseconds of the packed prefill calls (`prefill_admitted`)
a 1,000 prompt tokens, unpadded: CUDA events at each call's start and
end, outside the traced span, with no added synchronization."""
from servebench.harness import window_calls


def read(ctx):
    calls = window_calls(ctx, "prefill")
    tokens = sum(n for c in calls for n, _ in c.rows)
    if not tokens or calls[0].events is None:
        return None
    return sum(c.device_ms() for c in calls) / (tokens / 1e3)
