"""The model's useful FLOPs of the calls inside the traced span (real
tokens and contexts, live ranks, no padding: `roofline.call_flops`) over
the span's wall time x the chip's peak, in %."""
from servebench.harness import window_calls
from servebench.roofline import call_flops


def read(ctx):
    calls = window_calls(ctx, profiled=True)
    if not calls or ctx.profile.window_s <= 0:
        return None
    flops = sum(call_flops(ctx.spec, c) for c in calls)
    return 100.0 * flops / (ctx.profile.window_s * ctx.peaks["flops"])
