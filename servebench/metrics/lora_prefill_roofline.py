"""The prefill LoRA pair (the row-tile shrink and expand)'s least time (x's rows, A[:, :r] and B[:r, :] of
each distinct adapter, y; live ranks: `roofline.call_lora_least_s`) over
the device time of the LoRA kernels that prefill calls launched in the
traced span, in %."""
from servebench.harness import family_seconds, window_calls
from servebench.roofline import call_lora_least_s


def read(ctx):
    dev = family_seconds(ctx, "lora", "prefill")
    if dev <= 0:
        return None
    calls = window_calls(ctx, "prefill", profiled=True)
    if not calls:
        return None
    least = sum(call_lora_least_s(ctx.spec, c, ctx.peaks)
                for c in calls)
    return 100.0 * least / dev
