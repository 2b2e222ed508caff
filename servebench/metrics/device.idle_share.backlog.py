"""Share of the traced span's wall time in which no kernel, copy or fill
ran on the device (torch.profiler, CUPTI), in %."""


def read(ctx):
    p = ctx.profile
    if p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (p.window_s - p.busy_s) / p.window_s
