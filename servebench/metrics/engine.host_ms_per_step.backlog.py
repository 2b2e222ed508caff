"""Host milliseconds a step: the wall time of each `step()` in the window
(outside the traced span) less the host time inside the backend calls it
made, summed and divided by the steps (host clock)."""
from servebench.harness import window_calls


def read(ctx):
    calls = window_calls(ctx)
    steps = [(s, e) for s, e in ctx.recorder.steps
             if ctx.t0 <= s and e <= ctx.t1
             and not any(c.in_profile and s <= c.host_start <= e
                         for c in ctx.recorder.calls)]
    if not steps:
        return None
    inside = sum(c.host_end - c.host_start for c in calls
                 if any(s <= c.host_start and c.host_end <= e
                        for s, e in steps))
    return 1e3 * (sum(e - s for s, e in steps) - inside) / len(steps)
