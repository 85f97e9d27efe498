"""device_idle_pct: the share of the traced chunks' window in which no
operation ran on the card (100 minus the union of the device intervals,
from the profiler's trace)."""


def read(ctx):
    if ctx.trace is None or ctx.device_name == 'cpu':
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
