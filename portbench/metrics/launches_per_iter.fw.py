"""launches_per_iter: device kernels in the traced chunks (profiler's
trace) over their iterations."""


def read(ctx):
    if ctx.trace is None or ctx.device_name == 'cpu':
        return None
    return ctx.trace.launches / ctx.traced['iterations']
