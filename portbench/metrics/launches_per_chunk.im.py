"""launches_per_chunk: device kernels in the traced chunks (profiler's
trace) over the chunks."""


def read(ctx):
    if ctx.trace is None or ctx.device_name == 'cpu':
        return None
    return ctx.trace.launches / ctx.traced['chunks']
