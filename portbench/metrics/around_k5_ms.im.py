"""around_k5_ms: the device time of the operations launched inside the
program's ``tnco.walker.pack``, ``.unpack`` and ``.finish`` spans (the
copies around the walker kernel K5 and the best trees' refresh with K1's
hyper read), from the profiler's trace of the traced chunks, in ms a
chunk."""

STAGES = ('tnco.walker.pack', 'tnco.walker.unpack', 'tnco.walker.finish')


def read(ctx):
    if ctx.spans is None or ctx.device_name == 'cpu' or \
            not all(s in ctx.spans for s in STAGES):
        return None
    return 1e3 * sum(ctx.spans[s]['device_s'] for s in STAGES) / \
        ctx.traced['chunks']
