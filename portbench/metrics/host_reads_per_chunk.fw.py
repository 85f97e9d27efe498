"""host_reads_per_chunk: the program's ``host_reads`` counter (its blocking
device-to-host reads) over the traced chunks alone, per chunk."""


def read(ctx):
    if ctx.trace is None or ctx.counts is None:
        return None
    return ctx.counts.get('host_reads', 0) / ctx.traced['chunks']
