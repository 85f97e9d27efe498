"""host_reads_per_chunk: the program's ``host_reads`` counter (its blocking
device-to-host reads) over every chunk of the run: the warm-up chunk, the
window's and the traced ones, which are alike."""

from portbench import spans


def read(ctx):
    counts = spans.program_counts()
    if ctx.trace is None or counts is None:
        return None
    chunks = 1 + len(ctx.chunk_s) + ctx.traced['chunks']
    return counts.get('host_reads', 0) / chunks
