"""setup_s: seconds from the process's start to the end of the warm-up
chunk (imports, the network, the starting paths, the runner and its
widening, the kernels' build or load, one chunk)."""


def read(ctx):
    return ctx.setup_s
