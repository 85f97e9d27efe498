"""proposals_per_s: every walk proposal of the window's chunks (walks x
replicas x iterations) over all the window's time (host clock, each
chunk ending in a synchronize)."""


def read(ctx):
    return ctx.proposals / ctx.window_s
