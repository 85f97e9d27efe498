"""best_log2_cost: the reference's exact log2 contraction cost (sliced,
under a cap) of the best replica's best tree at the window's end."""

import math


def read(ctx):
    return ctx.best_log2 if math.isfinite(ctx.best_log2) else None
