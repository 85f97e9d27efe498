"""chunk_ms_p95: the 95th percentile of the window's chunk times (host
clock around each ``run`` call, ending in a synchronize), in ms."""

import numpy as np


def read(ctx):
    if len(ctx.chunk_s) < 200:      # ten chunks beyond the percentile
        return None
    return 1e3 * float(np.percentile(ctx.chunk_s, 95))
