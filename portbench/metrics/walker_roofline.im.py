"""walker_roofline: the least time of the traced infinite-memory chunks'
work, their bytes (:func:`portbench.roofline.im_chunk_bytes`) over the
card's bandwidth, as a share of the device time of every operation they
ran, in %."""

from portbench import roofline


def read(ctx):
    peak = roofline.hbm_bytes_per_s(ctx.device_name)
    if ctx.trace is None or peak is None or ctx.trace.device_s <= 0:
        return None
    b, n, w, p, k = ctx.sizes
    t = ctx.traced
    need = (t['chunks'] * roofline.im_chunk_bytes(b, n, w, p, k, 0) +
            roofline.im_chunk_bytes(0, n, w, 0, 0, t['improved']))
    return 100.0 * need / peak / ctx.trace.device_s
