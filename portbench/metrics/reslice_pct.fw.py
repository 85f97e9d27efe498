"""reslice_pct: the host seconds of the program's ``tnco.walks.reslice``
spans (a reslice step's ``slices.any()`` read and the slicer, with its
entry read) in the traced chunk, as a share of the traced window, in %."""

from portbench import spans


def read(ctx):
    return spans.window_pct(ctx, 'tnco.walks.reslice')
