"""claim_pct: the host seconds of the program's ``tnco.walks.claim`` spans
(the walks' acceptance and their sequential claim, a Python loop over the
walks) in the traced chunk, as a share of the traced window, in %."""

from portbench import spans


def read(ctx):
    return spans.window_pct(ctx, 'tnco.walks.claim')
