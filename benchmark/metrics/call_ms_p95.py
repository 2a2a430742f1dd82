"""call_ms_p95: the 95th percentile of the latencies of all calls in the
window, each from issue to synchronise on the host clock, in ms (linear
interpolation between order statistics)."""

import numpy as np


def read(ctx):
    w = ctx.window
    if w is None or not w.latencies_s:
        return None
    return 1e3 * float(np.percentile(w.latencies_s, 95))
