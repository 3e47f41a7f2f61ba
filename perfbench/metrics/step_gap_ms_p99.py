"""step_gap_ms_p99 (trainer loop): the 99th percentile of the intervals
between consecutive step starts over the whole window (``samples``
beside it)."""

import numpy as np


def read(ctx):
    gaps = np.diff(np.asarray(ctx.window["starts"]))
    if len(gaps) < 100:
        return None
    return float(np.percentile(gaps, 99)) * 1e3, {"samples": int(len(gaps))}
