"""The 95th percentile, in ms, of every ``track_monocular`` call in the
window, each timed on the host clock around the call (linear interpolation
between order statistics, over all calls at once)."""

import numpy as np


def read(run):
    calls = run["calls_s"]
    return float(np.percentile(np.asarray(calls) * 1e3, 95)) if calls else None
