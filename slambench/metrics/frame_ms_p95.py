"""The 95th percentile over every frame of the window of the host clock
around ``SlamSession.step()``: from the frame's hand-over to its pose back
on the host."""

import numpy as np


def read(win, setup_s):
    if not win.latencies_s:
        return None
    return float(np.percentile(np.asarray(win.latencies_s) * 1e3, 95))
