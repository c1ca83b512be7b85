"""The 95th percentile of the window's call times, from handing the host
arrays to the scorer until its result is on the host (closed loop, one
caller)."""

import numpy as np


def read(ctx):
    if not ctx.driver.latency:
        return None
    return float(np.percentile(np.asarray(ctx.latencies) * 1e3, 95))
