"""95th percentile of the pass walls of the traced window, in ms (host
clock around each ``engine.step``; numpy's linear interpolation)."""
import numpy as np


def read(ctx):
    if not ctx["pass_s"]:
        return None
    return float(np.percentile(ctx["pass_s"], 95)) * 1e3
