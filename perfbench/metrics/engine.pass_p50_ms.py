"""Median wall of a pass (one engine event batch), in ms: host clock
around each ``engine.step`` of the traced window."""
import numpy as np


def read(ctx):
    if not ctx["pass_s"]:
        return None
    return float(np.median(ctx["pass_s"])) * 1e3
