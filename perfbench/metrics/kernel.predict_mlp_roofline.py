"""The predictor kernel's share of its roofline, in %: the least time
for the window's launches (``perfbench.roofline``, from each launch's
rows) over the device time of the kernels named ``predict_mlp``."""
from perfbench import roofline, trace_reader


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["predict"]:
        return None
    sec, _ = trace_reader.kernel_time(tr["by_name"], "predict_mlp")
    if sec <= 0:
        return None
    bound = sum(roofline.predict_mlp_s(b) for b in ctx["predict"])
    return 100.0 * bound / sec
