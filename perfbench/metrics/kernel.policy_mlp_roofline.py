"""The actor kernel's share of its roofline, in %: the least time the
H100 needs for the window's launches (``perfbench.roofline``, from each
launch's rows and live rows) over the device time of the kernels named
``policy_mlp`` in the profiler's trace."""
from perfbench import roofline, trace_reader


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["policy"]:
        return None
    sec, _ = trace_reader.kernel_time(tr["by_name"], "policy_mlp")
    if sec <= 0:
        return None
    bound = sum(roofline.policy_mlp_s(q, n) for q, n in ctx["policy"])
    return 100.0 * bound / sec
