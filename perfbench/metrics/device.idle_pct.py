"""The device's idle share of the traced window, in %: 100 times one
less the union of kernel, copy and set intervals in the profiler's trace
over the window's wall."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / ctx["window_s"])
