"""Jobs the engine started in the window, backfills included, over the
window's whole wall (host clock; restores, collections and each unit's
closing synchronize included)."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return ctx["starts"] / ctx["window_s"]
