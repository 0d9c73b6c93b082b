"""MILP solves asked for a pass: the change in the engine's
``milp_calls`` over the window, over the passes."""


def read(ctx):
    if not ctx["passes"]:
        return None
    return ctx["milp_calls"] / ctx["passes"]
