"""Predictor wall a pass, in ms: host clock around the predictor methods
the engine calls (``reserve_batch``, ``lookahead_durations``,
``on_submit``, ``on_finish``): feature rows, the forward with its upload
and copy back, and the online SGD step."""


def read(ctx):
    if not ctx["passes"] or not ctx["has_predictor"]:
        return None
    return ctx["pred_s"] / ctx["passes"] * 1e3
