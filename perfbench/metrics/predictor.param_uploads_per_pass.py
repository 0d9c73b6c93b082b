"""The predictor's weight uploads to the device a pass: the program's
``predict.param_uploads`` counter (one upload of every weight tensor after
each SGD step, at the next forward) over the traced window's passes."""
from perfbench import span_reader


def read(ctx):
    if not ctx.get("has_predictor"):
        return None
    return span_reader.counter_per_pass(ctx, "predict.param_uploads")
