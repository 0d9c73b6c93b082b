"""The predictor's online SGD steps a pass, in ms: the self time of the
program's ``rltune.predict.sgd`` spans (``on_finish``)."""
from perfbench import span_reader


def read(ctx):
    if not ctx.get("has_predictor"):
        return None
    return span_reader.self_ms_per_pass(ctx, "rltune.predict.sgd")
