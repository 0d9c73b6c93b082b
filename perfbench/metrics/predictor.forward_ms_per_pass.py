"""The predictor's forward a pass, in ms: the self time of the
program's ``rltune.predict.forward`` spans (weight uploads after each SGD
step, the rows' upload, the launch, the copy back, the quantiles)."""
from perfbench import span_reader


def read(ctx):
    if not ctx.get("has_predictor"):
        return None
    return span_reader.self_ms_per_pass(ctx, "rltune.predict.forward")
