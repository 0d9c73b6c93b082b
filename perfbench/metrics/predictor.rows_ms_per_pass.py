"""Predictor feature rows a pass, in ms: the self time of the program's
``rltune.predict.rows`` (rows and anchors for a forward) and
``rltune.predict.submit`` (a submitted job's row) spans."""
from perfbench import span_reader


def read(ctx):
    if not ctx.get("has_predictor"):
        return None
    return span_reader.self_ms_per_pass(ctx, "rltune.predict.rows",
                                        "rltune.predict.submit")
