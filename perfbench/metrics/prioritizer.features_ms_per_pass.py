"""Feature building a pass, in ms: the self time of the program's
``rltune.rank.features`` spans (feature rows over the window, sampling,
padding, critic rows) over the traced window's passes."""
from perfbench import span_reader


def read(ctx):
    return span_reader.self_ms_per_pass(ctx, "rltune.rank.features")
