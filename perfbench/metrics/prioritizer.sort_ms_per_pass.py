"""The ranking's own time a pass, in ms: the self time of the program's
``rltune.rank`` spans (the sort of the window by its logits and the order
built from it; features, the actor and the tail scorer are spans of
their own)."""
from perfbench import span_reader


def read(ctx):
    return span_reader.self_ms_per_pass(ctx, "rltune.rank")
