"""The actor and the tail scorer a pass, in ms: the self time of the
program's ``rltune.rank.actor`` and ``rltune.rank.tail`` spans (uploads,
the launches, the copies back) over the traced window's passes."""
from perfbench import span_reader


def read(ctx):
    return span_reader.self_ms_per_pass(ctx, "rltune.rank.actor",
                                        "rltune.rank.tail")
