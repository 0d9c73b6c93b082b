"""The pass's own code a pass, in ms: the self time of the program's
``rltune.step`` and ``rltune.schedule`` spans (the scheduling loop, the
window's slice, the look-ahead list; what no named span inside covers)."""
from perfbench import span_reader


def read(ctx):
    return span_reader.self_ms_per_pass(ctx, "rltune.step",
                                        "rltune.schedule")
