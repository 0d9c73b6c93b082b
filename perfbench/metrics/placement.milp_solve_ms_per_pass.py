"""HiGHS solves a pass, in ms: the wall of the program's
``rltune.milp.solve`` spans (solution-cache misses only)."""
from perfbench import span_reader


def read(ctx):
    return span_reader.self_ms_per_pass(ctx, "rltune.milp.solve", wall=True)
