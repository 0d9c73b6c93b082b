"""Hook fan-out a pass, in ms: the self time of the program's
``rltune.hooks`` spans (``on_tick``, ``on_start``, ``on_finish``,
``on_decision``; the predictor's nested spans excluded)."""
from perfbench import span_reader


def read(ctx):
    return span_reader.self_ms_per_pass(ctx, "rltune.hooks")
