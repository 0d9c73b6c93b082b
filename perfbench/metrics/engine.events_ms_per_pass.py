"""Event handling a pass, in ms: the self time of the program's
``rltune.events`` spans (heap pops, faults, arrivals, finishes; the
finish hooks are their own spans) over the traced window's passes."""
from perfbench import span_reader


def read(ctx):
    return span_reader.self_ms_per_pass(ctx, "rltune.events")
