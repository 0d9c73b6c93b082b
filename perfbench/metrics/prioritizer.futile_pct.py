"""Futile decisions, in %: 100 times the program's ``rank.futile``
counter (the ranked head did not place and the backfill scan started
nothing) over ``rank.decisions``."""
from perfbench import span_reader


def read(ctx):
    return span_reader.counter_pct(ctx, "rank.futile", "rank.decisions")
