"""Backfill candidates that reached a placement attempt a pass: the
program's ``backfill.tried`` counter (after the time gate, the
negative-shape cache and the free-tally prefilter) over the traced
window's passes."""
from perfbench import span_reader


def read(ctx):
    return span_reader.counter_per_pass(ctx, "backfill.tried")
