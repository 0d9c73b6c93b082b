"""Backfill placement attempts that found no room, in %: 100 times the
program's ``backfill.failed`` over ``backfill.tried``."""
from perfbench import span_reader


def read(ctx):
    return span_reader.counter_pct(ctx, "backfill.failed", "backfill.tried")
