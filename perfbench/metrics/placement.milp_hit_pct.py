"""MILP requests answered from the solution cache, in %: 100 times the
program's ``milp.hits`` over ``milp.hits`` + ``milp.solves`` +
``milp.greedy`` (requests with more than one way)."""
from perfbench import span_reader


def read(ctx):
    return span_reader.counter_pct(ctx, "milp.hits", "milp.hits",
                                   "milp.solves", "milp.greedy")
