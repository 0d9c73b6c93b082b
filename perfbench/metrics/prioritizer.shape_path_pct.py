"""Rankings whose features were built per job shape, in %: 100 times the
program's ``rank.shape_path`` counter (feature builds that queried the
cluster once per distinct shape, from the window's shape ids) over
``rank.decisions``.  None where the program does not count the builds."""
from perfbench import span_reader


def read(ctx):
    v = span_reader.view(ctx)
    if v is None or "rank.shape_path" not in v[1]:
        return None
    return span_reader.counter_pct(ctx, "rank.shape_path", "rank.decisions")
