"""Head placements that found no room a pass, in ms: the wall of the
program's ``rltune.place.head_failed`` spans (time in ``_alloc_for`` that
started nothing, outside ``placement.placed_ms_per_pass``)."""
from perfbench import span_reader


def read(ctx):
    return span_reader.self_ms_per_pass(ctx, "rltune.place.head_failed",
                                        wall=True)
