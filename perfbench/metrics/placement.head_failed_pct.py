"""Head placements that found no room, in %: 100 times the program's
``rltune.place.head_failed`` spans over those and ``rltune.place.head``
(the placements that succeeded)."""
from perfbench import span_reader


def read(ctx):
    return span_reader.calls_pct(ctx, "rltune.place.head_failed",
                                 "rltune.place.head",
                                 "rltune.place.head_failed")
