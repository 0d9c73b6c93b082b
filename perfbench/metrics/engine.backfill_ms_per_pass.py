"""The EASY backfill scan a pass, in ms: the self time of the program's
``rltune.backfill`` and ``rltune.backfill.reserve`` spans (the head's
earliest start, the candidate filter, the candidates' placement attempts;
the predictor, HiGHS solves and the hooks of started jobs are spans of
their own)."""
from perfbench import span_reader


def read(ctx):
    return span_reader.self_ms_per_pass(ctx, "rltune.backfill",
                                        "rltune.backfill.reserve")
