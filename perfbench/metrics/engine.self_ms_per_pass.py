"""The engine's own time a pass, in ms: the passes' walls less the
ranking, the successful placement attempts and the predictor calls (event
handling, the backfill scan and failed placement attempts remain)."""


def read(ctx):
    if not ctx["passes"]:
        return None
    rest = sum(ctx["pass_s"]) - ctx["rank_s"] - ctx["alloc_s"] - ctx["pred_s"]
    return rest / ctx["passes"] * 1e3
