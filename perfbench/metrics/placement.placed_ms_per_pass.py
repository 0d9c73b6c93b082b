"""Successful placement attempts' wall a pass, in ms (host clock around
``SchedulerEngine._alloc_for``, head and backfill placements: candidate
ways and the MILP); failed attempts are in the engine's own time."""


def read(ctx):
    if not ctx["passes"]:
        return None
    return ctx["alloc_s"] / ctx["passes"] * 1e3
