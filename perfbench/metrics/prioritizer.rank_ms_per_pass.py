"""Ranking wall a pass, in ms: host clock around the prioritizer's
``rank_window`` (features, the actor over the window and the tail, the
sort; the logits come back to the host, so the call ends synchronised)."""


def read(ctx):
    if not ctx["passes"]:
        return None
    return ctx["rank_s"] / ctx["passes"] * 1e3
