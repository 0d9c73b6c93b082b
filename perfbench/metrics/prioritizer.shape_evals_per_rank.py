"""Distinct job shapes a feature build queried: the program's
``rank.shape_evals`` counter over ``rank.shape_path`` (the builds that
went per shape).  It follows the trace: with CPU and memory derived from
the GPU count it stays near num_gpus x gpu_type; a trace whose requests
differ per job reads up to the window's rows."""
from perfbench import span_reader


def read(ctx):
    v = span_reader.view(ctx)
    if v is None:
        return None
    builds = v[1].get("rank.shape_path", 0)
    if builds <= 0:
        return None
    return v[1].get("rank.shape_evals", 0) / builds
