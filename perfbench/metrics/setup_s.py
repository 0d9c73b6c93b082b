"""Seconds from the process's start to the window (host clock): CUDA
start-up, the kernel libraries, the traces, the replays to each snapshot
and their saves, the warm-up unit."""


def read(ctx):
    return ctx["setup_s"]
