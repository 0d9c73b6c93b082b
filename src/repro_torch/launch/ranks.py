"""Ranks of one job on this host: ``world`` processes of one command, each
with ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set as ``torchrun`` sets them, so that
``torch.distributed.init_process_group()`` rendezvouses on localhost.  The
tests and ``chip_smoke.py`` start their multi-rank sessions with it."""
from __future__ import annotations

import os
import socket
import subprocess
import time


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv: list[str], world: int, *, timeout: float,
              env: dict | None = None, capture: bool = False
              ) -> list[tuple[int, str | None]]:
    """Run ``argv`` as ranks 0..world-1 and wait for all of them, at most
    ``timeout`` seconds in all; ranks still running then are killed (a
    negative exit code).  Returns each rank's (exit code, output): stdout
    and stderr together where ``capture``, else None (they go to this
    process's own)."""
    base = dict(os.environ if env is None else env, WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    pipe = subprocess.PIPE if capture else None
    procs = [subprocess.Popen(argv, env=dict(base, RANK=str(r),
                                             LOCAL_RANK=str(r)),
                              stdout=pipe,
                              stderr=subprocess.STDOUT if capture else None,
                              text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs: list[str | None] = [None] * world
    try:
        for r, p in enumerate(procs):
            outs[r] = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.0))[0]
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]
