"""Units restored from one snapshot repeat the same work."""
from __future__ import annotations

import contextlib

import torch

from perfbench import check, harness, run
from perfbench import traffic as traffic_gen


def test_two_units_do_equal_work(checkout):
    torch.set_num_threads(1)
    _, _, cfg, traffic = run.load_cell(checkout, "small-pred")
    dev = torch.device("cpu")
    arrays = traffic_gen.generate(cfg["profile"], traffic["num_jobs"], 5)
    taps = harness.Taps()
    taps.install()
    prog = harness.Program(cfg, traffic, arrays, harness.make_weights(cfg, dev),
                           dev, taps)
    prog.replay()
    blob = prog.snapshot()
    null = lambda name: contextlib.nullcontext()  # noqa: E731
    a, ca, *_ = harness.run_unit([blob], 60, taps, lambda: None, [], null)
    b, cb, *_ = harness.run_unit([blob], 60, taps, lambda: None, [], null)
    ca.pop("wall_ms")
    cb.pop("wall_ms")
    assert ca == cb and ca["passes"] == 60 and ca["decisions"] > 0
    assert check.Digest(a).same(check.Digest(b))
