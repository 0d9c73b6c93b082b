"""The reference against the port at a small size on the CPU, the TF32
control, and the faults that ``correct`` has to catch."""
from __future__ import annotations

import pytest
import torch

from perfbench import control, run

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("cell", ["small", "small-pred"])
def test_reference_agrees_with_the_port(checkout, cell):
    result, notes = run.measure(checkout, cell, 2147483659, 0.05, False, CPU)
    assert result["correct"], (result["compared"], notes)
    assert result["failed"] == 0 and result["attempted"] > 0
    compared = result["compared"]
    assert ("quantile_gap" in compared) == (cell == "small-pred")


def test_tf32_control_fails(checkout, monkeypatch):
    from repro_torch.kernels import ops
    from repro_torch.predict.predictor import QuantileMLP
    monkeypatch.setattr(ops, "policy_mlp", ops.policy_mlp)
    monkeypatch.setattr(ops, "predict_mlp", ops.predict_mlp)
    monkeypatch.setattr(QuantileMLP, "sgd_step", QuantileMLP.sgd_step)
    _fresh_taps(monkeypatch)
    control.install_tf32()
    result, _ = run.measure(checkout, "small-pred", 7, 0.05, False, CPU)
    assert not result["correct"]
    c = result["compared"]
    assert c["logit_gap"]["value"] > c["logit_gap"]["limit"]
    assert c["quantile_gap"]["value"] > c["quantile_gap"]["limit"]


def _fresh_taps(monkeypatch):
    """Put the program's entry points back as they were before any taps
    wrapped them, so that a fault or the control patched in next lies
    under the taps of the next run; everything is put back afterwards."""
    from repro_torch.core.env import RLPrioritizer
    from repro_torch.predict.predictor import RuntimePredictor

    from perfbench import harness
    for cls, name in ((RLPrioritizer, "rank_window"),
                      (RuntimePredictor, "reserve_batch"),
                      (RuntimePredictor, "lookahead_durations"),
                      (RuntimePredictor, "on_finish"),
                      (RuntimePredictor, "on_submit")):
        original = harness._ORIGINAL.get(name, getattr(cls, name))
        monkeypatch.setattr(cls, name, original)
    from repro_torch.kernels import ops
    for name in ("policy_mlp", "predict_mlp"):
        monkeypatch.setattr(ops, name, harness._ORIGINAL.get(
            name, getattr(ops, name)))
    monkeypatch.setattr(harness, "_ORIGINAL", {})


def _pass_does_nothing(monkeypatch):
    from repro_torch.sched import engine
    monkeypatch.setattr(engine.SchedulerEngine, "_schedule_pass",
                        lambda self: None)


def _half_the_window(monkeypatch):
    from repro_torch.core.env import RLPrioritizer
    rank = RLPrioritizer._rank

    def half(self, jobs, cluster, now, fields):
        h = max(1, len(jobs) // 2)
        order = rank(self, jobs[:h], cluster, now, None)
        return order + list(range(h, len(jobs)))
    monkeypatch.setattr(RLPrioritizer, "_rank", half)


def _placement_altered(monkeypatch):
    from repro_torch.sched import engine
    choose = engine.choose_allocation

    def other(cluster, job, ways, *a, **k):
        res = choose(cluster, job, ways, *a, **k)
        if len(ways) > 1:
            res.placement = ways[1 - min(res.way_index, 1)]
        return res
    monkeypatch.setattr(engine, "choose_allocation", other)


def _logit_altered(monkeypatch):
    from repro_torch.kernels import ops
    policy = ops.policy_mlp

    def nudged(x, params, mask):
        out = policy(x, params, mask).clone()
        out[0] += 1e-3 * out.abs().max()
        return out
    monkeypatch.setattr(ops, "policy_mlp", nudged)


def _predictor_learns_nothing(monkeypatch):
    from repro_torch.predict.predictor import QuantileMLP
    monkeypatch.setattr(QuantileMLP, "sgd_step", lambda self, x, y: 0.0)


@pytest.mark.parametrize("fault", [_pass_does_nothing, _half_the_window,
                                   _placement_altered, _logit_altered,
                                   _predictor_learns_nothing])
def test_a_broken_timed_path_is_not_correct(checkout, monkeypatch, fault):
    """Each fault the cells can have: a pass that leaves the state as it
    was, half of the window ranked and the rest left in order, a
    placement and a logit altered where they are produced, a predictor
    whose learning step leaves its weights as they were.  (No cell
    spans chips, so there is no exchange between chips to leave out.)"""
    _fresh_taps(monkeypatch)
    fault(monkeypatch)
    result, _ = run.measure(checkout, "small-pred", 13, 0.05, False, CPU)
    assert not result["correct"], result["compared"]


@pytest.mark.chip
@pytest.mark.parametrize("mode", ["program", "tf32"])
def test_control_on_the_card(checkout, card, monkeypatch, mode):
    """On the card: the program passes, the TF32 control does not."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "policy_mlp", ops.policy_mlp)
    monkeypatch.setattr(ops, "predict_mlp", ops.predict_mlp)
    _fresh_taps(monkeypatch)
    if mode == "tf32":
        control.install_tf32()
    result, _ = run.measure(checkout, "small-pred", 17, 0.05, False, card)
    assert result["correct"] == (mode == "program"), result["compared"]
