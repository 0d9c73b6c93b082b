"""How ``correct`` is decided: the program's records held against the plain
reference (``perfbench/reference``), each number beside its limit.

For every trace of the cell, once the window has closed, the reference
starts from nothing but the benchmark's jobs, cluster and weights (the
state of a scheduler just handed the trace), follows every pass of the
set-up to the snapshot, holds the program's saved state there against
its own (queue, running set, work left, event heap, reservations, free
capacity and the predictor's cohorts exactly; the predictor's parameters
by ``param_gap``), and goes on from its own state through that trace's
passes in the window's first unit.  Every later unit, and the warm-up,
has to repeat the first: the same digest of its clock, starts, orders and
predictor answers, and the same actor logits bit for bit (``Digest``,
taken as the window runs, so that a unit's records go once it is done).

The numbers: ``logit_gap`` (the widest gap between an actor logit of the
program and the reference's, over the largest reference logit of that
launch), ``quantile_gap`` (the widest relative gap of a predictor
quantile), ``param_gap`` (the widest gap of a predictor parameter at a
snapshot, over the largest magnitude of its leaf or of the median leaf),
``order_faults`` (rankings that are not the program's logits sorted, or
launches that do not match the window), ``schedule_faults`` (passes whose
clock, starts, nodes or number of decisions differ, and states that
differ) and ``unit_faults`` (units that differ from the first).  Limits
are in ``LIMITS``; ``PERF.md`` gives the readings they were set from.
"""
from __future__ import annotations

import numpy as np

from perfbench.reference import sched as ref

#: each compared number and its limit (a reading above the limit fails)
LIMITS = {
    "logit_gap": 1e-4,
    "quantile_gap": 1e-4,
    "param_gap": 1e-4,
    "order_faults": 0,
    "schedule_faults": 0,
    "unit_faults": 0,
}


def to_host(recs: list) -> list:
    """Replace device tensors in pass records by float32 numpy arrays."""
    out = []
    for r in recs:
        decs = [(n, [int(k) for k in order],
                 [o.detach().cpu().numpy().astype(np.float32) for o in outs])
                for n, order, outs in r["decisions"]]
        out.append({"t": r["t"], "starts": list(r["starts"]),
                    "decisions": decs, "predictor": list(r["predictor"])})
    return out


class Digest:
    """What a unit did, in a form that outlives its records: one hash a
    pass of its clock, starts, window lengths, orders and predictor
    answers (Python's own hash, compared within one process), and the
    unit's actor logits in one tensor on their device."""

    def __init__(self, unit: list):
        import torch
        keys, outs = [], []
        for seg in unit:
            keys.append(len(seg))
            for r in seg:
                decs = r["decisions"]
                keys.append(hash((
                    r["t"], tuple(r["starts"]),
                    tuple((n, tuple(order), len(o)) for n, order, o in decs),
                    tuple((kind, np.ascontiguousarray(v).tobytes())
                          for kind, v in r["predictor"]))))
                for _, _, o in decs:
                    outs.extend(o)
        keys.append(tuple(tuple(o.shape) for o in outs))
        self.keys = keys
        self.logits = torch.cat([o.reshape(-1) for o in outs]) \
            if outs else None

    def same(self, other: "Digest") -> bool:
        """Equal work and equal logits, bit for bit."""
        import torch
        if self.keys != other.keys:
            return False
        if self.logits is None or other.logits is None:
            return self.logits is None and other.logits is None
        return bool(torch.equal(self.logits, other.logits))


def reference_inputs(cfg: dict, nodes: list, arrays: dict, weights: dict):
    """The reference's view of one trace: its jobs, the actor's weights in
    float64, and the predictor from its initial weights, with each job's
    row at submission (``None`` without a predictor)."""
    jobs = ref.Jobs(arrays)
    actor = [(np.asarray(w["w"].detach().cpu().numpy(), np.float64),
              np.asarray(w["b"].detach().cpu().numpy(), np.float64))
             for w in weights["actor"]]
    pred = None
    pcfg = cfg.get("predictor")
    if pcfg:
        rows = ref.submission_rows(jobs, nodes, float(jobs.submit[0]))
        pred = ref.Predictor(weights["predictor"], pcfg["quantiles"],
                             pcfg["lr"], {}, {}, rows)
    return jobs, actor, pred


def follow(cfg: dict, nodes: list, weights: dict, trace: dict,
           unit_recs: list, gaps: ref.Gaps, name: str) -> None:
    """The reference over one trace: from the start through every set-up
    pass, the program's state at the start and at the snapshot held
    against its own, then through ``unit_recs`` from its own state.
    ``trace`` holds ``arrays``, ``t0`` (the program's state before its
    first pass), ``setup`` (its pass records to the snapshot) and
    ``snap`` (its state there)."""
    jobs, actor, pred = reference_inputs(cfg, nodes, trace["arrays"], weights)
    f = ref.Follower(cfg, nodes, jobs, actor, pred,
                     ref.initial_state(jobs, nodes), gaps)
    ref.compare_state(f.state(), trace["t0"], gaps, f"{name}: the start")
    for rec in trace["setup"]:
        f.step(rec)
    ref.compare_state(f.state(), trace["snap"], gaps, f"{name}: the snapshot")
    for rec in unit_recs:
        f.step(rec)


def compare(cfg: dict, nodes: list, weights: dict, traces: list,
            order: list, unit: list) -> tuple[dict, list]:
    """The reference over every trace.  ``traces`` as ``follow`` takes
    them, in the cell's order; ``unit`` holds the first unit's records,
    one list a trace in the order the unit visited them (``order``).
    Returns ({name: {"value", "limit"}} without ``unit_faults``, notes)."""
    gaps = ref.Gaps()
    for k, i in enumerate(order):
        recs = unit[k] if k < len(unit) else []
        follow(cfg, nodes, weights, traces[i], recs, gaps, f"trace {i}")
    if len(unit) != len(order):
        gaps.fault("schedule_faults", "the first unit did not visit every "
                   "trace")
    values = {"logit_gap": gaps.logit_gap, "quantile_gap": gaps.quantile_gap,
              "param_gap": gaps.param_gap,
              "order_faults": gaps.order_faults,
              "schedule_faults": gaps.schedule_faults}
    if not cfg.get("predictor"):
        del values["quantile_gap"], values["param_gap"]
    if gaps.logits == 0:
        gaps.notes.append("no actor logit was compared")
        values["order_faults"] += 1
    return ({k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()},
            gaps.notes)


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
