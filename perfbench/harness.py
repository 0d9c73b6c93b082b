"""The system under test, driven as a cell says, and what it records.

``Program`` builds one ``SchedulerEngine`` of ``repro_torch`` the way the
program's ``sched.run_stream`` builds it (the greedy PPO actor with the
bucketed tail scorer, MILP placement, EASY backfill, look-ahead 8, and the
online runtime predictor where the configuration has one), from weights
and jobs that the benchmark made, submits the whole trace, and replays it
to the cell's snapshot.  A unit restores that snapshot with the engine's
own ``save_state`` / ``load_state`` and runs the next passes.

``Taps`` wraps, from outside, the calls the benchmark reads: the
prioritizer's ``rank_window`` (its order, and its wall in a traced run),
the two MLP kernels' wrappers in ``kernels.ops`` (their outputs and
shapes), the predictor's methods that the engine calls (their answers,
and their walls in a traced run), the engine's placement attempts
(``SchedulerEngine._alloc_for``: the walls of the successful ones in a
traced run) and an engine hook for the jobs each pass starts.  Nothing
is attached that changes the engine's own path: a traced run steps the
same code as an untraced one.
"""
from __future__ import annotations

import math
import time

import numpy as np

MAX_QUEUE = 256
#: the program's entry points as they were before any ``Taps`` wrapped
#: them, so that several runs in one process wrap them once each
_ORIGINAL: dict = {}


class Taps:
    """Records each pass: the clock after it, the jobs it started, each
    ranking (window length, order, actor kernel outputs in call order) and
    each predictor answer the engine asked for."""

    def __init__(self):
        self.cur = None
        self.timing = False
        #: context manager factory naming host ranges in a traced run
        self.annotate = None
        self.rank_s = 0.0
        self.pred_s = 0.0
        self.alloc_s = 0.0
        self.policy = []          # (Q, live rows) per policy_mlp launch
        self.predict = []         # B per predict_mlp launch
        self._calls = None
        self._starts = None

    def begin(self) -> None:
        self.cur = {"starts": [], "decisions": [], "predictor": []}

    def end(self, now: float) -> dict:
        rec, self.cur = self.cur, None
        rec["t"] = now
        return rec

    def install(self) -> None:
        """Wrap the program's entry points for this process."""
        from repro_torch.core.env import RLPrioritizer
        from repro_torch.kernels import ops
        from repro_torch.predict.predictor import RuntimePredictor
        from repro_torch.sched import EngineHooks, SchedulerEngine

        taps = self
        if not _ORIGINAL:
            _ORIGINAL.update({
                "alloc_for": SchedulerEngine._alloc_for,
                "rank_window": RLPrioritizer.rank_window,
                "policy_mlp": ops.policy_mlp, "predict_mlp": ops.predict_mlp,
                "reserve_batch": RuntimePredictor.reserve_batch,
                "lookahead_durations": RuntimePredictor.lookahead_durations,
                "on_finish": RuntimePredictor.on_finish,
                "on_submit": RuntimePredictor.on_submit})
        rank0 = _ORIGINAL["rank_window"]

        def rank_window(self, jobs, cluster, now, fields):
            taps._calls = []
            if taps.timing:
                t0 = time.perf_counter()
                with taps.annotate("perfbench.rank"):
                    order = rank0(self, jobs, cluster, now, fields)
                taps.rank_s += time.perf_counter() - t0
            else:
                order = rank0(self, jobs, cluster, now, fields)
            n = len(jobs)
            outs, taps._calls = taps._calls, None
            if taps.cur is not None:
                taps.cur["decisions"].append((n, order, outs))
            head = min(n, MAX_QUEUE)
            taps.policy.append((outs[-1].shape[0], head))
            if len(outs) > 1:
                taps.policy.append((outs[0].shape[0], n - head))
            return order

        RLPrioritizer.rank_window = rank_window

        policy0 = _ORIGINAL["policy_mlp"]

        def policy_mlp(x, params, mask):
            out = policy0(x, params, mask)
            if taps._calls is not None:
                taps._calls.append(out)
            return out

        ops.policy_mlp = policy_mlp

        predict0 = _ORIGINAL["predict_mlp"]

        def predict_mlp(x, params):
            out = predict0(x, params)
            taps.predict.append(int(x.shape[0]))
            return out

        ops.predict_mlp = predict_mlp

        def answer(kind, fn):
            def wrapped(self, jobs, engine=None):
                if taps.timing:
                    t0 = time.perf_counter()
                    with taps.annotate("perfbench.predictor"):
                        out = fn(self, jobs, engine)
                    taps.pred_s += time.perf_counter() - t0
                else:
                    out = fn(self, jobs, engine)
                if taps.cur is not None:
                    taps.cur["predictor"].append(
                        (kind, np.asarray(out, dtype=np.float64)))
                return out
            return wrapped

        RuntimePredictor.reserve_batch = answer(
            "p90", _ORIGINAL["reserve_batch"])
        RuntimePredictor.lookahead_durations = answer(
            "p50", _ORIGINAL["lookahead_durations"])

        def timed(fn):
            def wrapped(self, job, now):
                if not taps.timing:
                    return fn(self, job, now)
                t0 = time.perf_counter()
                try:
                    with taps.annotate("perfbench.predictor"):
                        return fn(self, job, now)
                finally:
                    taps.pred_s += time.perf_counter() - t0
            return wrapped

        RuntimePredictor.on_finish = timed(_ORIGINAL["on_finish"])
        RuntimePredictor.on_submit = timed(_ORIGINAL["on_submit"])

        alloc0 = _ORIGINAL["alloc_for"]

        def alloc_for(self, job, queue_rest, durations=None):
            if not taps.timing:
                return alloc0(self, job, queue_rest, durations)
            t0 = time.perf_counter()
            placement = alloc0(self, job, queue_rest, durations)
            if placement is not None:
                taps.alloc_s += time.perf_counter() - t0
            return placement

        SchedulerEngine._alloc_for = alloc_for

        class Starts(EngineHooks):
            def on_start(self, job, now):
                if taps.cur is not None:
                    taps.cur["starts"].append(
                        (job.job_id, tuple(sorted(job.placement.items())),
                         now))

        self._starts = Starts()

    def hooks(self) -> list:
        """Engine hooks: the jobs each pass starts."""
        return [self._starts]


def make_jobs(arrays: dict) -> list:
    from repro_torch.core.types import Job
    return [Job(job_id=i, user=int(arrays["user"][i]),
                submit_time=float(arrays["submit_time"][i]),
                runtime=float(arrays["runtime"][i]),
                est_runtime=float(arrays["est_runtime"][i]),
                num_gpus=int(arrays["num_gpus"][i]),
                gpu_type=str(arrays["gpu_type"][i]),
                vc=int(arrays["vc"][i]))
            for i in range(len(arrays["submit_time"]))]


def node_list(cfg: dict) -> list[dict]:
    """The configuration's nodes, one dict per node, in node-id order."""
    out = []
    for grp in cfg["cluster"]["nodes"]:
        for _ in range(int(grp["count"])):
            out.append({k: grp[k] for k in ("gpu_type", "gpus", "cpus",
                                            "mem_gb", "speed")})
    return out


def make_weights(cfg: dict, device) -> dict:
    """The configuration's agent: the actor's and the predictor's initial
    weights from its ``agent_seed``, in one draw on ``device``: He-normal
    actor layers with the last scaled by 0.01 and zero biases; predictor
    w1, w2 normal over sqrt(fan-in), heads and biases zero (the program's
    own initialisation rules)."""
    import torch
    h1, h2 = cfg["scheduler"]["actor_hidden"]
    shapes = [(8, h1), (h1, h2), (h2, 1)]
    pred = cfg.get("predictor")
    pshapes = []
    if pred:
        p1, p2 = pred["hidden"]
        pshapes = [(21, p1), (p1, p2)]
    sizes = [a * b for a, b in shapes + pshapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["agent_seed"]))
    draw = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    parts = torch.split(draw, sizes)
    actor = []
    for k, ((fi, fo), p) in enumerate(zip(shapes, parts)):
        scale = (0.01 if k == len(shapes) - 1 else 1.0) * (2.0 / fi) ** 0.5
        actor.append({"w": (p.reshape(fi, fo) * scale).contiguous(),
                      "b": torch.zeros(fo, device=device)})
    out = {"actor": actor}
    if pred:
        (fa, fb), (fc, fd) = pshapes
        q = len(pred["quantiles"])
        w1 = (parts[3].reshape(fa, fb) / math.sqrt(fa)).cpu().numpy()
        w2 = (parts[4].reshape(fc, fd) / math.sqrt(fc)).cpu().numpy()
        out["predictor"] = {
            "w1": w1.astype(np.float32), "b1": np.zeros(fb, np.float32),
            "w2": w2.astype(np.float32), "b2": np.zeros(fd, np.float32),
            "w3": np.zeros((fd, q), np.float32), "b3": np.zeros(q, np.float32)}
    return out


class Program:
    """One engine of the program under test, at the cell's snapshot."""

    def __init__(self, cfg: dict, traffic: dict, arrays: dict, weights: dict,
                 device, taps: Taps):
        import torch
        from repro_torch.core.agent import PPOAgent, PPOConfig
        from repro_torch.core.env import RLPrioritizer
        from repro_torch.core.types import ClusterSpec, NodeSpec
        from repro_torch.kernels.batch_score import BucketedScorer
        from repro_torch.predict import OverrunPolicy, RuntimePredictor
        from repro_torch.sched import MultiHooks, SchedulerEngine

        sched = cfg["scheduler"]
        seed = int(cfg["agent_seed"])
        self.traffic, self.taps = traffic, taps
        nodes = [NodeSpec(i, n["gpu_type"], int(n["gpus"]), int(n["cpus"]),
                          float(n["mem_gb"]), float(n["speed"]))
                 for i, n in enumerate(node_list(cfg))]
        spec = ClusterSpec(nodes=nodes, name=cfg["name"])
        agent = PPOAgent(PPOConfig(actor_hidden=tuple(sched["actor_hidden"]),
                                   seed=seed),
                         device=device)
        with torch.no_grad():
            for lyr, w in zip(agent.net.actor.layers, weights["actor"]):
                lyr.w.copy_(w["w"])
                lyr.b.copy_(w["b"])
        scorer = BucketedScorer(agent.params["actor"]) \
            if sched["deep_scorer"] else None
        prioritizer = RLPrioritizer(agent, explore=bool(sched["explore"]),
                                    deep_scorer=scorer)
        pred = None
        pcfg = cfg.get("predictor")
        if pcfg:
            over = pcfg["overrun"]
            pred = RuntimePredictor(
                assist=bool(pcfg["assist"]),
                quantiles=tuple(pcfg["quantiles"]),
                hidden=tuple(pcfg["hidden"]), lr=float(pcfg["lr"]),
                seed=seed, device=device,
                overrun=OverrunPolicy(grace_s=float(over["grace_s"]),
                                      ckpt_interval=float(over["ckpt_interval"]),
                                      penalty_s=float(over["penalty_s"])))
            pred.mlp.params = {k: v.copy()
                               for k, v in weights["predictor"].items()}
        self.engine = SchedulerEngine(
            spec, prioritizer, allocator=sched["allocator"],
            backfill=bool(sched["backfill"]),
            lookahead_k=int(sched["lookahead_k"]),
            queue_window=int(sched["queue_window"]),
            hooks=(MultiHooks(*taps.hooks(), pred),), predictor=pred)
        self.jobs = make_jobs(arrays)
        self.engine.submit(self.jobs)

    def start_state(self) -> dict:
        return export_state(self.engine)

    def replay(self) -> list:
        """Step to the snapshot; return the record of every pass."""
        eng, snap, taps = self.engine, self.traffic["snapshot"], self.taps
        min_pending = int(snap.get("min_pending", 0))
        min_arrived = int(snap.get("min_arrived", 0))
        submit = np.array([j.submit_time for j in self.jobs])
        recs = []
        while True:
            if len(eng.pending) >= min_pending and \
                    int(np.searchsorted(submit, eng.now, side="right")) \
                    >= min_arrived:
                break
            taps.begin()
            if eng.step(math.inf, max_events=1) == 0:
                raise RuntimeError("the trace ran dry before the snapshot")
            recs.append(taps.end(eng.now))
        return recs

    def snapshot(self) -> bytes:
        return self.engine.save_state()


def export_state(eng) -> dict:
    """The engine's state as plain data: what the reference starts from."""
    pred = eng.predictor
    out = {
        "now": float(eng.now),
        "pending": [j.job_id for j in eng.pending],
        "running": [(jid, tuple(sorted(r[1].items())), float(r[2]),
                     float(r[3]), float(r[4]))
                    for jid, r in eng.running.items()],
        "remaining": {int(k): float(v) for k, v in eng.remaining.items()},
        "events": [(float(t), int(s), k,
                    p.job_id if k == "arrival" else int(p))
                   for t, s, k, p in eng._events],
        "deadlines": [(int(j), float(t))
                      for j, t in eng._bf_deadlines.items()],
        "barred": sorted(int(j) for j in eng._bf_overrun_jobs),
        "free_gpus": eng.cluster.free_gpus.copy(),
        "free_cpus": eng.cluster.free_cpus.copy(),
        "free_mem": eng.cluster.free_mem.copy(),
        "counters": {"milp_calls": int(eng.milp_calls),
                     "milp_fallbacks": int(eng.milp_fallbacks),
                     "decisions": int(eng.decisions)},
    }
    if pred is not None:
        out["predictor"] = {
            "params": {k: v.astype(np.float64)
                       for k, v in pred.mlp.params.items()},
            "bias_sum": dict(pred._bias_sum), "bias_n": dict(pred._bias_n)}
    return out


def run_segment(blob: bytes, passes: int, taps: Taps, pass_s: list,
                annotate):
    """Restore one snapshot and run ``passes`` passes; return the
    records, the counts, the restore wall, the failed passes and what a
    raising pass raised.  ``pass_s`` collects each pass's wall."""
    from repro_torch.sched import SchedulerEngine
    t0 = time.perf_counter()
    with annotate("perfbench.restore"):
        eng = SchedulerEngine.load_state(blob, hooks=taps.hooks())
    restore_s = time.perf_counter() - t0
    calls0, fb0 = eng.milp_calls, eng.milp_fallbacks
    launches0 = (len(taps.policy), len(taps.predict))
    recs, failed, raised = [], 0, None
    for _ in range(passes):
        taps.begin()
        t = time.perf_counter()
        fb = eng.milp_fallbacks
        try:
            with annotate("perfbench.pass"):
                n = eng.step(math.inf, max_events=1)
        except Exception as exc:  # noqa: BLE001 - a raising pass fails
            taps.end(eng.now)
            failed += 1
            raised = repr(exc)
            break
        pass_s.append(time.perf_counter() - t)
        recs.append(taps.end(eng.now))
        if eng.milp_fallbacks > fb:
            failed += 1
        if n == 0:
            break
    counts = {"passes": len(recs),
              "decisions": sum(len(r["decisions"]) for r in recs),
              "starts": sum(len(r["starts"]) for r in recs),
              "milp_calls": eng.milp_calls - calls0,
              "milp_fallbacks": eng.milp_fallbacks - fb0,
              "policy_launches": len(taps.policy) - launches0[0],
              "predict_launches": len(taps.predict) - launches0[1]}
    return recs, counts, restore_s, failed, raised


def run_unit(blobs: list, passes: int, taps: Taps, sync, pass_s, annotate):
    """One unit: each snapshot restored in turn and run ``passes`` passes,
    then the device synchronised.  Returns (records per snapshot, summed
    counts with the unit's wall, restore walls, failed passes, what a
    raising pass raised)."""
    recs, total, restores, failed = [], {}, [], 0
    t0 = time.perf_counter()
    for blob in blobs:
        r, c, r_s, f, raised = run_segment(blob, passes, taps, pass_s,
                                           annotate)
        recs.append(r)
        restores.append(r_s)
        failed += f
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
        if raised:
            break
    sync()
    total["wall_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    return recs, total, restores, failed, raised
