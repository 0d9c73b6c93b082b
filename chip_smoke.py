#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from anywhere with ``python3 chip_smoke.py``; it needs one CUDA card and
the CUDA toolkit (``nvcc``).  Phases, each reporting on its own lines:

1. device: require CUDA and print the card's name and power limit;
2. build: compile both hand-written kernels from the checkout (policy MLP
   and runtime-predictor MLP), one ``nvcc`` each, started together;
3. kernel: hold the policy-MLP kernel against its plain torch version on
   the card (atol 1e-5) at the queue depths the main path uses, and time
   both: the device time per call (calls replayed from a CUDA graph) and the
   time per call issued eagerly from Python, back to back (CUDA events);
4. main path: the RLTune decision loop over a 4096-job Philly trace
   (MILP placement, EASY backfill, the 2560-job queue window, greedy actor
   plus deep-window tail scoring), counting the kernel's launches;
5. check: recompute the logits of the first 200 head and 200 tail calls
   with the plain version on the same device inputs and compare values and
   rankings;
6. explore: sampled policy steps on the card;
7. small: a 96-job Helios schedule on the card equals the CPU's;
8. predict kernel: the same for the predictor-MLP kernel (random non-zero
   head, atol 1e-5) at the batch sizes of the stream below;
9. stream: the streaming service over a 10,000-job ``mispredict-storm``
   stream with the prediction bench's settings, once blind and once with
   predictor-assisted EASY backfill on the card, counting the predictor
   kernel's launches;
10. stream check: recompute the first 200 predictor calls of the stream
    with the plain version on the same device inputs and weights;
11. stream small: on 300-job ``mispredict-storm`` the assisted schedule on
    the card equals the CPU's and a shadow predictor leaves it as with no
    predictor; on 600-job ``flash-crowd`` the greedy actor (with its
    deep-window scorer) and the assisted predictor together give the CPU's
    schedule on the card.

Then one JSON line describing both kernels (times, launches, bounds), and as
the last line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before that line.  It imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ATOL = 1e-5
QS = (256, 300, 2304, 4096, 16384)
SHAPES = ((8, 64, 32), (8, 32, 16))
MAIN_Q = 4096                    # the deepest tail bucket of the main path
CHECK_DECISIONS = 200
# predictor MLP: batch sizes of the stream (1 .. the 2560-job queue window;
# 1103 is the 3,000-job stream's deepest batch) and the net 21 -> 24 -> 12 -> 2
BS = (1, 8, 300, 1103, 2560, 16384)
PREDICT_SHAPE = (21, 24, 12, 2)
MAIN_B = 2560                    # the saturated queue window of the stream
STREAM_JOBS = 10000
CHECK_PREDICTS = 200
# H100 SXM data sheet: f32 outside the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 50, replays: int = 20) -> float:
    """Device time of one call: ``calls`` calls captured into a CUDA graph
    and replayed, so host-side dispatch does not enter the time."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bound(Q: int, n_live: int, F: int, H1: int, H2: int) -> tuple[float, str]:
    """Least time (ms) for the fused MLP on the H100: the operations the
    unmasked rows need (2 per multiply-add) over the f32 peak, or every
    input read once and the output written once over the memory rate."""
    flops = 2.0 * (F * H1 + H1 * H2 + H2) * n_live
    nbytes = 4.0 * (Q * F + Q + Q + F * H1 + H1 + H1 * H2 + 2 * H2 + 1)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def predict_bound(B: int, F: int, H1: int, H2: int, Q: int) -> tuple[float, str]:
    """Least time (ms) for the predictor MLP on the H100: its operations (2
    per multiply-add) over the f32 peak, or every input read once and the
    output written once over the memory rate."""
    flops = 2.0 * (F * H1 + H1 * H2 + H2 * Q) * B
    nbytes = 4.0 * (B * F + B * Q + F * H1 + H1 + H1 * H2 + H2 + H2 * Q + Q)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def signature(engine):
    """The schedule signature of ``tests/test_predict.py``."""
    jobs = tuple(sorted(
        (j.job_id, round(j.submit_time, 6),
         round(j.first_start_time if j.first_start_time is not None else -1,
               6),
         round(j.finish_time if j.finish_time is not None else -1, 6),
         j.restarts)
        for j in engine.completed))
    return jobs, (engine.decisions, engine.milp_calls, engine.backfills,
                  engine.restarts, engine.bf_reservations,
                  engine.bf_overruns)


def stream(num_jobs: int, predictor, scenario: str = "mispredict-storm",
           prioritizer=None):
    """One stream at the prediction bench's settings
    (``benchmarks/bench_prediction.py``): ``pack``, rescan 60 s, samples
    every hour, FCFS on declared estimates unless ``prioritizer`` is given.
    Returns the ``StreamResult`` and the wall seconds."""
    from repro_torch.core.policies import make_policy
    from repro_torch.sched import PolicyPrioritizer, get_scenario, run_scenario
    run = get_scenario(scenario).build(num_jobs, 0)
    pri = prioritizer or PolicyPrioritizer(make_policy("fcfs",
                                                       use_estimates=True))
    t0 = time.perf_counter()
    sr = run_scenario(run, allocator="pack", rescan_interval=60.0,
                      sample_interval=3600.0, prioritizer=pri,
                      predictor=predictor)
    return sr, time.perf_counter() - t0


def rank_agrees(kernel_logits, plain_logits, tol: float) -> bool:
    """The kernel's stable descending order, read through the plain logits,
    never puts a row ahead of one that the plain version scores more than
    ``tol`` higher: the rankings agree up to reordering inside groups of
    logits closer than ``tol``."""
    import numpy as np
    order = np.argsort(-kernel_logits, kind="stable")
    seq = plain_logits[order].astype(np.float64)
    later_max = np.maximum.accumulate(seq[::-1])[::-1]
    return bool(np.all(later_max - seq <= tol))


def predict_kernel_phase(dev) -> tuple[float, dict]:
    """Phase 8: the predictor-MLP kernel against its plain version at every
    batch size in ``BS`` (unit-scale weights, the head included: a zero
    head would hide every error), timed as in phase 3.  Returns the largest
    error and {B: (ms, plain_ms, bound_ms, bound_by)}."""
    import numpy as np
    import torch
    from repro_torch.kernels import predict_mlp as qm
    from repro_torch.kernels.ref import predict_mlp_ref

    F, H1, H2, Q = PREDICT_SHAPE
    q_err = 0.0
    q_timings = {}
    for B in BS:
        rng = np.random.default_rng(B)

        def t(*shape):
            return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                                device=dev)
        xq = t(B, F)
        qp = [t(F, H1), t(H1), t(H1, H2), t(H2), t(H2, Q), t(Q)]
        got = qm.predict_mlp(xq, *qp)
        want = predict_mlp_ref(xq, *qp)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= ATOL, f"predict kernel vs plain at B={B}: max abs err "
              f"{err:.3e} > {ATOL}")
        q_err = max(q_err, err)
        ms = graph_ms(lambda: qm.predict_mlp(xq, *qp))
        plain_ms = graph_ms(lambda: predict_mlp_ref(xq, *qp))
        call_ms = time_ms(lambda: qm.predict_mlp(xq, *qp))
        plain_call_ms = time_ms(lambda: predict_mlp_ref(xq, *qp))
        b_ms, b_by = predict_bound(B, F, H1, H2, Q)
        q_timings[B] = (ms, plain_ms, b_ms, b_by)
        print(f"predict kernel: B={B} F,H1,H2,Q={F},{H1},{H2},{Q} "
              f"max_abs_err={err:.3e} device_us kernel={ms * 1e3:.3f} "
              f"plain={plain_ms * 1e3:.3f} bound={b_ms * 1e3:.4f} ({b_by}); "
              f"eager call_us kernel={call_ms * 1e3:.3f} "
              f"plain={plain_call_ms * 1e3:.3f}")
    return q_err, q_timings


def predict_stream_phase(dev, num_jobs: int) -> dict:
    """Phases 9-10, the slice's main path: a ``num_jobs``-job
    ``mispredict-storm`` stream blind, then with predictor-assisted EASY
    backfill on ``dev``, counting the predictor kernel's launches in the
    assisted run; then the first ``CHECK_PREDICTS`` predictor calls
    recomputed by the plain version on the same inputs and weights.
    The assisted run wall-clocks the predictor's host methods
    (``predict_quantiles`` with its ``_rows`` and ``_forward``, the weight
    upload ``_device_params`` inside ``_forward``, and the training hooks).
    Returns {"launches", "max_abs_err"}."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, predict_mlp as qm
    from repro_torch.kernels.ref import predict_mlp_ref
    from repro_torch.predict import RuntimePredictor

    keys = ("w1", "b1", "w2", "b2", "w3", "b3")
    blind, blind_wall = stream(num_jobs, None)
    pred = RuntimePredictor(assist=True, seed=0, device=dev)
    record: list[tuple[torch.Tensor, dict, torch.Tensor]] = []
    by_b: dict[int, int] = {}
    spans: dict[str, list] = {}              # method -> [calls, seconds]
    uploads = [0, None]                      # weight uploads, last copy
    real_predict_mlp = ops.predict_mlp

    def tapped_predict_mlp(x, params):
        """Counts calls by batch size and keeps the inputs, weights and
        outputs of the first CHECK_PREDICTS calls for the check."""
        out = real_predict_mlp(x, params)
        by_b[x.shape[0]] = by_b.get(x.shape[0], 0) + 1
        if len(record) < CHECK_PREDICTS:
            record.append((x.clone(), {k: params[k].clone() for k in keys},
                           out.clone()))
        return out

    def timed(name):
        fn = getattr(pred, name)
        acc = spans.setdefault(name, [0, 0.0])

        def wrapper(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                acc[0] += 1
                acc[1] += time.perf_counter() - t0
        setattr(pred, name, wrapper)

    for name in ("predict_quantiles", "_rows", "_forward", "_device_params",
                 "on_submit", "on_finish"):
        timed(name)
    timed_params = pred._device_params

    def counted_params():
        out = timed_params()
        if out is not uploads[1]:
            uploads[0] += 1
            uploads[1] = out
        return out

    pred._device_params = counted_params
    ops.predict_mlp = tapped_predict_mlp
    start = qm.launches
    try:
        assisted, wall = stream(num_jobs, pred)
        torch.cuda.synchronize()
    finally:
        ops.predict_mlp = real_predict_mlp
    launches = qm.launches - start
    for name, sr, w in (("blind", blind, blind_wall),
                        ("assisted", assisted, wall)):
        e = sr.engine
        waits = np.array([j.wait_time for j in sr.batch.jobs])
        check(len(sr.batch.jobs) == num_jobs,
              f"{name} stream completed {len(sr.batch.jobs)} of {num_jobs} "
              "jobs")
        print(f"stream: mispredict-storm {num_jobs} jobs seed 0, pack, "
              f"rescan 60 s, {name}: completed={len(sr.batch.jobs)} "
              f"wall_s={w:.3f} windows={sr.windows} "
              f"wait_p50_h={np.percentile(waits, 50) / 3600.0:.4f} "
              f"wait_p99_h={np.percentile(waits, 99) / 3600.0:.4f} "
              f"backfills={e.backfills} bf_reservations={e.bf_reservations} "
              f"bf_overruns={e.bf_overruns}")
    check(assisted.engine.bf_reservations > 0,
          "the assisted stream committed no predictor-gated reservation")
    errors = getattr(assisted.engine.hooks, "errors", [])
    check(not errors, f"hooks raised during the assisted stream: {errors[:3]}")
    forwards = spans["_forward"][0]
    check(launches >= forwards > 0,
          f"predict_mlp launches {launches} < batched forwards {forwards}")
    sizes = np.repeat(np.fromiter(by_b, int), list(by_b.values()))
    hist: dict[str, int] = {}
    for lo in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096):
        n = int(((sizes >= lo) & (sizes < 2 * lo)).sum())
        if n:
            hist[f"{lo}-{2 * lo - 1}"] = n
    print(f"stream: assisted predictor mape={pred.mape():.6f} "
          f"baseline_mape={pred.baseline_mape():.6f} "
          f"train_steps={pred.train_steps} batched_forwards={forwards} "
          f"launches={launches} rows={int(sizes.sum())} "
          f"B_p50={np.percentile(sizes, 50):.0f} "
          f"B_p99={np.percentile(sizes, 99):.0f} B_max={sizes.max()} "
          f"weight_uploads={uploads[0]}")
    print(f"stream: predictor calls by B {hist}")
    print("stream: assisted wall " + " ".join(
        f"{name}={n}x/{sec:.3f}s({100.0 * sec / wall:.1f}%)"
        for name, (n, sec) in spans.items()) +
        " (predict_quantiles holds _rows and _forward; _forward holds the "
        "device calls and _device_params)")

    worst = 0.0
    with torch.no_grad():
        for x, params, out in record:
            plain = predict_mlp_ref(x, *(params[k] for k in keys))
            worst = max(worst, (out - plain).abs().max().item())
    check(len(record) == min(CHECK_PREDICTS, forwards),
          f"recorded {len(record)} predictor calls")
    check(worst <= ATOL, f"stream predictor outputs vs plain: max abs err "
          f"{worst:.3e}")
    rows = [x.shape[0] for x, _, _ in record]
    print(f"stream check: the first {len(record)} predictor calls (B "
          f"{min(rows)}-{max(rows)}, weights as uploaded at each call): "
          f"max_abs_err={worst:.3e}")
    return {"launches": launches, "max_abs_err": worst}


def stream_small_phase(card) -> None:
    """Phase 11: small streams on the card against the CPU.  300-job
    ``mispredict-storm``: the assisted schedule on ``card`` equals the
    CPU's, and a shadow predictor on ``card`` leaves the schedule of no
    predictor.  600-job ``flash-crowd`` with the greedy actor (deep-window
    scorer on) and the assisted predictor: both kernels run inside the
    streaming loop, and the schedule equals the CPU's."""
    from repro_torch.core import PPOAgent, RLPrioritizer
    from repro_torch.kernels import policy_mlp as pm, predict_mlp as qm
    from repro_torch.kernels.batch_score import BucketedScorer
    from repro_torch.predict import RuntimePredictor

    sig = {}
    for device in (card, "cpu"):
        sr, _ = stream(300, RuntimePredictor(assist=True, seed=0,
                                             device=device))
        sig[str(device)] = signature(sr.engine)
    got, want = sig[str(card)], sig["cpu"]
    check(got == want, f"mispredict-storm 300 assisted: card {got[1]} != "
          f"CPU {want[1]}")
    check(got[1][4] > 0, "mispredict-storm 300 assisted: no reservation")
    shadow, _ = stream(300, RuntimePredictor(assist=False, seed=0,
                                             device=card))
    none, _ = stream(300, None)
    check(signature(shadow.engine) == signature(none.engine),
          "mispredict-storm 300: the shadow predictor on the card changed "
          "the schedule")
    print(f"stream small: mispredict-storm 300 jobs: assisted on the card == "
          f"CPU {got[1]}; shadow on the card == no predictor "
          f"{signature(none.engine)[1]}")
    sig, used = {}, {}
    for device in (card, "cpu"):
        agent = PPOAgent(device=device)
        pri = RLPrioritizer(agent, explore=False,
                            deep_scorer=BucketedScorer(agent.params["actor"]))
        before = (pm.launches, qm.launches)
        sr, _ = stream(600, RuntimePredictor(assist=True, seed=0,
                                             device=device),
                       scenario="flash-crowd", prioritizer=pri)
        used[str(device)] = (pm.launches - before[0], qm.launches - before[1])
        sig[str(device)] = signature(sr.engine)
    got, want = sig[str(card)], sig["cpu"]
    check(got == want, f"flash-crowd 600 greedy actor + assisted predictor: "
          f"card {got[1]} != CPU {want[1]}")
    check(min(used[str(card)]) > 0,
          f"flash-crowd 600: kernel launches on the card {used[str(card)]}")
    print(f"stream small: flash-crowd 600 jobs, greedy actor + deep scorer + "
          f"assisted predictor: card == CPU {got[1]}; launches on the card "
          f"policy_mlp={used[str(card)][0]} predict_mlp={used[str(card)][1]}")



def main() -> int:
    import numpy as np
    import torch

    # ---------------------------------------------------------- 1. device --
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import repro_torch
    check(Path(repro_torch.__file__).resolve().is_relative_to(SRC),
          f"repro_torch imported from {repro_torch.__file__}, not {SRC}")
    from repro_torch.core import (ClusterState, PPOAgent, RLPrioritizer,
                                  Simulator, generate_trace, make_cluster)
    from repro_torch.core.agent import policy_step, value
    from repro_torch.core.features import build_state
    from repro_torch.kernels import ops, policy_mlp as pm, predict_mlp as qm
    from repro_torch.kernels.batch_score import BucketedScorer
    from repro_torch.kernels.ref import policy_mlp_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
          f" torch {torch.__version__} cuda {torch.version.cuda}"
          f" python {sys.version.split()[0]}")
    print(smi)

    # ----------------------------------------------------------- 2. build --
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = [(mod, pool.submit(mod.build)) for mod in (pm, qm)]
        for mod, fut in builds:
            print(f"build: {mod.SOURCE.stem} from "
                  f"{mod.SOURCE.relative_to(ROOT)} in {fut.result():.2f} s -> "
                  f"{mod.library_path().relative_to(ROOT)}")
    print(f"build: both kernels in {time.perf_counter() - t0:.2f} s")

    # ------------------------------------------ 3. kernel vs plain version --
    gen = torch.Generator().manual_seed(0)

    def case(Q, F, H1, H2):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen).to(dev)
        layers = [{"w": rnd(a, b), "b": rnd(b)}
                  for a, b in ((F, H1), (H1, H2), (H2, 1))]
        x = rnd(Q, F)
        mask = (torch.rand(Q, generator=gen) < 0.5).float().to(dev)
        flat = [t for lyr in layers for t in (lyr["w"], lyr["b"])]
        return x, flat, mask, layers

    max_err = 0.0
    timings = {}
    for F, H1, H2 in SHAPES:
        for Q in QS:
            x, flat, mask, _ = case(Q, F, H1, H2)
            got = pm.policy_mlp(x, *flat, mask)
            want = policy_mlp_ref(x, *flat, mask)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(err <= ATOL, f"kernel vs plain at Q={Q} {(F, H1, H2)}: "
                  f"max abs err {err:.3e} > {ATOL}")
            max_err = max(max_err, err)
            ms = graph_ms(lambda: pm.policy_mlp(x, *flat, mask))
            plain_ms = graph_ms(lambda: policy_mlp_ref(x, *flat, mask))
            call_ms = time_ms(lambda: pm.policy_mlp(x, *flat, mask))
            plain_call_ms = time_ms(lambda: policy_mlp_ref(x, *flat, mask))
            b_ms, b_by = bound(Q, int(mask.sum().item()), F, H1, H2)
            timings[(Q, F, H1, H2)] = (ms, plain_ms, b_ms, b_by)
            print(f"kernel: Q={Q} F,H1,H2={F},{H1},{H2} max_abs_err={err:.3e} "
                  f"device_us kernel={ms * 1e3:.3f} plain={plain_ms * 1e3:.3f} "
                  f"bound={b_ms * 1e3:.4f} ({b_by}); eager call_us "
                  f"kernel={call_ms * 1e3:.3f} plain={plain_call_ms * 1e3:.3f}")
    rows = torch.randn(2304, 8, generator=gen).numpy()
    _, _, _, layers = case(8, 8, 64, 32)
    got = BucketedScorer(layers).score(rows)
    xs = torch.from_numpy(rows).to(dev)
    want = policy_mlp_ref(xs, *[t for lyr in layers for t in (lyr["w"], lyr["b"])],
                          torch.ones(2304, device=dev)).cpu().numpy()
    err = float(np.abs(got - want).max())
    check(err <= ATOL, f"BucketedScorer on 2304 rows: max abs err {err:.3e}")
    max_err = max(max_err, err)
    print(f"kernel: BucketedScorer 2304 rows (bucket 4096) max_abs_err={err:.3e}")

    # ------------------------------------------------------- 4. main path --
    agent = PPOAgent(device="cuda")
    scorer = BucketedScorer(agent.params["actor"])
    actor = agent.params["actor"]
    record: list[tuple[str, torch.Tensor, torch.Tensor, torch.Tensor]] = []
    counts = {"rank": 0, "tail": 0}
    by_q: dict[int, int] = {}
    rank_s: list[float] = []
    device_s = [0.0]
    in_tail = [False]
    real_policy_mlp = ops.policy_mlp
    real_act, real_score = agent.act, scorer.score

    def tapped_policy_mlp(x, params, mask):
        """Counts calls by row count and keeps the inputs and outputs of the
        first CHECK_DECISIONS head and tail calls for phase 5."""
        out = real_policy_mlp(x, params, mask)
        by_q[x.shape[0]] = by_q.get(x.shape[0], 0) + 1
        kind = "tail" if in_tail[0] else "head"
        seen = counts["tail"] if in_tail[0] else counts["rank"]
        if seen <= CHECK_DECISIONS:
            record.append((kind, x.clone(), mask.clone(), out.clone()))
        return out

    def timed_act(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real_act(*a, **kw)
        finally:
            device_s[0] += time.perf_counter() - t0

    def timed_score(feats):
        counts["tail"] += 1
        in_tail[0] = True
        t0 = time.perf_counter()
        try:
            return real_score(feats)
        finally:
            device_s[0] += time.perf_counter() - t0
            in_tail[0] = False

    class TimedRLPrioritizer(RLPrioritizer):
        def rank_window(self, jobs, cluster, now, fields):
            counts["rank"] += 1
            t0 = time.perf_counter()
            order = super().rank_window(jobs, cluster, now, fields)
            rank_s.append(time.perf_counter() - t0)
            return order

    agent.act, scorer.score = timed_act, timed_score
    pri = TimedRLPrioritizer(agent, explore=False, deep_scorer=scorer)
    spec = make_cluster("philly")
    jobs = generate_trace("philly", 4096, seed=0)
    sim = Simulator(spec, allocator="milp", backfill=True)
    ops.policy_mlp = tapped_policy_mlp
    pm.launches = qm.launches = 0
    t0 = time.perf_counter()
    try:
        res = sim.run_batch([j.clone_pending() for j in jobs], pri)
        torch.cuda.synchronize()
    finally:
        ops.policy_mlp = real_policy_mlp
    wall = time.perf_counter() - t0
    launches = pm.launches
    done = sum(1 for j in res.jobs if j.finish_time >= 0)
    check(len(res.jobs) == 4096 and done == 4096,
          f"main path completed {done} of 4096 jobs")
    check(launches >= res.decisions + counts["tail"] and launches > 0,
          f"policy_mlp launches {launches} < decisions {res.decisions} + "
          f"tail calls {counts['tail']}")
    lat = np.asarray(rank_s) * 1e3
    tup = (res.makespan, res.total_wait, res.gpu_seconds_used, res.decisions,
           res.milp_calls, res.backfills, res.restarts)
    print(f"main: philly 4096 jobs seed 0, milp + backfill, window 2560: "
          f"BatchResult {tup}")
    print(f"main: wall_s={wall:.3f} rank_calls={counts['rank']} "
          f"tail_calls={counts['tail']} launches={launches} "
          f"rank_ms_p50={np.percentile(lat, 50):.4f} "
          f"rank_ms_p99={np.percentile(lat, 99):.4f} "
          f"act_and_score_s={device_s[0]:.3f} "
          f"calls_by_q={dict(sorted(by_q.items()))}")

    # ----------------------------------------------------------- 5. check --
    flat = [t for lyr in actor for t in (lyr["w"], lyr["b"])]
    n_head = sum(1 for r in record if r[0] == "head")
    n_tail = len(record) - n_head
    check(n_head >= CHECK_DECISIONS and n_tail >= min(CHECK_DECISIONS,
                                                      counts["tail"]),
          f"recorded {n_head} head and {n_tail} tail calls")
    worst = 0.0
    with torch.no_grad():
        for kind, x, mask, out in record:
            plain = policy_mlp_ref(x, *flat, mask)
            worst = max(worst, (out - plain).abs().max().item())
            check(rank_agrees(out.cpu().numpy(), plain.cpu().numpy(), ATOL),
                  f"{kind} ranking differs from the plain version's beyond "
                  f"{ATOL}")
    check(worst <= ATOL, f"main-path logits vs plain: max abs err {worst:.3e}")
    print(f"check: the first {n_head} head and {n_tail} tail calls: "
          f"max_abs_err={worst:.3e}, rankings "
          f"agree up to ties within {ATOL}")

    # --------------------------------------------------------- 6. explore --
    ov, cv, mask = build_state(jobs[:300], ClusterState(spec),
                               jobs[299].submit_time)
    g = torch.Generator(device=dev).manual_seed(0)
    ovt, cvt = torch.from_numpy(ov).to(dev), torch.from_numpy(cv).to(dev)
    mt = torch.from_numpy(mask).to(dev)
    with torch.no_grad():
        v_cpu = value(copy.deepcopy(agent.net).to("cpu"),
                      torch.from_numpy(cv)).item()
        plain_logp = torch.log_softmax(policy_mlp_ref(ovt, *flat, mt), -1)
        for i in range(8):
            out = policy_step(agent.net, ovt, cvt, mt, generator=g)
            a = int(out["action"])
            lp = plain_logp[a].item()
            check(mask[a] > 0, f"explore step {i}: action {a} is masked")
            check(np.isfinite(out["logp"].item()) and
                  np.isfinite(out["value"].item()),
                  f"explore step {i}: non-finite logp or value")
            check(abs(out["logp"].item() - lp) <= ATOL,
                  f"explore step {i}: logp {out['logp'].item()} vs {lp}")
            check(abs(out["value"].item() - v_cpu) <= ATOL * max(1.0, abs(v_cpu)),
                  f"explore step {i}: value {out['value'].item()} vs CPU {v_cpu}")
    print(f"explore: 8 sampled steps inside the mask, logp within {ATOL} of "
          f"log_softmax(plain logits), value {out['value'].item():.6f} "
          f"(CPU {v_cpu:.6f})")

    # ------------------------------------------- 7. schedule on a small run --
    # the same greedy schedule on the card as on the CPU, where the plain
    # version (held to the JAX package by the CPU tests) scores the queue
    small = []
    for device in ("cuda", "cpu"):
        a = PPOAgent(device=device)
        r = Simulator(make_cluster("helios"), allocator="milp").run_batch(
            generate_trace("helios", 96, seed=0),
            RLPrioritizer(a, explore=False,
                          deep_scorer=BucketedScorer(a.params["actor"])))
        small.append((r.makespan, r.total_wait, r.gpu_seconds_used,
                      r.decisions, r.milp_calls, r.backfills, r.restarts))
    check(small[0] == small[1], f"helios 96: card {small[0]} != CPU {small[1]}")
    print(f"small: helios 96 jobs seed 0, milp: the card's BatchResult equals "
          f"the CPU's {small[0]}")

    # ------------------------------------------------- 8. predict kernel --
    q_err, q_timings = predict_kernel_phase(dev)

    # ------------------------------------------ 9-10. stream and its check --
    pm.launches = qm.launches = 0
    q = predict_stream_phase(dev, STREAM_JOBS)

    # ---------------------------------------------------- 11. stream small --
    stream_small_phase(dev)

    # --------------------------------------------------------- the record --
    ms, plain_ms, b_ms, b_by = timings[(MAIN_Q, 8, 64, 32)]
    q_ms, q_plain_ms, q_b_ms, q_b_by = q_timings[MAIN_B]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "policy_mlp",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/policy_mlp.cu",
        "replaces": "src/repro/kernels/policy_mlp.py:35",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }, {
        "name": "predict_mlp",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/predict_mlp.cu",
        "replaces": "src/repro/kernels/predict_mlp.py:37",
        "launches": q["launches"],
        "max_abs_err": max(q_err, q["max_abs_err"]),
        "ms": q_ms,
        "plain_ms": q_plain_ms,
        "bound_ms": q_b_ms,
        "bound_by": q_b_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
