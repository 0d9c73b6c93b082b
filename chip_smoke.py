#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from anywhere with ``python3 chip_smoke.py``; it needs one CUDA card and
the CUDA toolkit (``nvcc``).  Phases, each reporting on its own lines:

1. device: require CUDA and print the card's name and power limit;
2. build (with 12.): compile all five hand-written kernels from the
   checkout (policy MLP, runtime-predictor MLP, flash attention, SSD scan,
   MoE router), one ``nvcc`` each, all started together;
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
   head, atol 1e-5) at the batch sizes of the stream below, beside the
   card's launch floor (``launch_floor_us``: the graph-replay time of a
   one-element in-place ``add_``, taken the same way);
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
    schedule on the card;
13. LM kernels: hold the flash-attention, SSD-scan and MoE-router kernels
    against their plain versions on the card, at the attention, SSD and
    router shapes of every registered config at full width, in bf16
    (atol/rtol 2e-2) and f32 (2e-5 attention, 2e-3 SSD; router weights
    1e-5 and indices equal where the k-th and (k+1)-th logits are more
    than 1e-4 apart), and time each at the serve shape below (device time
    from CUDA-graph replay), beside its plain version, its bound and, for
    attention, ``scaled_dot_product_attention`` as a yardstick (bf16
    attention runs on the tensor cores, f32 attention on IEEE FMAs); every
    router case is timed, with its route, and the serve shape's decode and
    prefill calls also with a cold L2 (a 128 MiB ``zero_`` before each
    call, its own time taken off);
14. LM serve: ``jamba-v0.1-52b`` cut to one 8-layer superblock at full
    width, bf16, seeded random weights on the card: ``ServeEngine`` (batch
    4) serves 8 requests of 2,048-token prompts and 32 new tokens each
    through the kernel path, counting each kernel's launches; then a
    profiled prefill and 4 decode steps give where the device time goes
    (and the router's calls and device µs per call in each);
15. LM check: the first batch again through the plain path
    (``ModelImpl(attn="xla", ssd="xla", moe="xla")``) on the card: the
    prefill logits agree within the reference's own bf16 tolerance (0.15,
    ``tests/test_models_smoke.py``), each decode step's within its 0.2 up to
    each row's first differing token (reported with its logit gap), with
    the difference's RMS within a tenth of the logits' RMS; all logits are
    finite;
16. train: ``RLTuneTrainer`` on the card at the paper's settings and full
    width (helios, FCFS base, wait, batches of 256 jobs, the pro variant
    with MILP placement, ``PPOConfig()``: actor 8->64->32->1, critic
    1280->128->64->1, queue 256, ``max_steps`` 512, 4 epochs), with
    ``batches_per_epoch`` cut from the paper's 100 to 8, then
    ``evaluate(num_batches=2)``: per batch the reward, loss, decisions and
    recorded steps; the wall time split into simulation, ``act`` and
    update, the device ms per ``ppo_update_step`` (CUDA events), the
    policy-MLP launches by Q and the peak memory, and a profile of one
    more update and 64 ``act`` calls (device busy ms, idle share, kernel
    events; on copies, after the launches are read); every reward and loss
    finite, every update changing the parameters, no masked action
    sampled, at least one launch per recorded step;
17. train check: from phase 16's agent and its last padded batch, the
    card's PPO loss, gradients, ``adam_update`` on identical gradients and
    one ``ppo_update_step`` against the CPU's (tolerances at
    ``TRAIN_LOSS_TOL`` and below); then a small training (helios, batch
    64, 2 batches) on the card and on the CPU with the same numpy Gumbel
    noise: the same actions up to the first near-tie (top-two gap under
    1e-4, reported) and the same rewards wherever the actions agree;
18. stream train: ``StreamingTrainer(StreamingConfig())`` on the card for
    2 streams (cut from 8), then its greedy evaluation on ``flash-crowd``
    against FCFS; ``run_live`` on a 256-job Helios batch with one SLA user:
    no ranking puts an SLA job behind a non-SLA job;
19. fleet: the operator's path, ``run_fleet`` over a 10,000-job
    ``fleet-skewed-flash`` at the federation bench's quick size (``jsq``,
    ``pack``, FCFS, rescan 60 s), members stepped in parallel, each with
    its own assisted ``RuntimePredictor`` on the card and the autoscaling
    bench's ``target-util`` controller (whose forecast hold scores the
    pending window through the predictor): completed jobs, windows, wall,
    per member decisions, backfills, reservations, overruns and scale
    events, the predictor kernel's launches per member (counted at each
    member's ``_forward``, summing to the kernel's own count) and the share
    of the wall in the predictors' ``_forward``; then the first 200
    predictor calls recomputed by the plain version (atol 1e-5);
20. fleet check: on a 600-job ``fleet-skewed-flash`` (seed 3) with
    assisted predictors in every member and the greedy actor (seeded
    ``PPOConfig()`` weights, deep-window scorer) in member 0, the card's
    parallel run equals the card's serial run, which equals the CPU's
    (``tests/test_predict.py``'s fleet signature); a shadow-predictor fleet
    on the card equals the predictor-less fleet;
21. control plane: a 2,000-job ``slo-lanes`` stream at the preemption
    bench's quick size and controller (SLO deadlines and elastic gangs),
    with an assisted predictor and the greedy actor on the card and the
    full ``Observability`` bundle: deadline hit rate, lifecycle events,
    both kernels' launches; the trace validates, ``obs.report.analyze``
    reads it, the Prometheus text holds ``repro_prediction_mape`` and
    ``repro_preemptions_total``; then a 1,000-job
    ``fleet-fault-migration`` with ``QueueImbalanceMigration``;
22. LM train: ``launch.train.train_loop`` on ``granite-moe-1b-a400m`` at
    every published width and all 24 layers (1.335 B parameters, bf16,
    f32 Adam moments), the plain path with full remat and the
    cross-entropy in 4 chunks, at train_4k's 4,096-token sequences with the
    global batch cut from 256 to 4: run A trains 12 steps; run B, the same
    run with checkpoints every 4 steps, is killed when step 9 asks for its
    batch; run C restarts on B's directory and trains steps 9-12.  Prints
    the losses and gnorms, step ms p50 / p99 (host clock, each step ending
    in its loss read), tokens/s, peak memory, the step's analytic bound
    (``launch.roofline`` at one chip) and MFU against 989 TFLOP/s, the
    checkpoint codec's rates, and a profile of one more step (device busy
    ms, idle share, top kernels); checks every loss and gnorm finite, A's
    last loss below its first, B's step-8 checkpoint restored onto the card
    equal to B's state bit for bit (params, moments, step), C resumed at 8
    and ran 4 steps with A's losses within ``RESUME_RTOL``, and no kernel
    launched by training;
23. LM train check: the smoke config in f32, one train step (microbatches
    1 and 2), its loss, gradients, gnorm and updated parameters on the card
    against the CPU's; then phase 22's trained weights served (4 prompts of
    512 tokens from the training stream, 16 new tokens) through the kernel
    path, counting flash-attention and router launches, and again through
    the plain path at phase 15's tolerances;
24. distribution, in subprocesses that own their process groups: (a) a
    world of 1 over NCCL on the 1x1 host mesh: phase 22's cell for 2 steps
    through ``train_loop(mesh=...)`` (params and moments DTensors), whose
    losses must equal phase 22's run A's first two bit for bit (else be
    within ``DIST_LOSS_RTOL``, the first difference printed); its step-2
    checkpoint, written from the DTensors, restored onto the mesh by
    ``load_checkpoint(mesh=..., spec_tree=...)`` bit for bit; the dry run
    of the same cell on a 1x1 fake mesh, whose param and optimizer-state
    bytes must equal the allocated shards', beside the measured peak; GPipe
    (S 4, M 8) at world 1 (one stage of all four layers: no backend takes
    point-to-point between ranks sharing one card); (b) four ranks on the
    one card over gloo: ``pod_allreduce_compressed`` on CUDA tensors
    equal to a numpy evaluation of its formula bit for bit;
25. platform: ``generate_platform_trace(2048, seed=0)`` (runtimes from the
    cost model at H100 rates) through the greedy loop at phase 4's
    settings on the platform example's helios cluster, counting the
    policy-MLP kernel's launches, the first 200 head and 200 tail calls
    recomputed by the plain version as phase 5 does, a 96-job platform
    schedule on the card equal to the CPU's, and the dry run of
    ``granite-moe-1b-a400m`` x ``train_4k`` on the fake 16x16 mesh;
26. paper tables: the port's eight paper and stream benches
    (``benchmarks_torch``: Fig 6, Fig 10, Tables 6-9 with Figs 11-17 and
    Fig 17 at its quick 2,048 jobs, then ``bench_prediction`` and
    ``bench_rl_streaming`` at smoke size) in this process with every agent
    and predictor on the card, each agent trained on 2 batch pairs of 128
    (cut from the quick scale's 60) and evaluated on 1 batch (from 4),
    cached under the git-ignored ``build/chip_smoke_agents/``: every bench
    returns rows, every row finite, policy_mlp launches at least the RL
    decisions (``PPOAgent.act`` calls), predict_mlp launches in every
    assisted arm and none in a blind one; then the cached pro, naive and
    inspector philly agents evaluated on the card and on the CPU: the same
    greedy decisions up to the first near-tie (two live logits within
    1e-4) and, where all agree, the same ``evaluate()``.

Then one JSON line describing all five kernels (times, launches, bounds;
``launches_by_path`` gives each kernel's launches on each path it runs
on), the run's time on the line before the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line.  It imports nothing of JAX or of the ``repro``
package.
"""
from __future__ import annotations

import copy
import gc
import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
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


def time_calls(obj, name: str, acc: list) -> None:
    """Replace ``obj.name`` by a wrapper adding one call and its seconds
    to ``acc`` ([calls, seconds])."""
    fn = getattr(obj, name)

    def wrapper(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            acc[0] += 1
            acc[1] += time.perf_counter() - t0
    setattr(obj, name, wrapper)


def job_times(jobs) -> tuple:
    """Each completed job's id, submit, first start, finish and restarts,
    sorted: the job part of ``tests/test_predict.py``'s signatures."""
    return tuple(sorted(
        (j.job_id, round(j.submit_time, 6),
         round(j.first_start_time if j.first_start_time is not None else -1,
               6),
         round(j.finish_time if j.finish_time is not None else -1, 6),
         j.restarts)
        for j in jobs))


def signature(engine):
    """The schedule signature of ``tests/test_predict.py``."""
    return job_times(engine.completed), (
        engine.decisions, engine.milp_calls, engine.backfills,
        engine.restarts, engine.bf_reservations, engine.bf_overruns)


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
    head would hide every error), timed as in phase 3, after the card's
    launch floor.  Returns the largest error and {B: (ms, plain_ms,
    bound_ms, bound_by)}."""
    import numpy as np
    import torch
    from repro_torch.kernels import predict_mlp as qm
    from repro_torch.kernels.ref import predict_mlp_ref

    one = torch.zeros(1, device=dev)
    floor_ms = graph_ms(lambda: one.add_(1.0))
    print(f"predict kernel: launch_floor_us={floor_ms * 1e3:.3f} (graph "
          "replay of a one-element in-place add_)")
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
              f"plain={plain_ms * 1e3:.3f} bound={b_ms * 1e3:.4f} ({b_by}) "
              f"launch_floor={floor_ms * 1e3:.3f}; "
              f"eager call_us kernel={call_ms * 1e3:.3f} "
              f"plain={plain_call_ms * 1e3:.3f}")
    return q_err, q_timings


PREDICT_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


def recording_predict_mlp(real, record: list, on_call=None):
    """``real`` (``ops.predict_mlp``) that keeps the inputs, weights and
    outputs of its first CHECK_PREDICTS calls in ``record`` and hands each
    call's input to ``on_call``."""
    def tapped(x, params):
        out = real(x, params)
        if on_call is not None:
            on_call(x)
        if len(record) < CHECK_PREDICTS:
            record.append((x.clone(), {k: params[k].clone()
                                       for k in PREDICT_KEYS}, out.clone()))
        return out
    return tapped


def recorded_predicts_err(record: list) -> float:
    """The largest |kernel - plain version| over the recorded calls, the
    plain version on the same inputs and weights."""
    import torch
    from repro_torch.kernels.ref import predict_mlp_ref
    worst = 0.0
    with torch.no_grad():
        for x, params, out in record:
            plain = predict_mlp_ref(x, *(params[k] for k in PREDICT_KEYS))
            worst = max(worst, (out - plain).abs().max().item())
    return worst


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
    from repro_torch.predict import RuntimePredictor

    blind, blind_wall = stream(num_jobs, None)
    pred = RuntimePredictor(assist=True, seed=0, device=dev)
    record: list[tuple[torch.Tensor, dict, torch.Tensor]] = []
    by_b: dict[int, int] = {}
    spans: dict[str, list] = {}              # method -> [calls, seconds]
    uploads = [0, None]                      # weight uploads, last copy
    real_predict_mlp = ops.predict_mlp

    def by_batch(x):
        by_b[x.shape[0]] = by_b.get(x.shape[0], 0) + 1

    for name in ("predict_quantiles", "_rows", "_forward", "_device_params",
                 "on_submit", "on_finish"):
        time_calls(pred, name, spans.setdefault(name, [0, 0.0]))
    timed_params = pred._device_params

    def counted_params():
        out = timed_params()
        if out is not uploads[1]:
            uploads[0] += 1
            uploads[1] = out
        return out

    pred._device_params = counted_params
    ops.predict_mlp = recording_predict_mlp(real_predict_mlp, record, by_batch)
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

    worst = recorded_predicts_err(record)
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


# ------------------------------------------------------ LM serving slice --
LM_ARCH = "jamba-v0.1-52b"
LM_LAYERS = 8                    # one hybrid superblock, every width as published
LM_BATCH = 4
LM_PROMPT = 2048                 # a multiple of the 256-step SSD chunk
LM_NEW = 32
LM_REQUESTS = 8
# bf16 kernel path vs bf16 plain path: the reference's own bf16 tolerances
# for prefill and decode logits (tests/test_models_smoke.py), and the RMS
# of the difference at most a tenth of the logits' RMS (unrelated logits
# would give ~1.4)
PREFILL_TOL, DECODE_TOL, REL_RMS_TOL = 0.15, 0.2, 0.1
PEAK_BF16_FLOPS = 989e12
# a zero_ of this many bytes between router calls evicts the 50 MB L2, as
# the expert GEMMs between two router calls of the served model do
L2_FLUSH_BYTES = 128 << 20
LM_TOL = {"float32": {"flash_attention": 2e-5, "ssd_scan": 2e-3},
          "bfloat16": {"flash_attention": 2e-2, "ssd_scan": 2e-2}}


def lm_bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def flash_bound(B, H, KV, L, D, window, dtype) -> tuple[float, str]:
    """q.k and p.v over the (query, key) pairs the mask keeps (2 FLOP per
    multiply-add each), against q, k, v and o moved once."""
    import torch
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(L))
    flops = 4.0 * B * H * D * pairs
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * B * L * D * (2 * H + 2 * KV)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    return lm_bound(flops, nbytes, peak)


def ssd_bound(B, L, H, P, N, chunk, dtype) -> tuple[float, str]:
    """The chunked SSD's products at the reference's chunk: C.B^T per
    (batch, chunk), the lower-triangular W.x, the state's share C.S and
    the state update per (batch, head, chunk); against x, dt, B, C and y
    moved once and the final state written once."""
    import torch
    Q = min(chunk, L)
    nc = L // Q
    flops = B * nc * (2.0 * Q * Q * N
                      + H * (Q * (Q + 1) * P + 4.0 * Q * P * N))
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (size * (2 * B * L * H * P + 2 * B * L * N) + 4 * B * L * H
              + 4 * H + 4 * B * H * P * N)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    return lm_bound(flops, nbytes, peak)


def router_bound(T, d, E, k, dtype) -> tuple[float, str]:
    """x.W in f32 (W is f32): f32 FMAs, or for bf16 x three exact bf16
    products on the tensor cores (W split in three bf16 parts), whichever
    the card does sooner; against x and W read once and the weights and
    indices written once (the top-k passes are negligible)."""
    import torch
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * T * d + 4 * d * E + 8 * T * k
    if dtype == torch.bfloat16:
        return lm_bound(3 * 2.0 * T * d * E, nbytes, PEAK_BF16_FLOPS)
    return lm_bound(2.0 * T * d * E, nbytes, PEAK_F32_FLOPS)


def router_check(x, w, k, got_w, got_i) -> float:
    """Where the k-th and (k+1)-th plain logits are more than 1e-4 apart,
    the kernel picks the same set of experts with weights within 1e-5 (in
    its order); where every gap among the top k + 1 exceeds 1e-4, the same
    experts in the same order.  Returns the weights' max abs error on the
    rows held."""
    import torch
    from repro_torch.kernels.ref import moe_router_ref
    want_w, want_i = moe_router_ref(x, w, k)
    E = w.shape[1]
    top = torch.sort(x.float() @ w, dim=-1, descending=True).values
    gaps = top[:, :min(k + 1, E)].diff(dim=-1).neg()
    set_sep = gaps[:, k - 1] > 1e-4 if k < E else torch.ones_like(top[:, 0],
                                                                 dtype=bool)
    ord_sep = (gaps > 1e-4).all(dim=-1)
    check(bool(set_sep.float().mean() > 0.9) or len(set_sep) < 100,
          f"router: only {int(set_sep.sum())} of {len(set_sep)} rows separated")
    what = f"T={x.shape[0]} E={E} k={k}"
    check(torch.equal(got_i[set_sep].sort(dim=-1).values,
                      want_i[set_sep].sort(dim=-1).values),
          f"router expert sets differ at {what}")
    check(torch.equal(got_i[ord_sep], want_i[ord_sep]),
          f"router expert order differs at {what}")
    err = float((got_w - want_w)[set_sep].abs().max()) if bool(set_sep.any()) else 0.0
    check(err <= 1e-5, f"router weights differ by {err:.3e} > 1e-5 at {what}")
    return err


def lm_kernel_phase(dev) -> dict:
    """Phase 13.  Returns {kernel: row of the JSON record at the serve
    shape}, each with the largest error over all its checks."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.kernels import flash_attention as fa, moe_router as mr
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_ref

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(dtype)

    cfgs = [get_config(a) for a in ALL_ARCHS]
    lm = get_config(LM_ARCH)
    rows = {}

    # -- flash attention: every registered (H, KV, D, window), bf16 and f32;
    # timed at the serve shape
    main = (LM_BATCH, lm.num_heads, lm.num_kv_heads, LM_PROMPT, lm.head_dim_,
            lm.window)
    shapes = {main}
    for c in cfgs:
        if c.family != "ssm":
            L = 4608 if c.window else 1000
            shapes.add((1, c.num_heads, c.num_kv_heads, L, c.head_dim_, c.window))
    err_max = 0.0
    for B, H, KV, L, D, win in sorted(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn((B, n, L, D), dtype) for n in (H, KV, KV))
            got = fa.flash_attention(q, k, v, causal=True, window=win)
            want = flash_attention_ref(q, k, v, causal=True, window=win)
            tol = LM_TOL[str(dtype).split(".")[1]]["flash_attention"]
            err = float((got.float() - want.float()).abs().max())
            bad = ((got.float() - want.float()).abs()
                   > tol + tol * want.float().abs()).sum().item()
            check(bad == 0, f"flash_attention {(B, H, KV, L, D, win)} {dtype}: "
                  f"{bad} elements outside {tol} (max abs err {err:.3e})")
            err_max = max(err_max, err)
            line = (f"lm kernel: flash_attention B,H,KV,L,D,window="
                    f"{B},{H},{KV},{L},{D},{win} {dtype} max_abs_err={err:.3e}")
            if (B, H, KV, L, D, win) == main and dtype == torch.bfloat16:
                ms = graph_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                              calls=5, replays=5)
                plain_ms = graph_ms(lambda: flash_attention_ref(q, k, v),
                                    calls=2, replays=3)
                # the yardstick: SDPA on the grouped inputs, and on k, v
                # repeated to H heads beforehand (the faster one is kept)
                kr, vr = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
                gqa_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), calls=5,
                    replays=5)
                rep_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                    q, kr, vr, is_causal=True), calls=5, replays=5)
                lib_ms = min(gqa_ms, rep_ms)
                sd = F.scaled_dot_product_attention(q, kr, vr, is_causal=True)
                del kr, vr
                b_ms, b_by = flash_bound(B, H, KV, L, D, win, dtype)
                rows["flash_attention"] = dict(ms=ms, plain_ms=plain_ms,
                                               bound_ms=b_ms, bound_by=b_by,
                                               library_ms=lib_ms)
                line += (f" device_us kernel={ms * 1e3:.1f} plain="
                         f"{plain_ms * 1e3:.1f} sdpa_gqa={gqa_ms * 1e3:.1f} "
                         f"sdpa_repeated_kv={rep_ms * 1e3:.1f} kernel/sdpa="
                         f"{ms / lib_ms:.2f} bound={b_ms * 1e3:.1f} ({b_by}) "
                         f"kernel/bound={ms / b_ms:.2f}; sdpa vs plain "
                         f"max_abs_err={float((sd.float() - want.float()).abs().max()):.3e}")
            print(line)
            del q, k, v, got, want
    rows["flash_attention"]["max_abs_err"] = err_max

    # -- SSD scan: the serve shape (Jamba, N 16) and mamba2-780m's (N 128),
    # the latter from an initial state, also shorter than a chunk
    main = (LM_BATCH, LM_PROMPT, lm.ssm_heads, lm.ssm_head_dim, lm.ssm_state)
    m2 = get_config("mamba2-780m")
    cases = [(main, False),
             ((1, LM_PROMPT, m2.ssm_heads, m2.ssm_head_dim, m2.ssm_state), True),
             ((1, 200, m2.ssm_heads, m2.ssm_head_dim, m2.ssm_state), True)]
    err_max = 0.0
    for (B, L, H, P, N), init in cases:
        for dtype in (torch.bfloat16, torch.float32):
            xh = randn((B, L, H, P), dtype, 0.5)
            dt = F.softplus(randn((B, L, H)))
            A = -torch.exp(randn((H,), scale=0.3))
            Bs, Cs = randn((B, L, N), dtype, 0.3), randn((B, L, N), dtype, 0.3)
            S0 = randn((B, H, P, N), scale=0.3) if init else None
            y, S = ss.ssd_scan(xh, dt, A, Bs, Cs, S0)
            y_want, S_want = ssd_scan_ref(xh, dt, A, Bs, Cs, S0)
            tol = LM_TOL[str(dtype).split(".")[1]]["ssd_scan"]
            for name, g, w, t in (("y", y.float(), y_want.float(), tol),
                                  ("state", S, S_want, 2e-3)):
                bad = ((g - w).abs() > t + t * w.abs()).sum().item()
                check(bad == 0, f"ssd_scan {(B, L, H, P, N)} {dtype} {name}: "
                      f"{bad} elements outside {t}")
            err = max(float((y.float() - y_want.float()).abs().max()),
                      float((S - S_want).abs().max()))
            err_max = max(err_max, err)
            ms = graph_ms(lambda: ss.ssd_scan(xh, dt, A, Bs, Cs, S0),
                          calls=5, replays=5)
            b_ms, b_by = ssd_bound(B, L, H, P, N, lm.ssm_chunk, dtype)
            line = (f"lm kernel: ssd_scan B,L,H,P,N={B},{L},{H},{P},{N} "
                    f"init_state={init} {dtype} max_abs_err={err:.3e} "
                    f"device_us kernel={ms * 1e3:.1f} bound={b_ms * 1e3:.1f} "
                    f"({b_by})")
            if (B, L, H, P, N) == main and dtype == torch.bfloat16:
                plain_ms = graph_ms(lambda: ssd_scan_ref(xh, dt, A, Bs, Cs),
                                    calls=1, replays=3)
                rows["ssd_scan"] = dict(ms=ms, plain_ms=plain_ms,
                                        bound_ms=b_ms, bound_by=b_by,
                                        library_ms=None)
                line += (f" plain={plain_ms * 1e3:.1f} "
                         f"kernel/bound={ms / b_ms:.2f}")
            print(line)
            del xh, dt, Bs, Cs, y, y_want
    rows["ssd_scan"]["max_abs_err"] = err_max
    print(f"lm kernel: one ssd_scan call launches {ss.kernels_per_call()} "
          "CUDA kernels (chunk states, state passing, outputs)")

    # -- MoE router: every registered (d, E, k), decode and prefill sizes,
    # each timed; at the serve shape (bf16) also beside its plain version
    # and with a cold L2
    from repro_torch.kernels.ref import moe_router_ref
    err_max = 0.0
    routers = sorted({(c.d_model, c.num_experts, c.experts_per_token)
                      for c in cfgs if c.num_experts})
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    flush_ms = graph_ms(flush.zero_, calls=10, replays=5)
    for d, E, k in routers:
        for T in (LM_BATCH, LM_BATCH * LM_PROMPT):
            for dtype in (torch.bfloat16, torch.float32):
                x = randn((T, d), dtype)
                w = randn((d, E), scale=0.1 / np.sqrt(d))
                got_w, got_i = mr.moe_router(x, w, k)
                err = router_check(x, w, k, got_w, got_i)
                err_max = max(err_max, err)
                ms = graph_ms(lambda: mr.moe_router(x, w, k))
                b_ms, b_by = router_bound(T, d, E, k, dtype)
                line = (f"lm kernel: moe_router T,d,E,k={T},{d},{E},{k} "
                        f"{dtype} route={mr.route(T, d, E, dtype)} "
                        f"kernels_per_call="
                        f"{mr.kernels_per_call(T, d, E, dtype)} "
                        f"max_abs_err={err:.3e} device_us kernel="
                        f"{ms * 1e3:.2f} bound={b_ms * 1e3:.3f} ({b_by})")
                if (d, E, k) == (lm.d_model, lm.num_experts,
                                 lm.experts_per_token) and dtype == torch.bfloat16:
                    plain_ms = graph_ms(lambda: moe_router_ref(x, w, k))

                    def cold():
                        flush.zero_()
                        mr.moe_router(x, w, k)
                    cold_ms = graph_ms(cold, calls=10, replays=5) - flush_ms
                    if T == LM_BATCH * LM_PROMPT:
                        rows["moe_router"] = dict(ms=ms, plain_ms=plain_ms,
                                                  bound_ms=b_ms, bound_by=b_by,
                                                  library_ms=None)
                    line += (f" plain={plain_ms * 1e3:.2f} cold_l2="
                             f"{cold_ms * 1e3:.2f} (a {L2_FLUSH_BYTES >> 20} "
                             f"MiB zero_ first, its {flush_ms * 1e3:.2f} us "
                             "taken off)")
                print(line)
    del flush
    rows["moe_router"]["max_abs_err"] = err_max
    torch.cuda.empty_cache()
    return rows


def lm_prompts(vocab: int) -> list[list[int]]:
    import numpy as np
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, vocab, size=LM_PROMPT)]
            for _ in range(LM_REQUESTS)]


def tap_engine(engine, record_rows: int):
    """Wrap the engine's prefill and decode step: host-clock each one (a
    synchronize on either side), keep the logits of the first batch on the
    card, and count non-finite logits.  Returns the record dict."""
    import torch
    rec = {"prefill_s": [], "decode_s": [], "logits": [], "nonfinite": 0,
           "batches": 0}
    model, real_prefill, real_decode = engine.model, engine.model.prefill, \
        engine._decode
    V = model.cfg.vocab_size

    def keep(logits):
        rec["nonfinite"] += int((~torch.isfinite(logits[:, :V])).sum())
        if rec["batches"] == 1 and len(rec["logits"]) < record_rows:
            rec["logits"].append(logits.float().clone())

    def prefill(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = real_prefill(*a, **kw)
        torch.cuda.synchronize()
        rec["prefill_s"].append(time.perf_counter() - t0)
        rec["batches"] += 1
        keep(logits)
        return logits, cache

    def decode(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, logits, cache = real_decode(*a)
        torch.cuda.synchronize()
        rec["decode_s"].append(time.perf_counter() - t0)
        keep(logits)
        return tok, logits, cache

    model.prefill, engine._decode = prefill, decode
    return rec


def profile_where_time_goes(model, params, engine, prompts) -> None:
    """Device time by kernel over one profiled prefill of the first batch
    and 4 decode steps after it (torch.profiler; CUDA events are the
    fallback measurement if the profiler sees no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    toks = torch.tensor(prompts[:LM_BATCH], dtype=torch.int32,
                        device=model.device)

    from repro_torch.kernels import moe_router as mr

    def table(prof, wall_s, label, router_calls):
        rows = []                       # device-side events: kernels, copies
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0.0)
            if e.device_type == torch.autograd.DeviceType.CUDA and t > 0:
                rows.append((t, e.key, e.count))
        total = sum(t for t, _, _ in rows)
        if total <= 0:
            print(f"where: {label}: the profiler saw no device time "
                  "(not measured)")
            return
        rows.sort(reverse=True)
        # the port's kernels by name stem (flash_attention_bf16_kernel<128>;
        # an SSD call's chunk_state_bf16, state_pass and chunk_scan_bf16;
        # a router call's moe_router_partial and moe_router_topk (decode) or
        # moe_router_split_w and moe_router_mma (prefill))
        stems = {"flash_attention": ("flash_attention",),
                 "ssd_scan": ("chunk_state", "state_pass", "chunk_scan"),
                 "moe_router": ("moe_router",)}
        ours = {n: 0.0 for n in stems}
        gemm = 0.0
        for t, key, _ in rows:
            for n, names in stems.items():
                if any(stem in key for stem in names):
                    ours[n] += t
            if any(w in key.lower() for w in ("gemm", "xmma", "cutlass",
                                               "nvjet", "gemv")):
                gemm += t
        print(f"where: {label}: wall_ms={wall_s * 1e3:.3f} "
              f"device_busy_ms={total / 1e3:.3f} "
              f"idle_share={max(0.0, 1 - total / 1e3 / (wall_s * 1e3)):.3f} "
              + " ".join(f"{n}_ms={t / 1e3:.3f}"
                         f"({100 * t / total:.1f}%)" for n, t in ours.items())
              + f" gemm_ms={gemm / 1e3:.3f}({100 * gemm / total:.1f}%)"
              + f" moe_router_calls={router_calls} moe_router_us_per_call="
              f"{ours['moe_router'] / max(router_calls, 1):.2f}")
        for t, key, n in rows[:8]:
            print(f"where: {label}:   {t / 1e3:9.3f} ms {100 * t / total:5.1f}% "
                  f"x{n:<5d} {key[:90]}")

    with torch.inference_mode():
        torch.cuda.synchronize()
        n0 = mr.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, toks, pad_to=engine.S)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        table(prof, wall, f"prefill (B {LM_BATCH} x {LM_PROMPT})",
              mr.launches - n0)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        n0 = mr.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                logits, cache = model.decode_step(params, tok, cache)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        table(prof, wall, f"decode (4 steps of B {LM_BATCH})",
              mr.launches - n0)


def plain_path_check(cfg, params, prompts, new_tokens, done, rec, max_len,
                     dev, label) -> None:
    """The first batch of ``prompts`` again through the plain path
    (``ModelImpl(attn="xla", ssd="xla", moe="xla")``) on the card, held to
    the kernel path's run (``done``, its tapped logits ``rec``): prefill
    logits within PREFILL_TOL, each decode step's within DECODE_TOL up to
    each row's first differing token, the difference's RMS within
    REL_RMS_TOL of the logits' RMS; all logits finite."""
    from repro_torch.models import build_model
    from repro_torch.models.lm import ModelImpl
    from repro_torch.serve import Request, ServeEngine

    xla = build_model(cfg, impl=ModelImpl(attn="xla", ssd="xla", moe="xla"),
                      device=dev)
    x_engine = ServeEngine(xla, params, batch_size=LM_BATCH, max_len=max_len,
                           device=dev)
    x_rec = tap_engine(x_engine, new_tokens)
    x_done = x_engine.run([Request(req_id=i, prompt=p,
                                   max_new_tokens=new_tokens)
                           for i, p in enumerate(prompts[:LM_BATCH])])
    check(x_rec["nonfinite"] == 0, f"{x_rec['nonfinite']} non-finite logits "
          "on the plain path")
    V = cfg.vocab_size
    k_logits, x_logits = rec["logits"], x_rec["logits"]

    def compare(kl, xl, tol, what):
        """max |kl - xl| <= tol + tol |xl| and RMS(kl - xl) <= REL_RMS_TOL
        RMS(xl); returns (max abs diff, relative RMS)."""
        diff = (kl - xl).abs()
        bad = int((diff > tol + tol * xl.abs()).sum())
        rel = float((kl - xl).pow(2).mean().sqrt() / xl.pow(2).mean().sqrt())
        check(bad == 0 and rel <= REL_RMS_TOL,
              f"{label}: {what}: kernel vs plain path, {bad} logits outside "
              f"{tol}, max abs diff {float(diff.max()):.4f}, relative RMS "
              f"{rel:.4f}")
        return float(diff.max()), rel

    pre_err, pre_rel = compare(k_logits[0][:, :V], x_logits[0][:, :V],
                               PREFILL_TOL, "prefill logits")
    scale = float(x_logits[0][:, :V].pow(2).mean().sqrt())
    worst, worst_rel, agree, notes = 0.0, 0.0, 0, []
    for i in range(LM_BATCH):
        a, b = done[i].output, x_done[i].output
        for s in range(1, new_tokens):      # step s is fed token s - 1
            if a[s - 1] != b[s - 1]:
                break
            err, rel = compare(k_logits[s][i, :V], x_logits[s][i, :V],
                               DECODE_TOL, f"row {i} decode step {s}")
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
        for s in range(new_tokens):
            if a[s] != b[s]:
                kl = k_logits[s][i, :V]
                notes.append(f"row {i} token {s}: {a[s]} vs {b[s]}, kernel-path "
                             f"logit gap {float(kl[a[s]] - kl[b[s]]):.5f}")
                break
            agree += 1
    print(f"{label}: first batch through the plain path on the card: "
          f"prefill logits max_abs_diff={pre_err:.5f} relative_rms={pre_rel:.5f} "
          f"(logits RMS {scale:.4f}); decode logits up to each row's first "
          f"differing token max_abs_diff={worst:.5f} relative_rms="
          f"{worst_rel:.5f} (tolerances {PREFILL_TOL} / {DECODE_TOL} abs+rel, "
          f"{REL_RMS_TOL} relative RMS); greedy tokens agree on {agree} of "
          f"{LM_BATCH * new_tokens} up to each row's first near-tie: "
          f"{notes or 'none'}; all logits finite")


def lm_serve_phase(dev) -> dict:
    """Phases 14 and 15, the slice's main path and its check.  Returns the
    launches of each LM kernel in the served run."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa, moe_router as mr
    from repro_torch.kernels import policy_mlp as pm, predict_mlp as qm
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_LAYERS)
    model = build_model(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"lm serve: {LM_ARCH} cut to {LM_LAYERS} layers, "
          f"full width, {cfg.dtype}: {model.param_count() / 1e9:.3f} B "
          f"params ({model.active_param_count() / 1e9:.3f} B active), "
          f"seeded init on the card in {init_s:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompts = lm_prompts(cfg.vocab_size)
    max_len = LM_PROMPT + LM_NEW
    engine = ServeEngine(model, params, batch_size=LM_BATCH, max_len=max_len,
                         device=dev)
    # warm-up (cuBLAS handles and heuristics, the allocator): a short batch
    engine.run([Request(req_id=i, prompt=p[:256], max_new_tokens=2)
                for i, p in enumerate(prompts[:LM_BATCH])])
    rec = tap_engine(engine, LM_NEW)
    reqs = [Request(req_id=i, prompt=p, max_new_tokens=LM_NEW)
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    pm.launches = qm.launches = fa.launches = ss.launches = mr.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches, "ssd_scan": ss.launches,
                "moe_router": mr.launches}
    peak = torch.cuda.max_memory_allocated()
    n_batches = LM_REQUESTS // LM_BATCH
    n_super = cfg.num_layers // cfg.attn_period
    n_moe = n_super * sum(1 for j in range(cfg.attn_period)
                          if j % cfg.moe_period == 1)
    want = {"flash_attention": n_batches * n_super,
            "ssd_scan": n_batches * n_super * (cfg.attn_period - 1),
            "moe_router": n_moe * n_batches * (1 + (LM_NEW - 1))}
    check(all(n > 0 for n in launches.values()),
          f"an LM kernel was not launched on the main path: {launches}")
    check(launches == want, f"LM kernel launches {launches}, expected {want}")
    check(len(done) == LM_REQUESTS and all(len(r.output) == LM_NEW
                                           for r in done),
          "not every request got its tokens")
    check(rec["nonfinite"] == 0, f"{rec['nonfinite']} non-finite logits")
    pre, dec = np.asarray(rec["prefill_s"]) * 1e3, np.asarray(rec["decode_s"]) * 1e3
    new_tokens = sum(len(r.output) for r in done)
    print(f"lm serve: {LM_REQUESTS} requests x {LM_PROMPT}-token prompts, "
          f"{LM_NEW} new tokens each, batch {LM_BATCH}, max_len {max_len}: "
          f"wall_s={wall:.3f} prefill_ms={' '.join(f'{x:.2f}' for x in pre)} "
          f"decode_ms_per_step mean={dec.mean():.3f} p50="
          f"{np.percentile(dec, 50):.3f} p99={np.percentile(dec, 99):.3f} "
          f"steps={len(dec)} tokens_per_s={new_tokens / wall:.1f} "
          f"prefill_tokens_per_s={LM_BATCH * LM_PROMPT * len(pre) / pre.sum() * 1e3:.1f} "
          f"decode_tokens_per_s={LM_BATCH * len(dec) / dec.sum() * 1e3:.1f} "
          f"max_memory_allocated_GiB={peak / 2**30:.2f}")
    print(f"lm serve: launches {launches} (expected {want}); other kernels "
          f"policy_mlp={pm.launches} predict_mlp={qm.launches}")
    print(f"lm serve: first outputs {[r.output[:8] for r in done[:2]]}")
    profile_where_time_goes(model, params, engine, prompts)

    # -------------------------------------------------- 15. LM check --
    plain_path_check(cfg, params, prompts, LM_NEW, done, rec, max_len, dev,
                     "lm check")
    return launches


# ------------------------------------------------------ PPO training slice --
# phase 16: the paper's settings (Sec. 3.2: helios, FCFS base, wait, batches
# of 256 jobs, pro variant, PPOConfig() at the published widths), with
# batches_per_epoch cut from the paper's 100
TRAIN_BATCHES = 8
EVAL_BATCHES = 2
# phase 17's small run on the card and on the CPU
SMALL_TRAIN = dict(trace="helios", base_policy="fcfs", batch_size=64,
                   batches_per_epoch=2, epochs=1)
NEAR_TIE = 1e-4
# the card against the CPU (TF32 off on both, IEEE f32 sums in another
# order): loss rel 1e-5; each gradient leaf within 1e-4 of its largest CPU
# entry, the last actor bias (zero in exact arithmetic) below 1e-5 of the
# last actor weight's largest gradient; after one PPO step all parameters
# but a 1e-4 fraction within 1e-6, the rest within 2 * lr
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
# adam_update on identical gradients: two ulps of the parameter (the clip's
# global norm is summed in another order) plus 1e-5 of the step (CUDA's
# powf is within 2 ulps, and 1 - 0.999 ** t magnifies an ulp of 0.999 ** t
# some 30-fold at t ~ 33, so the step may differ by ~16 ulps of itself)
ADAM_ULPS = 2
ADAM_STEP_RTOL = 1e-5
STEP_ATOL = 1e-6
STEP_FRACTION = 1e-4
# phase 18: StreamingConfig() with streams cut from 8
STREAMS = 2
LIVE_JOBS = 256

# ------------------------------------------------- control plane and fleet --
# phase 19: the federation bench's quick size (benchmarks/bench_federation.py)
FLEET_JOBS = 10000
# phase 20: the fleet held to the CPU's; phase 21: the preemption bench's
# quick size (benchmarks/bench_preemption.py), then a migrating fleet
FLEET_CHECK_JOBS = 600
CONTROL_JOBS = 2000
MIGRATION_JOBS = 1000


def first_tie_and_diff(log_a: list, log_b: list, what: str
                       ) -> tuple[int, int, int | None]:
    """Two runs' logs of (decision, its top-two gap): the decisions both
    made, the first where either gap is below NEAR_TIE (or that count),
    and the first whose decisions differ (or None).  Fails if they differ
    before the first near-tie."""
    n = min(len(log_a), len(log_b))
    first_tie = next((i for i in range(n)
                      if min(log_a[i][1], log_b[i][1]) < NEAR_TIE), n)
    first_diff = next((i for i in range(n) if log_a[i][0] != log_b[i][0]),
                      None)
    check(first_diff is None or first_diff >= first_tie,
          f"{what}: decision {first_diff} differs before the first near-tie "
          f"({first_tie})")
    return n, first_tie, first_diff


def tree_leaves(tree) -> list[tuple[str, object]]:
    """(name, tensor) of each leaf of an agent's ``params``-shaped tree."""
    return [(f"{net}[{i}].{k}", lyr[k]) for net in ("actor", "critic")
            for i, lyr in enumerate(tree[net]) for k in ("w", "b")]


def tree_to(tree, device):
    return {net: [{k: t.detach().to(device) for k, t in lyr.items()}
                  for lyr in layers] for net, layers in tree.items()}


def profile_training(agent, batch) -> None:
    """Device time of one update (``update_epochs`` steps on a copy of the
    agent's net and Adam state, on phase 16's last batch) and of 64
    exploring ``act`` calls on its first state (torch.profiler): device
    busy ms, idle share of the wall and the kernels that took the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import agent as agent_mod

    ppo = agent.cfg
    net = copy.deepcopy(agent.net)
    state = {"m": tree_to(agent.opt_state["m"], agent.device),
             "v": tree_to(agent.opt_state["v"], agent.device),
             "t": agent.opt_state["t"].clone()}
    ov, cv, mask = (batch[k][0].cpu().numpy() for k in ("ov", "cv", "mask"))

    def update():
        nonlocal state
        for _ in range(ppo.update_epochs):
            _, state, loss = agent_mod.ppo_update_step(
                net, state, batch, clip_eps=ppo.clip_eps,
                value_coef=ppo.value_coef, entropy_coef=ppo.entropy_coef,
                lr=ppo.lr, max_norm=ppo.max_grad_norm)
        float(loss)

    def acts():
        for _ in range(64):
            agent.act(ov, cv, mask, explore=True, record=False)

    for label, fn in ((f"one update ({ppo.update_epochs} steps)", update),
                      ("64 act calls", acts)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = sorted(((e.self_device_time_total, e.key, e.count)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.self_device_time_total > 0), reverse=True)
        total = sum(t for t, _, _ in rows)
        if total <= 0:
            print(f"train profile: {label}: the profiler saw no device time "
                  "(not measured)")
            continue
        print(f"train profile: {label}: wall_ms={wall * 1e3:.3f} "
              f"device_busy_ms={total / 1e3:.3f} idle_share="
              f"{max(0.0, 1 - total / 1e3 / (wall * 1e3)):.3f} device events "
              f"{sum(n for _, _, n in rows)}; top: " + "; ".join(
                  f"{t / 1e3:.3f} ms x{n} {key[:60]}"
                  for t, key, n in rows[:5]))


def train_phase(dev) -> dict:
    """16. train: ``RLTuneTrainer`` on the card at the paper's settings."""
    import numpy as np
    import torch
    from repro_torch.core import agent as agent_mod
    from repro_torch.kernels import ops, policy_mlp as pm
    from repro_torch.rl import RLTuneTrainer, TrainerConfig

    check(not torch.backends.cuda.matmul.allow_tf32 and
          not torch.backends.cudnn.allow_tf32,
          "TF32 is on at the start of phase 16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = TrainerConfig(trace="helios", base_policy="fcfs", metric="wait",
                        batch_size=256, batches_per_epoch=TRAIN_BATCHES,
                        variant="pro")
    ppo = cfg.ppo
    print(f"train: batches_per_epoch cut from the paper's 100 to "
          f"{TRAIN_BATCHES} (then evaluate(num_batches={EVAL_BATCHES}))")
    print(f"train: helios, base fcfs, metric wait, batch 256, variant pro "
          f"(milp); PPOConfig() actor 8->{ppo.actor_hidden[0]}->"
          f"{ppo.actor_hidden[1]}->1, critic 1280->{ppo.critic_hidden[0]}->"
          f"{ppo.critic_hidden[1]}->1, queue 256, max_steps {ppo.max_steps}, "
          f"{ppo.update_epochs} epochs, lr {ppo.lr}")
    tr = RLTuneTrainer(cfg, device=dev)
    agent = tr.agent
    acc = {"act_s": 0.0, "acts": 0, "masked": 0, "pair_s": 0.0,
           "update_s": 0.0}
    by_q: dict[int, int] = {}
    events: list = []
    kept: dict = {}
    rows: list[dict] = []
    real_act, real_pair = agent.act, tr.run_batch_pair
    real_finish, real_step = agent.finish_episode, agent_mod.ppo_update_step
    real_policy_mlp = ops.policy_mlp

    def counted_policy_mlp(x, params, mask):
        by_q[x.shape[0]] = by_q.get(x.shape[0], 0) + 1
        return real_policy_mlp(x, params, mask)

    def timed_act(ov, cv, mask, explore=True, record=True):
        t0 = time.perf_counter()
        action, logits = real_act(ov, cv, mask, explore=explore,
                                  record=record)
        acc["act_s"] += time.perf_counter() - t0
        acc["acts"] += 1
        acc["masked"] += int(not mask[action] > 0)
        return action, logits

    def timed_pair(batch, *, explore, use_estimates):
        t0 = time.perf_counter()
        base, rl = real_pair(batch, explore=explore,
                             use_estimates=use_estimates)
        acc["pair_s"] += time.perf_counter() - t0
        if explore:
            rows.append({"decisions": (base.decisions, rl.decisions)})
        return base, rl

    def timed_step(net, opt_state, batch, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        kept["batch"] = batch
        start.record()
        out = real_step(net, opt_state, batch, **kw)
        end.record()
        events.append((start, end))
        return out

    def timed_finish(reward):
        before = [t.detach().clone() for _, t in tree_leaves(agent.params)]
        t0 = time.perf_counter()
        out = real_finish(reward)
        acc["update_s"] += time.perf_counter() - t0
        changed = any(not torch.equal(a, b) for a, (_, b) in
                      zip(before, tree_leaves(agent.params)))
        rows[-1].update(reward=reward, loss=out["loss"], steps=out["steps"],
                        Tc=min(out["steps"], ppo.max_steps),
                        updated=out["updated"], changed=changed)
        return out

    agent.act, tr.run_batch_pair = timed_act, timed_pair
    agent.finish_episode = timed_finish
    agent_mod.ppo_update_step = timed_step
    ops.policy_mlp = counted_policy_mlp
    pm.launches = 0
    try:
        t0 = time.perf_counter()
        hist = tr.train()[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        train_launches = pm.launches
        train_acc = dict(acc)
        for k in ("act_s", "acts", "pair_s"):
            acc[k] = 0
        t0 = time.perf_counter()
        ev = tr.evaluate(num_batches=EVAL_BATCHES)
        torch.cuda.synchronize()
        eval_wall = time.perf_counter() - t0
    finally:
        agent_mod.ppo_update_step = real_step
        ops.policy_mlp = real_policy_mlp
        agent.act, agent.finish_episode = real_act, real_finish
        tr.run_batch_pair = real_pair
    launches = pm.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile_training(agent, kept["batch"])
    for i, r in enumerate(rows):
        print(f"train: batch {i} reward={r['reward']:+.6f} "
              f"loss={r['loss']:+.6f} decisions base/rl={r['decisions'][0]}/"
              f"{r['decisions'][1]} steps={r['steps']} Tc={r['Tc']}")
    step_ms = [s.elapsed_time(e) for s, e in events]
    sim_s = train_acc["pair_s"] - train_acc["act_s"]
    print(f"train: wall_s={wall:.3f} = simulation (both pipelines, less act) "
          f"{sim_s:.3f} + act {train_acc['act_s']:.3f} "
          f"({train_acc['acts']} calls, "
          f"{train_acc['act_s'] / max(train_acc['acts'], 1) * 1e3:.4f} ms "
          f"each) + update {train_acc['update_s']:.3f} + other "
          f"{wall - train_acc['pair_s'] - train_acc['update_s']:.3f}")
    print(f"train: ppo_update_step device ms (CUDA events) over "
          f"{len(step_ms)} steps: mean={np.mean(step_ms):.4f} "
          f"p50={np.percentile(step_ms, 50):.4f} min={min(step_ms):.4f} "
          f"max={max(step_ms):.4f}; per update (all epochs) "
          f"{train_acc['update_s'] / len(rows) * 1e3:.3f} ms wall")
    print(f"train: evaluate({EVAL_BATCHES}) wall_s={eval_wall:.3f} "
          f"(act {acc['act_s']:.3f} s over {acc['acts']} calls): "
          + json.dumps(ev))
    print(f"train: policy_mlp launches {launches} (train {train_launches}, "
          f"evaluate {launches - train_launches}) by Q "
          f"{dict(sorted(by_q.items()))}; peak memory {peak:.3f} GiB")
    check(len(rows) == TRAIN_BATCHES, f"{len(rows)} batches trained")
    check(all(np.isfinite(r["reward"]) and np.isfinite(r["loss"])
              for r in rows), "a reward or loss is not finite")
    check(all(r["updated"] == 1.0 and r["changed"] for r in rows),
          "an update left the parameters unchanged")
    check(train_acc["masked"] == 0,
          f"{train_acc['masked']} sampled actions are masked")
    steps = sum(r["steps"] for r in rows)
    check(train_launches >= steps > 0,
          f"policy_mlp launches {train_launches} < recorded steps {steps}")
    check(all(np.isfinite(v) for side in ev.values() for v in side.values()),
          "evaluate gave a non-finite metric")
    return {"agent": agent, "batch": kept["batch"], "launches": launches,
            "step_ms": float(np.mean(step_ms))}


def grads_agree(g_card, g_cpu, rtol: float) -> float:
    """Checks each leaf of the card's gradients against the CPU's; returns
    the worst error relative to its leaf's largest CPU entry."""
    ref = {n: t for n, t in tree_leaves(g_cpu)}
    worst = 0.0
    for name, got in tree_leaves(g_card):
        got = got.cpu()
        if name == "actor[2].b":
            scale = ref["actor[2].w"].abs().max().item()
            check(got.abs().max().item() <= 1e-5 * scale,
                  f"grad {name}: {got.abs().max().item():.3e} not rounding "
                  f"noise against {scale:.3e}")
            continue
        check(bool(got.isfinite().all()), f"grad {name} is not finite")
        err = (got - ref[name]).abs().max().item()
        scale = ref[name].abs().max().item()
        check(err <= rtol * scale, f"grad {name}: err {err:.3e} > "
              f"{rtol} x {scale:.3e}")
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def params_agree(got, want, bound: float) -> tuple[int, int, float]:
    """All entries within ``bound``, all but a STEP_FRACTION within
    STEP_ATOL; returns (entries over STEP_ATOL, entries, largest error)."""
    total = loose = 0
    worst = 0.0
    for (name, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
        err = (g.detach().cpu() - w.detach().cpu()).abs()
        check(err.max().item() <= bound,
              f"param {name}: err {err.max().item():.3e} > {bound}")
        total += err.numel()
        loose += int((err > STEP_ATOL).sum())
        worst = max(worst, err.max().item())
    check(loose <= STEP_FRACTION * total,
          f"{loose} of {total} parameters differ by more than {STEP_ATOL}")
    return loose, total, worst


def train_check_phase(dev, trained: dict) -> None:
    """17. train check: the card against the CPU on phase 16's agent."""
    import numpy as np
    import torch
    from repro_torch.core import agent as agent_mod
    from repro_torch.rl import RLTuneTrainer, TrainerConfig

    agent = trained["agent"]
    ppo = agent.cfg
    kw = dict(clip_eps=ppo.clip_eps, value_coef=ppo.value_coef,
              entropy_coef=ppo.entropy_coef)
    card_net = copy.deepcopy(agent.net)
    cpu_net = copy.deepcopy(agent.net).to("cpu")
    batch = trained["batch"]
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    n_valid = int(cpu_batch["valid"].sum().item())
    l_card, g_card = agent_mod._loss_and_grads(card_net, batch, **kw)
    l_cpu, g_cpu = agent_mod._loss_and_grads(cpu_net, cpu_batch, **kw)
    d_loss = abs(l_card.item() - l_cpu.item())
    check(d_loss <= TRAIN_LOSS_TOL * max(1.0, abs(l_cpu.item())),
          f"loss card {l_card.item()} vs CPU {l_cpu.item()}")
    worst_g = grads_agree(g_card, g_cpu, TRAIN_GRAD_RTOL)
    # adam_update on identical gradients (the CPU's), from the agent's state
    state_cpu = {"m": tree_to(agent.opt_state["m"], "cpu"),
                 "v": tree_to(agent.opt_state["v"], "cpu"),
                 "t": agent.opt_state["t"].cpu()}
    state_card = {"m": tree_to(state_cpu["m"], dev),
                  "v": tree_to(state_cpu["v"], dev),
                  "t": state_cpu["t"].to(dev)}
    with torch.no_grad():
        p_card, s_card = agent_mod.adam_update(
            tree_to(card_net.params, dev), tree_to(g_cpu, dev), state_card,
            ppo.lr, max_norm=ppo.max_grad_norm)
        p_cpu, s_cpu = agent_mod.adam_update(
            tree_to(cpu_net.params, "cpu"), g_cpu, state_cpu, ppo.lr,
            max_norm=ppo.max_grad_norm)
    check(s_card["t"].item() == s_cpu["t"].item(), "Adam step counts differ")
    diff = ulps = 0
    total = 0
    for (name, a), (_, b), (_, old) in zip(tree_leaves(p_card),
                                           tree_leaves(p_cpu),
                                           tree_leaves(cpu_net.params)):
        a = a.cpu().numpy()
        b = b.numpy()
        old = old.detach().numpy()
        spacing = np.spacing(np.maximum.reduce(
            [np.abs(a), np.abs(b), np.abs(old)]))
        err = np.abs(a - b)
        check(bool((err <= ADAM_ULPS * spacing +
                    ADAM_STEP_RTOL * np.abs(old - b)).all()),
              f"adam_update {name}: card and CPU differ beyond "
              f"{ADAM_ULPS} ulps + {ADAM_STEP_RTOL} of the step")
        diff += int((err > 0).sum())
        ulps = max(ulps, float((err / spacing).max()))
        total += err.size
    # one full ppo_update_step on each side from the same state
    _, _, loss_card = agent_mod.ppo_update_step(
        card_net, state_card, batch, lr=ppo.lr, max_norm=ppo.max_grad_norm,
        **kw)
    _, _, loss_cpu = agent_mod.ppo_update_step(
        cpu_net, state_cpu, cpu_batch, lr=ppo.lr, max_norm=ppo.max_grad_norm,
        **kw)
    loose, n_params, worst_p = params_agree(card_net.params, cpu_net.params,
                                            2 * ppo.lr)
    print(f"train check: phase 16's last padded batch ({n_valid} valid of "
          f"{cpu_batch['valid'].numel()} steps), its agent's parameters and "
          f"Adam state (t={state_cpu['t'].item():.0f}): loss card "
          f"{l_card.item():.9f} CPU {l_cpu.item():.9f} (|d| {d_loss:.3e}, "
          f"tol {TRAIN_LOSS_TOL} rel); gradients within "
          f"{worst_g:.3e} of each leaf's max (tol {TRAIN_GRAD_RTOL}); "
          f"adam_update on identical gradients: {diff} of {total} entries "
          f"differ, at most {ulps:.1f} ulps (tol {ADAM_ULPS} ulps + "
          f"{ADAM_STEP_RTOL} of the step); one ppo_update_step: "
          f"{loose} of {n_params} parameters beyond {STEP_ATOL} (tol "
          f"{STEP_FRACTION} of them), largest {worst_p:.3e} (tol "
          f"{2 * ppo.lr}); step losses {loss_card.item():.9f} / "
          f"{loss_cpu.item():.9f}")

    # a small training on the card and on the CPU with the same injected noise
    runs = {}
    real_step = agent_mod.policy_step
    for device in (dev, "cpu"):
        rng = np.random.default_rng(2024)
        log: list[tuple[int, float]] = []

        def injected(net, ov, cv, mask, generator=None, gumbel=None):
            g = torch.from_numpy(rng.gumbel(size=ov.shape[0])
                                 .astype(np.float32)).to(ov.device)
            out = real_step(net, ov, cv, mask, gumbel=g)
            top2 = torch.topk(out["logits"] + g, 2).values
            log.append((int(out["action"]), float(top2[0] - top2[1])))
            return out

        tr = RLTuneTrainer(TrainerConfig(**SMALL_TRAIN), device=device)
        tr.agent.load_state_dict(agent.state_dict())
        bounds = []
        real_finish = tr.agent.finish_episode

        def marked(reward, _real=real_finish, _log=log, _b=bounds):
            _b.append(len(_log))
            return _real(reward)
        tr.agent.finish_episode = marked
        agent_mod.policy_step = injected
        try:
            t0 = time.perf_counter()
            hist = tr.train()[0]
            if device != "cpu":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            agent_mod.policy_step = real_step
        runs[str(device)] = (log, bounds, hist, wall)
    (log_c, bounds_c, hist_c, wall_c), (log_h, bounds_h, hist_h, wall_h) = \
        runs[str(dev)], runs["cpu"]
    n, first_tie, first_diff = first_tie_and_diff(log_c, log_h,
                                                  "small training")
    if first_diff is None:
        check(len(log_c) == len(log_h), "small training: step counts differ")
    agree = 0
    for b, (end_c, end_h) in enumerate(zip(bounds_c, bounds_h)):
        start = bounds_c[b - 1] if b else 0
        same = end_c == end_h and all(log_c[i][0] == log_h[i][0]
                                      for i in range(start, end_c))
        if same:
            check(hist_c.rewards[b] == hist_h.rewards[b],
                  f"small training batch {b}: the same actions but rewards "
                  f"{hist_c.rewards[b]} and {hist_h.rewards[b]}")
            agree += 1
    if first_tie < n:
        gap = min(log_c[first_tie][1], log_h[first_tie][1])
        tie_note = (f"first near-tie (top-two gap < {NEAR_TIE}) at step "
                    f"{first_tie}, gap {gap:.3e}")
    else:
        tie_note = f"no near-tie in {n} steps"
    actions_note = "all equal" if first_diff is None else \
        f"first differ at step {first_diff}"
    print(f"train check: small training {SMALL_TRAIN['trace']} batch "
          f"{SMALL_TRAIN['batch_size']} x {SMALL_TRAIN['batches_per_epoch']} "
          f"with numpy Gumbel noise on both sides: {len(log_c)} / "
          f"{len(log_h)} steps (card / CPU), actions {actions_note}; "
          f"{tie_note}; "
          f"rewards card {hist_c.rewards} CPU {hist_h.rewards}"
          f" ({agree} of {len(bounds_c)} batches with equal actions, equal "
          f"rewards); losses card {hist_c.losses} CPU {hist_h.losses}; wall "
          f"card {wall_c:.3f} s, CPU {wall_h:.3f} s")


def stream_train_phase(dev) -> dict:
    """18. stream train: ``StreamingTrainer`` and ``run_live`` on the card."""
    import numpy as np
    import torch
    from repro_torch.core import generate_trace, make_cluster
    from repro_torch.core import live
    from repro_torch.kernels import policy_mlp as pm
    from repro_torch.rl import StreamingConfig, StreamingTrainer

    cfg = StreamingConfig()
    print(f"stream train: streams cut from StreamingConfig()'s "
          f"{cfg.streams} to {STREAMS}; scenarios {cfg.scenarios}, "
          f"{cfg.num_jobs} jobs, horizon {cfg.horizon}, warm-up "
          f"{cfg.warmup_windows} windows")
    tr = StreamingTrainer(cfg, device=dev)
    pm.launches = 0
    t0 = time.perf_counter()
    eps = tr.train(streams=STREAMS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = pm.launches
    for e in eps:
        print(f"stream train: {e.scenario} steps={e.steps} "
              f"windows={e.windows} reward_sum={e.reward_sum:+.6f} "
              f"loss={e.loss:+.6f} updated={e.updated} terminal={e.terminal}")
    steps = sum(e.steps for e in eps)
    check(eps and all(np.isfinite(e.reward_sum) and np.isfinite(e.loss)
                      for e in eps), "stream train: non-finite reward or loss")
    check(any(e.updated for e in eps), "stream train: no update ran")
    check(train_launches >= steps > 0,
          f"stream train: launches {train_launches} < steps {steps}")
    t0 = time.perf_counter()
    ev = tr.evaluate(("flash-crowd",), baselines=("fcfs",))
    eval_wall = time.perf_counter() - t0
    check(all(m["completed"] == cfg.num_jobs and
              all(np.isfinite(v) for v in m.values())
              for m in ev["flash-crowd"].values()),
          f"stream evaluate: {ev}")
    print(f"stream train: {len(eps)} episodes, {steps} steps, wall_s="
          f"{wall:.3f}, policy_mlp launches {train_launches}; evaluate "
          f"flash-crowd wall_s={eval_wall:.3f}: " + json.dumps(ev))

    jobs = generate_trace("helios", LIVE_JOBS, seed=9)
    sla_user = jobs[10].user
    behind = [0]
    rankings = [0]
    real_rank = live.LivePrioritizer.rank

    def rank(self, q, cluster, now):
        order = real_rank(self, q, cluster, now)
        flags = [q[i].user == sla_user for i in order]
        behind[0] += int(flags != sorted(flags, reverse=True))
        rankings[0] += 1
        return order
    live.LivePrioritizer.rank = rank
    pm.launches = 0
    try:
        t0 = time.perf_counter()
        res, rescans = live.run_live(
            make_cluster("helios"), jobs, tr.agent,
            live.LiveConfig(sla_users=frozenset({sla_user})))
        torch.cuda.synchronize()
        live_wall = time.perf_counter() - t0
    finally:
        live.LivePrioritizer.rank = real_rank
    live_launches = pm.launches
    done = sum(1 for j in res.jobs if j.finish_time >= 0)
    check(done == LIVE_JOBS, f"run_live completed {done} of {LIVE_JOBS}")
    check(rescans >= 1 and live_launches >= rescans,
          f"run_live: {rescans} rescans, {live_launches} launches")
    check(behind[0] == 0, f"run_live: {behind[0]} of {rankings[0]} rankings "
          f"put an SLA job behind a non-SLA job")
    n_sla = sum(1 for j in jobs if j.user == sla_user)
    print(f"live: helios {LIVE_JOBS} jobs seed 9, SLA user {sla_user} "
          f"({n_sla} jobs), rescan 60 s, milp: {rescans} rescans, "
          f"{rankings[0]} rankings, none with an SLA job behind a non-SLA "
          f"job; avg wait {res.avg_wait:.3f} s, decisions {res.decisions}, "
          f"policy_mlp launches {live_launches}, wall_s={live_wall:.3f}")
    return {"stream-train": train_launches, "live": live_launches}


def fleet_signature(sr):
    """``tests/test_predict.py``'s fleet signature: every completed job's
    times and restarts, and per member the decisions, MILP calls,
    backfills, reservations and overruns."""
    return job_times(sr.result.jobs), tuple(
        (e.decisions, e.milp_calls, e.backfills, e.bf_reservations,
         e.bf_overruns) for e in sr.fed.engines)


def fleet_phase(dev) -> dict:
    """19. fleet: ``run_fleet`` as an operator runs it, on the card.
    Returns the predictor kernel's {"launches", "max_abs_err"} and the
    policy kernel's launches ("policy_mlp")."""
    import numpy as np
    import torch
    from repro_torch.fed import run_fleet
    from repro_torch.kernels import ops, policy_mlp as pm, predict_mlp as qm
    from repro_torch.kernels.ref import predict_mlp_ref
    from repro_torch.predict import RuntimePredictor
    from repro_torch.scale import TargetUtilizationAutoscaler, pools_from_spec

    keys = ("w1", "b1", "w2", "b2", "w3", "b3")
    # per member: [_forward calls, seconds]; [forecasts, seconds, launches]
    forwards: list[list] = []
    forecasts: list[list] = []
    autoscalers: list = []
    record: list = []
    lock = threading.Lock()
    real_predict_mlp = ops.predict_mlp

    def tapped_predict_mlp(x, params):
        """Keeps the inputs, weights and outputs of the first
        CHECK_PREDICTS calls, from whichever member's thread."""
        out = real_predict_mlp(x, params)
        with lock:
            if len(record) < CHECK_PREDICTS:
                record.append((x.clone(), {k: params[k].clone()
                                           for k in keys}, out.clone()))
        return out

    def predictor(i, spec):
        # one predictor a member, never shared: each trains online from its
        # own engine's completions
        p = RuntimePredictor(assist=True, seed=i, device=dev)
        check(p.device.type == "cuda", f"member {i}'s predictor on {p.device}")
        forwards.append([0, 0.0])
        time_calls(p, "_forward", forwards[-1])
        return p

    def autoscaler(i, spec):
        # the autoscaling bench's target-util controller
        a = TargetUtilizationAutoscaler(
            pools_from_spec(spec, min_frac=0.25), util_low=0.6,
            util_high=0.85, max_pending_for_down=4, cooldown_s=1800.0)
        acc = [0, 0.0, 0]
        forecast = a._forecast_gpu_hours

        def counted_forecast(engine):
            # controllers tick serially at the window edge, after every
            # member's step: the launches in here are the forecast's own
            t0, n0 = time.perf_counter(), qm.launches
            try:
                return forecast(engine)
            finally:
                acc[0] += 1
                acc[1] += time.perf_counter() - t0
                acc[2] += qm.launches - n0
        a._forecast_gpu_hours = counted_forecast
        forecasts.append(acc)
        autoscalers.append(a)
        return a

    ops.predict_mlp = tapped_predict_mlp
    pm.launches = qm.launches = 0
    t0 = time.perf_counter()
    try:
        sr = run_fleet("fleet-skewed-flash", num_jobs=FLEET_JOBS, seed=0,
                       router="jsq", allocator="pack", policy="fcfs",
                       rescan_interval=60.0, parallel=True,
                       predictor_factory=predictor,
                       autoscaler_factory=autoscaler)
        torch.cuda.synchronize()
    finally:
        ops.predict_mlp = real_predict_mlp
    wall = time.perf_counter() - t0
    launches, policy_launches = qm.launches, pm.launches
    res = sr.result
    check(len(res.jobs) == FLEET_JOBS,
          f"fleet completed {len(res.jobs)} of {FLEET_JOBS} jobs")
    per_member = [n for n, _ in forwards]
    check(sum(per_member) == launches,
          f"predict_mlp launches {launches} != the members' forwards "
          f"{per_member} (sum {sum(per_member)})")
    check(min(per_member) > 0, f"a member launched no predictor kernel: "
          f"{per_member}")
    errors = [e for eng in sr.fed.engines for h in eng.hooks
              for e in getattr(h, "errors", [])]
    check(not errors, f"hooks raised in the fleet: {errors[:3]}")
    waits = np.array([j.wait_time for j in res.jobs])
    fwd_s = sum(s for _, s in forwards)
    print(f"fleet: fleet-skewed-flash {FLEET_JOBS} jobs seed 0, jsq, pack, "
          f"fcfs, rescan 60 s, parallel members, assisted predictors and "
          f"target-util autoscalers on every member: completed="
          f"{len(res.jobs)} windows={sr.windows} wall_s={wall:.3f} "
          f"routed={list(res.routed)} wait_p50_h={res.wait_p50 / 3600.0:.4f} "
          f"wait_p99_h={res.wait_p99 / 3600.0:.4f} "
          f"jct_p99_h={res.jct_p99 / 3600.0:.4f} "
          f"utilization={res.utilization:.4f} fairness={res.fairness:.4f} "
          f"(mean wait {float(waits.mean()) / 3600.0:.4f} h)")
    for i, (eng, a) in enumerate(zip(sr.fed.engines, autoscalers)):
        name = sr.fed.infos[i].name
        print(f"fleet: member {i} {name}: decisions={eng.decisions} "
              f"backfills={eng.backfills} bf_reservations="
              f"{eng.bf_reservations} bf_overruns={eng.bf_overruns} "
              f"scale_events={len(a.events)} {a.event_counts()} "
              f"forecasts={forecasts[i][0]} (launching "
              f"{forecasts[i][2]}) predict_mlp_launches="
              f"{per_member[i]} forward_s={forwards[i][1]:.3f} "
              f"mape={sr.fed.predictors[i].mape():.6f}")
    print(f"fleet: predict_mlp launches {launches} (members "
          f"{'+'.join(map(str, per_member))}), policy_mlp launches "
          f"{policy_launches}; the predictors' _forward {fwd_s:.3f} s "
          f"summed over members, {100.0 * fwd_s / wall:.1f}% of the wall; "
          f"autoscaler forecasts {sum(f[0] for f in forecasts)} in "
          f"{sum(f[1] for f in forecasts):.3f} s, launching "
          f"{sum(f[2] for f in forecasts)}")

    worst = 0.0
    with torch.no_grad():
        for x, params, out in record:
            plain = predict_mlp_ref(x, *(params[k] for k in keys))
            worst = max(worst, (out - plain).abs().max().item())
    check(len(record) == min(CHECK_PREDICTS, launches),
          f"recorded {len(record)} predictor calls")
    check(worst <= ATOL, f"fleet predictor outputs vs plain: max abs err "
          f"{worst:.3e}")
    rows = [x.shape[0] for x, _, _ in record]
    print(f"fleet check: the first {len(record)} predictor calls (B "
          f"{min(rows)}-{max(rows)}, from every member's thread): "
          f"max_abs_err={worst:.3e}")
    return {"launches": launches, "max_abs_err": worst,
            "policy_mlp": policy_launches}


def fleet_check_phase(card) -> dict:
    """20. fleet check: a small fleet with both kernels in its members, on
    the card in parallel and serially and on the CPU.  Returns the card's
    parallel run's launches {"policy_mlp", "predict_mlp"}."""
    import torch
    from repro_torch.core import PPOAgent, RLPrioritizer
    from repro_torch.core.policies import make_policy
    from repro_torch.core.prioritizer import PolicyPrioritizer
    from repro_torch.fed import get_fleet_scenario, run_fleet
    from repro_torch.kernels import policy_mlp as pm, predict_mlp as qm
    from repro_torch.kernels.batch_score import BucketedScorer
    from repro_torch.predict import RuntimePredictor
    from repro_torch.sched import wrap_tenancy

    run = get_fleet_scenario("fleet-skewed-flash").build(FLEET_CHECK_JOBS, 3)

    def fleet(device, parallel, predictors="assisted", actor=True):
        # member 0 owns its agent and acts greedily (explore=False reads
        # the weights and nothing else of the agent), so the member's
        # worker thread shares no mutable state with the others
        kind = torch.device(device).type
        agent = PPOAgent(device=device) if actor else None
        if agent is not None:
            check(agent.device.type == kind, f"agent on {agent.device}")

        def prioritizer(i):
            base = RLPrioritizer(agent, explore=False,
                                 deep_scorer=BucketedScorer(
                                     agent.params["actor"])) \
                if i == 0 and agent is not None \
                else PolicyPrioritizer(make_policy("fcfs"))
            return wrap_tenancy(base, run.sla_users, run.vc_quotas)

        def predictor(i, spec):
            p = RuntimePredictor(assist=predictors == "assisted", seed=i,
                                 device=device)
            check(p.device.type == kind,
                  f"member {i}'s predictor on {p.device}")
            return p
        before = (pm.launches, qm.launches)
        t0 = time.perf_counter()
        sr = run_fleet(run, parallel=parallel, prioritizer_factory=prioritizer,
                       predictor_factory=predictor if predictors else None)
        if kind == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return sr, (pm.launches - before[0], qm.launches - before[1])

    walls: list[float] = []
    pm.launches = qm.launches = 0
    par, used = fleet(card, True)
    serial, _ = fleet(card, False)
    cpu, _ = fleet("cpu", False)
    got, want = fleet_signature(par), fleet_signature(serial)
    check(got == want, f"fleet-skewed-flash {FLEET_CHECK_JOBS}: the card's "
          f"parallel run {got[1]} != its serial run {want[1]}")
    check(want == fleet_signature(cpu), f"fleet-skewed-flash "
          f"{FLEET_CHECK_JOBS}: the card {want[1]} != the CPU "
          f"{fleet_signature(cpu)[1]}")
    check(min(used) > 0, f"fleet check launches on the card {used}")
    check(sum(e[3] for e in got[1]) > 0, "fleet check: no reservation")
    shadow, _ = fleet(card, True, predictors="shadow", actor=False)
    none, _ = fleet(card, True, predictors=None, actor=False)
    check(fleet_signature(shadow) == fleet_signature(none),
          "fleet check: the shadow predictors on the card changed the fleet")
    print(f"fleet check: fleet-skewed-flash {FLEET_CHECK_JOBS} jobs seed 3, "
          f"greedy actor + deep scorer on member 0, assisted predictors on "
          f"all: card parallel == card serial == CPU, per member (decisions, "
          f"milp_calls, backfills, reservations, overruns) {got[1]}; "
          f"launches in the parallel run policy_mlp={used[0]} "
          f"predict_mlp={used[1]}; shadow predictors on the card == no "
          f"predictor {fleet_signature(none)[1]}")
    print(f"fleet check: wall_s card parallel={walls[0]:.3f} card serial="
          f"{walls[1]:.3f} CPU serial={walls[2]:.3f} shadow={walls[3]:.3f} "
          f"none={walls[4]:.3f}")
    return {"policy_mlp": used[0], "predict_mlp": used[1]}


def control_plane_phase(dev) -> dict:
    """21. control plane: SLO lanes and elastic gangs with the predictor,
    the actor and the observability bundle on the card; then a migrating
    fleet.  Returns the stream's launches {"policy_mlp", "predict_mlp"}."""
    import torch
    from repro_torch.core import PPOAgent, RLPrioritizer
    from repro_torch.fed import run_fleet
    from repro_torch.kernels import policy_mlp as pm, predict_mlp as qm
    from repro_torch.kernels.batch_score import BucketedScorer
    from repro_torch.lifecycle import (ElasticGangPolicy, PreemptionController,
                                       QueueImbalanceMigration,
                                       SloDeadlinePolicy)
    from repro_torch.obs import Observability, validate_trace
    from repro_torch.obs.report import analyze
    from repro_torch.predict import RuntimePredictor
    from repro_torch.sched import run_scenario

    agent = PPOAgent(device=dev)
    pred = RuntimePredictor(assist=True, seed=0, device=dev)
    check(agent.device.type == "cuda" and pred.device.type == "cuda",
          f"agent on {agent.device}, predictor on {pred.device}")
    ctl = PreemptionController([SloDeadlinePolicy(), ElasticGangPolicy()])
    obs = Observability(name="slo-lanes")
    pri = RLPrioritizer(agent, explore=False,
                        deep_scorer=BucketedScorer(agent.params["actor"]))
    pm.launches = qm.launches = 0
    t0 = time.perf_counter()
    sr = run_scenario("slo-lanes", num_jobs=CONTROL_JOBS, seed=0,
                      prioritizer=pri, allocator="pack", rescan_interval=60.0,
                      sample_interval=3600.0, preemption=ctl, obs=obs,
                      predictor=pred)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    used = {"policy_mlp": pm.launches, "predict_mlp": qm.launches}
    jobs = sr.batch.jobs
    check(len(jobs) == CONTROL_JOBS,
          f"slo-lanes completed {len(jobs)} of {CONTROL_JOBS}")
    check(min(used.values()) > 0, f"slo-lanes launches {used}")
    counts = ctl.event_counts()
    check(counts.get("preempt", 0) > 0, f"no preemption: {counts}")
    dl = [j for j in jobs if j.has_deadline]
    hit = sum(1 for j in dl if j.finish_time <= j.deadline) / max(len(dl), 1)
    doc = obs.trace_document()
    problems = validate_trace(doc)
    check(problems == [], f"the trace does not validate: {problems[:3]}")
    model = analyze(doc)
    check(sum(model["path_counts"].values()) == sr.engine.decisions,
          f"analyze counts {sum(model['path_counts'].values())} decisions, "
          f"the engine {sr.engine.decisions}")
    prom = obs.prometheus()
    for name in ("repro_prediction_mape", "repro_preemptions_total"):
        check(name in prom, f"{name} missing from the Prometheus text")
    print(f"control plane: slo-lanes {CONTROL_JOBS} jobs seed 0, pack, "
          f"rescan 60 s, slo+elastic controller, greedy actor + deep scorer "
          f"+ assisted predictor, observability on: wall_s={wall:.3f} "
          f"windows={sr.windows} deadline_hit_rate={hit:.4f} "
          f"({len(dl)} deadline jobs) events {counts} "
          f"preemptions={sr.engine.preemptions} decisions="
          f"{sr.engine.decisions} launches policy_mlp={used['policy_mlp']} "
          f"predict_mlp={used['predict_mlp']}; trace {len(doc['traceEvents'])}"
          f" events valid, analyze: {len(model['jobs'])} job tracks, "
          f"{model['blocked_windows']} blocked windows; Prometheus "
          f"{len(prom.splitlines())} lines with repro_prediction_mape and "
          f"repro_preemptions_total")

    mig = QueueImbalanceMigration(min_advantage=2, max_moves_per_window=8)
    t0 = time.perf_counter()
    fr = run_fleet("fleet-fault-migration", num_jobs=MIGRATION_JOBS, seed=1,
                   router="jsq", allocator="pack", rescan_interval=300.0,
                   migration=mig)
    mig_wall = time.perf_counter() - t0
    check(len(fr.result.jobs) == MIGRATION_JOBS,
          f"fleet-fault-migration completed {len(fr.result.jobs)}")
    check(fr.fed.migrations, "fleet-fault-migration: no migration")
    print(f"control plane: fleet-fault-migration {MIGRATION_JOBS} jobs seed "
          f"1, jsq, pack, rescan 300 s, QueueImbalanceMigration(2, 8): "
          f"migrations={len(fr.fed.migrations)} routed="
          f"{list(fr.result.routed)} wall_s={mig_wall:.3f}")
    return used


# ------------------------------------------------------ LM training slice --
# phase 22: granite-moe-1b-a400m at every published width and all 24 layers
# (the config the reference's own train_loop test trains), bf16 params, f32
# Adam moments, the plain path with full remat, at train_4k's 4,096-token
# sequences with the global batch cut from 256 to 4
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_SEQ = 4096
TRAIN_BATCH = 4
TRAIN_STEPS = 12
TRAIN_LR = 3e-4                  # train_loop's default
PREEMPT_AT = 8                   # run B is killed when step 9 asks for data
CKPT_EVERY = 4
LOSS_CHUNK = 1024                # 4 chunks of (4, 1024, 49,408) f32 logits
# Run C restores B's step-8 checkpoint (bit for bit, checked) and trains on
# A's card, data and schedule; torch.use_deterministic_algorithms stays off
# (the path's scatter-adds are index_put_(accumulate=True), sort-based on
# CUDA, its GEMMs cuBLAS's), so C's losses are held to A's steps 9-12
# within RESUME_RTOL of A's: one bf16 ulp of a weight is 2^-8 of it, and a
# flipped rounding in a few weights moves a ~10 loss far less than 1e-3.
RESUME_RTOL = 1e-3
# phase 23: the smoke config in f32, one train step on the card against the
# CPU (TF32 off on both: IEEE f32 in other orders of sums): the loss within
# 1e-5 (~20 ulps of a ~6.3 loss); each gradient leaf within 2e-4 of its
# largest CPU entry (moving every weight by one ulp moves the CPU's own
# gradients by 1.5e-4 of that, tests/test_torch_lm_train.py); after AdamW
# every parameter within 2 lr and all but a 5e-3 fraction within 1e-6
# (Adam's first step moves an entry by lr * g / (|g| + eps), so where a
# gradient is within a few eps of zero its rounding moves the step by up
# to lr: 9.7e-4 of the entries on the card)
TRAIN_CHECK_SEQ = 64
TRAIN_CHECK_LOSS_TOL = 1e-5
TRAIN_CHECK_GRAD_RTOL = 2e-4
TRAIN_CHECK_STEP_ATOL = 1e-6
TRAIN_CHECK_FRACTION = 5e-3
# then the trained full-width weights served: 4 prompts of 512 tokens from
# the training stream, 16 new tokens, all 24 layers through the kernel
# path.  The seeded model (the reference's init rule) is chaotic in depth:
# on the card, moving layer 0's wq by one bf16 ulp moves the plain path's
# own prefill logits by 0.07 of their RMS at 2 layers, 0.45 at 3 and 1.29
# at 24.  So the paths are held layer by layer on the plain path's input,
# each layer's update within LAYER_RTOL of its RMS (~2.5 bf16 ulps;
# 0.0008-0.0019 over the 24 seeded layers), and end to end on the trained
# model cut to its first SERVE_CHECK_LAYERS layers at phase 15's
# tolerances, as phase 15 cuts its model
SERVE_PROMPT = 512
SERVE_NEW = 16
LAYER_RTOL = 1e-2
SERVE_CHECK_LAYERS = 2


class Preempted(Exception):
    """Raised into ``train_loop`` to stop it as a killed job."""


def run_preempted(train_mod, at: int, **kwargs):
    """``train_mod.train_loop(**kwargs)`` killed when step ``at`` asks for
    its batch (every checkpoint up to step ``at`` written: ``train_loop``
    waits for its writer on the way out).  Returns the tree it handed to its
    checkpoint manager at step ``at``: the state it held on the card when
    it died, no step having run since."""
    real_ds, real_mgr = train_mod.SyntheticLMDataset, train_mod.CheckpointManager
    held = {}

    class Killed(real_ds):
        def batch_at(self, step):
            if step == at:
                raise Preempted(step)
            return super().batch_at(step)

    class Holding(real_mgr):
        def maybe_save(self, step, tree):
            if step == at:
                held["tree"] = tree
            return super().maybe_save(step, tree)

    train_mod.SyntheticLMDataset, train_mod.CheckpointManager = Killed, Holding
    try:
        train_mod.train_loop(**kwargs)
    except Preempted:
        pass
    else:
        check(False, f"the run was not preempted at step {at}")
    finally:
        train_mod.SyntheticLMDataset, train_mod.CheckpointManager = \
            real_ds, real_mgr
    check("tree" in held, f"no checkpoint was taken at step {at}")
    return held["tree"]


def run_restart(train_mod, held, **kwargs):
    """``train_mod.train_loop(**kwargs)`` restarting from its checkpoint
    directory, with the tree its manager restores compared, before any
    step runs, with ``held`` (the killed run's state) leaf by leaf.
    Returns (the run's result, {step, leaves, same, bytes, s})."""
    import torch
    from repro_torch.train.optimizer import tree_leaves as lm_leaves

    real_mgr = train_mod.CheckpointManager
    info = {}

    class Checked(real_mgr):
        def restore(self, target_tree, device=None, mesh=None,
                    spec_tree=None):
            t0 = time.perf_counter()
            tree, step = super().restore(target_tree, device, mesh, spec_tree)
            torch.cuda.synchronize()
            info.update(step=step, s=time.perf_counter() - t0, leaves=0,
                        same=0, bytes=0)
            for (_, a), (_, b) in zip(lm_leaves(tree), lm_leaves(held)):
                info["leaves"] += 1
                info["same"] += bool(a.dtype == b.dtype and torch.equal(a, b))
                info["bytes"] += a.numel() * a.element_size()
            return tree, step

    train_mod.CheckpointManager = Checked
    try:
        out = train_mod.train_loop(**kwargs)
    finally:
        train_mod.CheckpointManager = real_mgr
    check("step" in info, "the restart restored no checkpoint")
    return out, info


def profile_train_step(step_fn, params, opt_state, batch) -> None:
    """Device busy ms, idle share and the top kernels of one train step
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, metrics = step_fn(params, opt_state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    total = sum(t for t, _, _ in rows)
    if total <= 0:
        print("lm train profile: the profiler saw no device time "
              "(not measured)")
        return
    gemm = sum(t for t, key, _ in rows
               if any(w in key.lower() for w in ("gemm", "xmma", "cutlass",
                                                 "nvjet", "gemv")))
    print(f"lm train profile: one step: wall_ms={wall * 1e3:.3f} "
          f"device_busy_ms={total / 1e3:.3f} idle_share="
          f"{max(0.0, 1 - total / 1e3 / (wall * 1e3)):.4f} device events "
          f"{sum(n for _, _, n in rows)} gemm_ms={gemm / 1e3:.3f}"
          f"({100 * gemm / total:.1f}%)")
    for t, key, n in rows[:10]:
        print(f"lm train profile:   {t / 1e3:9.3f} ms {100 * t / total:5.1f}% "
              f"x{n:<6d} {key[:90]}")


def zlib_speeds(t, nbytes: int = 32 << 20) -> str:
    """One host core's zlib rates at levels 0 and 1 (compress, ratio,
    inflate) over the first ``nbytes`` of tensor ``t``."""
    import zlib
    raw = t.detach().reshape(-1)[:nbytes // t.element_size()].cpu().numpy().tobytes()
    parts = []
    for level in (0, 1):
        t0 = time.perf_counter()
        blob = zlib.compress(raw, level)
        t1 = time.perf_counter()
        zlib.decompress(blob)
        t2 = time.perf_counter()
        parts.append(f"level {level} {len(raw) / (t1 - t0) / 1e6:.1f} MB/s "
                     f"ratio {len(blob) / len(raw):.4f} inflate "
                     f"{len(raw) / (t2 - t1) / 1e6:.1f} MB/s")
    return (f"checkpoint codec on one host core, {len(raw) >> 20} MiB of "
            f"the embedding's f32 first moment at step {PREEMPT_AT}: "
            + "; ".join(parts))


def lm_train_phase(dev) -> tuple:
    """22. LM train: ``train_loop`` at full width on the card: run A
    uninterrupted, run B killed after step 8 (checkpoints every 4), run C
    restarted from B's directory.  Returns A's trained params and losses."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.ckpt import checkpoint as ckpt_mod
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import flash_attention as fa, moe_router as mr
    from repro_torch.kernels import policy_mlp as pm, predict_mlp as qm
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import mesh, roofline
    from repro_torch.launch import train as train_mod
    from repro_torch.models.lm import LM, ModelImpl
    from repro_torch.train import OptConfig, make_train_step

    cfg = get_config(TRAIN_ARCH)
    props = torch.cuda.get_device_properties(0)
    print(f"lm train: {props} beside the port's H100 SXM constants "
          f"PEAK_FLOPS_BF16={mesh.PEAK_FLOPS_BF16:.4g} "
          f"HBM_BW={mesh.HBM_BW:.4g} NVLINK_BW={mesh.NVLINK_BW:.4g}")
    run = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               lr=TRAIN_LR, loss_chunk=LOSS_CHUNK, log_every=4, device=dev)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    pm.launches = qm.launches = fa.launches = ss.launches = mr.launches = 0

    # run A: 12 steps uninterrupted
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_a = train_mod.train_loop(TRAIN_ARCH, **run)
    wall_a = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    params = out_a.pop("params")
    del out_a["opt_state"]
    gc.collect()
    torch.cuda.empty_cache()
    losses, gnorms = out_a["losses"], out_a["gnorms"]
    check(len(losses) == TRAIN_STEPS and out_a["start_step"] == 0,
          f"run A ran {len(losses)} steps from {out_a['start_step']}")
    check(bool(np.isfinite(losses).all() and np.isfinite(gnorms).all()),
          f"run A: non-finite loss or gnorm: {losses} {gnorms}")
    check(losses[-1] < losses[0],
          f"run A: the last loss {losses[-1]} is not below the first {losses[0]}")
    step_ms = np.asarray(out_a["step_s"]) * 1e3
    steady = step_ms[1:]
    p50 = float(np.percentile(steady, 50))
    model = LM(cfg, ModelImpl(attn="xla", ssd="xla", moe="xla",
                              loss_chunk=LOSS_CHUNK), device=dev)
    shape = ShapeConfig("train_4k_b4", TRAIN_SEQ, TRAIN_BATCH, "train")
    cost = roofline.analytic_cost(cfg, shape, chips=1, model=model)
    terms = roofline.roofline_terms(cost["flops_per_chip"],
                                    cost["hbm_bytes_per_chip"], 0.0)
    bound_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
    mflops = roofline.model_flops(cfg, shape, model.active_param_count())
    print(f"lm train: {TRAIN_ARCH} at full width ({cfg.num_layers} layers, "
          f"d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"{cfg.num_experts} experts top-{cfg.experts_per_token}), "
          f"{model.param_count() / 1e9:.4f} B params "
          f"({model.active_param_count() / 1e9:.4f} B active), {cfg.dtype} "
          f"params + f32 moments, plain path, remat full, loss_chunk "
          f"{LOSS_CHUNK}; seq {TRAIN_SEQ}, batch {TRAIN_BATCH} (train_4k's "
          f"256 cut to {TRAIN_BATCH}), {TRAIN_STEPS} steps, lr 3e-4")
    print(f"lm train: run A losses {[round(x, 5) for x in losses]} first "
          f"{losses[0]:.5f} last {losses[-1]:.5f} finite; gnorms "
          f"{[round(x, 4) for x in gnorms]}")
    print(f"lm train: run A wall_s={wall_a:.3f} step_ms first={step_ms[0]:.1f} "
          f"p50={p50:.1f} p99={np.percentile(steady, 99):.1f} (steps 2-"
          f"{TRAIN_STEPS}, host clock, each ending in the loss read) "
          f"tokens_per_s={TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:.1f} "
          f"max_memory_allocated_GiB={peak / 2**30:.3f}")
    print(f"lm train: analytic step (launch.roofline, chips 1): "
          f"flops={cost['flops_global']:.4g} hbm_bytes="
          f"{cost['hbm_bytes_per_chip']:.4g} compute_ms="
          f"{terms['compute_s'] * 1e3:.3f} memory_ms="
          f"{terms['memory_s'] * 1e3:.3f} bound_ms={bound_ms:.3f} "
          f"({terms['dominant']}); step p50 / bound = {p50 / bound_ms:.2f}; "
          f"model_flops={mflops:.4g} MFU={mflops / (p50 / 1e3 * 989e12):.4f} "
          "(against 989 TFLOP/s)")

    # run B: the same run killed after step 8, checkpoints every 4
    t0 = time.perf_counter()
    held = run_preempted(train_mod, PREEMPT_AT, arch=TRAIN_ARCH,
                         ckpt_dir=str(ckpt_dir), ckpt_interval=CKPT_EVERY,
                         **run)
    wall_b = time.perf_counter() - t0
    on_disk = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file())
    kept = sorted(d.name for d in ckpt_dir.iterdir())
    codec_line = zlib_speeds(held["opt"]["m"]["embed"]["table"])
    print(f"lm train: {codec_line}")
    print(f"lm train: run B killed after step {PREEMPT_AT} in "
          f"{wall_b:.3f} s (2 checkpoints written: {kept}, "
          f"{on_disk / 1e9:.3f} GB on disk, zlib level "
          f"{ckpt_mod.ZLIB_LEVEL})")

    # run C: the restart, its restored state held to B's
    t0 = time.perf_counter()
    out_c, restore = run_restart(train_mod, held, arch=TRAIN_ARCH,
                                 ckpt_dir=str(ckpt_dir),
                                 ckpt_interval=CKPT_EVERY, **run)
    wall_c = time.perf_counter() - t0
    del held
    gc.collect()
    torch.cuda.empty_cache()
    check(restore["step"] == PREEMPT_AT and restore["same"] == restore["leaves"],
          f"restore of step {restore['step']}: {restore['same']} of "
          f"{restore['leaves']} leaves bit-equal to B's state")
    print(f"lm train: run C restored step {restore['step']} onto the card "
          f"in {restore['s']:.3f} s ({restore['bytes'] / 1e9:.3f} GB): "
          f"params, m, v and step equal B's state at step {PREEMPT_AT} bit "
          f"for bit ({restore['same']} of {restore['leaves']} leaves)")
    c_losses = out_c["losses"]
    check(out_c["start_step"] == PREEMPT_AT
          and len(c_losses) == TRAIN_STEPS - PREEMPT_AT,
          f"run C resumed at {out_c['start_step']} and ran {len(c_losses)} "
          "steps")
    check(bool(np.isfinite(c_losses).all() and np.isfinite(out_c["gnorms"]).all()),
          f"run C: non-finite loss or gnorm {c_losses} {out_c['gnorms']}")
    diffs = [abs(c - a) for c, a in zip(c_losses, losses[PREEMPT_AT:])]
    check(all(d <= RESUME_RTOL * abs(a)
              for d, a in zip(diffs, losses[PREEMPT_AT:])),
          f"run C's losses {c_losses} vs A's {losses[PREEMPT_AT:]}")
    print(f"lm train: run C resumed at step {out_c['start_step']} and ran "
          f"{len(c_losses)} steps in {wall_c:.3f} s: losses "
          f"{[round(x, 5) for x in c_losses]} vs A's "
          f"{[round(x, 5) for x in losses[PREEMPT_AT:]]}: max abs diff "
          f"{max(diffs):.3e} ({'bit-identical' if max(diffs) == 0 else 'not bit-identical'}"
          f"; tolerance {RESUME_RTOL} relative; deterministic algorithms off)")
    launched = {"policy_mlp": pm.launches, "predict_mlp": qm.launches,
                "flash_attention": fa.launches, "ssd_scan": ss.launches,
                "moe_router": mr.launches}
    check(not any(launched.values()),
          f"the training path launched a kernel: {launched}")
    print(f"lm train: the three runs launched none of the five kernels "
          f"{launched} (training runs the plain path, as the reference)")

    # one profiled step on C's final state
    ds = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in ds.batch_at(TRAIN_STEPS).items()}
    step_fn = make_train_step(model, OptConfig(
        lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 10, 5),
        total_steps=TRAIN_STEPS))
    profile_train_step(step_fn, out_c["params"], out_c["opt_state"], batch)
    del out_c, batch
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return params, losses


def lm_grads(model, params, batch) -> list:
    """[loss, gradient of every leaf] by autograd."""
    import torch
    from repro_torch.train.optimizer import tree_leaves as lm_leaves
    leaves = [t for _, t in lm_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = model.loss(params, batch)
        return [loss.detach()] + list(torch.autograd.grad(loss, leaves))
    finally:
        for t in leaves:
            t.requires_grad_(False)


def lm_train_check_phase(dev, params) -> dict:
    """23. train check: a smoke-config train step on the card against the
    CPU; then phase 22's trained weights served through the kernel path and
    the plain path.  Returns the serve check's kernel launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import flash_attention as fa, moe_router as mr
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import build_model
    from repro_torch.models.lm import LM, ModelImpl
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import OptConfig, make_train_step, opt_init
    from repro_torch.train.optimizer import map_tree
    from repro_torch.train.optimizer import tree_leaves as lm_leaves

    cfg = dataclasses.replace(get_config(TRAIN_ARCH, smoke=True),
                              dtype=torch.float32)
    plain = ModelImpl(attn="xla", ssd="xla", moe="xla")
    models = {d: LM(cfg, plain, device=d) for d in ("cpu", dev)}
    p_cpu = models["cpu"].init(0)
    hb = SyntheticLMDataset(cfg.vocab_size, TRAIN_CHECK_SEQ, 4,
                            seed=0).batch_at(0)
    batches = {d: {k: torch.from_numpy(v).to(d) for k, v in hb.items()}
               for d in ("cpu", dev)}
    g = {d: lm_grads(models[d], map_tree(lambda t: t.to(d), p_cpu),
                     batches[d]) for d in ("cpu", dev)}
    loss_err = abs(float(g[dev][0]) - float(g["cpu"][0]))
    check(loss_err <= TRAIN_CHECK_LOSS_TOL,
          f"train check: loss {float(g[dev][0])} vs CPU {float(g['cpu'][0])}")
    grad_err = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(g[dev][1:], g["cpu"][1:]))
    check(grad_err <= TRAIN_CHECK_GRAD_RTOL,
          f"train check: gradients {grad_err:.3e} of a leaf's largest")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    notes = []
    for mb in (1, 2):
        out = {}
        for d in ("cpu", dev):
            p = map_tree(lambda t: t.to(d, copy=True), p_cpu)
            out[d] = make_train_step(models[d], opt, microbatches=mb)(
                p, opt_init(p), batches[d])
        m_card, m_cpu = out[dev][2], out["cpu"][2]
        check(abs(float(m_card["loss"]) - float(m_cpu["loss"]))
              <= TRAIN_CHECK_LOSS_TOL,
              f"train check mb {mb}: loss {float(m_card['loss'])} vs "
              f"{float(m_cpu['loss'])}")
        gn = abs(float(m_card["gnorm"]) - float(m_cpu["gnorm"])) \
            / float(m_cpu["gnorm"])
        check(gn <= TRAIN_CHECK_GRAD_RTOL, f"train check mb {mb}: gnorm {gn}")
        lr = float(m_cpu["lr"])
        loose = total = 0
        worst = 0.0
        for (path, a), (_, b) in zip(lm_leaves(out[dev][0]),
                                     lm_leaves(out["cpu"][0])):
            diff = (a.cpu() - b).abs()
            worst = max(worst, float(diff.max()))
            check(bool((diff <= 2 * lr + TRAIN_CHECK_STEP_ATOL).all()),
                  f"train check mb {mb}: {path} moved {float(diff.max())}")
            loose += int((diff > TRAIN_CHECK_STEP_ATOL).sum())
            total += diff.numel()
        check(loose <= TRAIN_CHECK_FRACTION * total,
              f"train check mb {mb}: {loose} of {total} beyond "
              f"{TRAIN_CHECK_STEP_ATOL}")
        notes.append(f"mb {mb}: loss {float(m_card['loss']):.7f} vs "
                     f"{float(m_cpu['loss']):.7f}, gnorm rel diff {gn:.2e}, "
                     f"params max diff {worst:.3e} ({loose} of {total} "
                     f"beyond {TRAIN_CHECK_STEP_ATOL})")
    print(f"lm train check: {cfg.name} in f32, batch 4 x {TRAIN_CHECK_SEQ}, "
          f"the card against the CPU: loss diff {loss_err:.2e}, gradients "
          f"within {grad_err:.3e} of each leaf's largest; one step " +
          "; ".join(notes))

    # the trained full-width weights served, kernel path then plain path
    full = get_config(TRAIN_ARCH)
    toks = SyntheticLMDataset(full.vocab_size, SERVE_PROMPT, LM_BATCH,
                              seed=0).batch_at(10_000)["tokens"]
    prompts = [[int(t) for t in row] for row in toks]
    model = build_model(full, device=dev)
    max_len = SERVE_PROMPT + SERVE_NEW
    engine = ServeEngine(model, params, batch_size=LM_BATCH, max_len=max_len,
                         device=dev)
    rec = tap_engine(engine, SERVE_NEW)
    fa.launches = ss.launches = mr.launches = 0
    t0 = time.perf_counter()
    done = engine.run([Request(req_id=i, prompt=p, max_new_tokens=SERVE_NEW)
                       for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches, "moe_router": mr.launches}
    want = {"flash_attention": full.num_layers,
            "moe_router": full.num_layers * SERVE_NEW}
    check(launches == want and ss.launches == 0,
          f"serve check launches {launches} (ssd {ss.launches}), expected "
          f"{want}")
    check(all(len(r.output) == SERVE_NEW for r in done),
          "not every request got its tokens")
    check(rec["nonfinite"] == 0, f"{rec['nonfinite']} non-finite logits")
    print(f"lm train check: the trained {TRAIN_ARCH} served {LM_BATCH} "
          f"prompts of {SERVE_PROMPT} tokens from the training stream, "
          f"{SERVE_NEW} new tokens, through the kernel path in {wall:.3f} s "
          f"(prefill {rec['prefill_s'][0] * 1e3:.2f} ms, decode "
          f"{np.mean(rec['decode_s']) * 1e3:.3f} ms a step): launches "
          f"{launches} (expected {want}); first outputs "
          f"{[r.output[:8] for r in done[:2]]}")
    cut = dataclasses.replace(full, num_layers=SERVE_CHECK_LAYERS)
    p_cut = {**params, "blocks": params["blocks"][:SERVE_CHECK_LAYERS]}
    engine = ServeEngine(build_model(cut, device=dev), p_cut,
                         batch_size=LM_BATCH, max_len=max_len, device=dev)
    rec = tap_engine(engine, SERVE_NEW)
    done = engine.run([Request(req_id=i, prompt=p, max_new_tokens=SERVE_NEW)
                       for i, p in enumerate(prompts)])
    plain_path_check(cut, p_cut, prompts, SERVE_NEW, done, rec, max_len, dev,
                     f"lm train check: serve cut to {SERVE_CHECK_LAYERS} "
                     "layers")
    layerwise_check(full, params, torch.tensor(prompts, device=dev), dev)
    return launches


def layerwise_check(cfg, params, toks, dev) -> None:
    """Prefill layer by layer on the plain path's hidden states: each
    layer's update through the kernel path within LAYER_RTOL (RMS) of the
    plain path's; then, to show why the paths are not held end to end at
    full depth, the prefill logits of the kernel path against the plain
    path and of the plain path against itself with layer 0's wq moved by
    one bf16 ulp, at SERVE_CHECK_LAYERS and at every layer."""
    import dataclasses
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.lm import ModelImpl

    def rel(a, b):
        return float((a.float() - b.float()).pow(2).mean().sqrt()
                     / b.float().pow(2).mean().sqrt())

    plain = ModelImpl(attn="xla", ssd="xla", moe="xla")
    kernel, xla = build_model(cfg, device=dev), build_model(cfg, impl=plain,
                                                           device=dev)
    rels = []
    with torch.inference_mode():
        h = xla._embed_in(params, toks)
        for p in params["blocks"]:
            hk, _ = kernel.blocks[0].prefill(p, h)
            hp, _ = xla.blocks[0].prefill(p, h)
            rels.append(rel(hk.float() - h.float(), hp.float() - h.float()))
            h = hp
        check(max(rels) <= LAYER_RTOL,
              f"layer by layer: kernel vs plain path {max(rels):.4f} > "
              f"{LAYER_RTOL}")
        notes = []
        for n in (SERVE_CHECK_LAYERS, cfg.num_layers):
            cut = dataclasses.replace(cfg, num_layers=n)
            p = {**params, "blocks": params["blocks"][:n]}
            moved = {**p, "blocks": [{**p["blocks"][0], "attn": {
                **p["blocks"][0]["attn"],
                "wq": (p["blocks"][0]["attn"]["wq"].float()
                       * (1 + 2.0 ** -8)).to(cfg.dtype)}}] + p["blocks"][1:]}
            xm = build_model(cut, impl=plain, device=dev)
            lk = build_model(cut, device=dev).prefill(p, toks)[0][:, :cfg.vocab_size]
            lx = xm.prefill(p, toks)[0][:, :cfg.vocab_size]
            ly = xm.prefill(moved, toks)[0][:, :cfg.vocab_size]
            notes.append(f"{n} layers: kernel vs plain {rel(lk, lx):.4f}, "
                         f"plain vs plain with wq0 one bf16 ulp up "
                         f"{rel(ly, lx):.4f}")
    print(f"lm train check: layer by layer on the plain path's input, each "
          f"layer's update through the kernel path within "
          f"{max(rels):.4f} (RMS, relative; tolerance {LAYER_RTOL}) of the "
          f"plain path's: {' '.join(f'{r:.4f}' for r in rels)}; prefill "
          f"logits relative RMS, " + "; ".join(notes))


# phase 24: distribution on the one card.  (a) a world of 1 over NCCL, the
# 1x1 host mesh: phase 22's cell through train_loop(mesh=...), DIST_STEPS
# steps, a checkpoint written from the DTensors after the last, restored
# onto the mesh; the dry run of the same cell on a 1x1 fake mesh; the GPipe
# schedule.  (b) four ranks on the card over gloo: the int8 compressed
# all-reduce on CUDA tensors.  No backend takes point-to-point between ranks
# that share one card (NCCL refuses two ranks on one device; gloo's send and
# recv hand the tensor's pointer to its TCP transport, which reads host
# memory), so the pipeline runs at world 1 over NCCL, one stage applying
# all S layers: decided here, not by a fallback at run time.
DIST_STEPS = 2
DIST_CKPT = ROOT / "build" / "chip_smoke_dist_ckpt"
DIST_LOSS_RTOL = 1e-6
GLOO_WORLD = 4
PIPE_S, PIPE_M, PIPE_MB, PIPE_L, PIPE_D = 4, 8, 2, 4, 16
PIPE_ATOL = 1e-5
# phase 25: platform jobs (core.costmodel) through the greedy loop on the
# platform example's cluster (examples/cluster_failover.py: helios)
PLATFORM_JOBS = 2048
PLATFORM_SMALL = 96
PLATFORM_CLUSTER = "helios"


def run_ranks(phase: str, out: Path, world: int, timeout: int) -> None:
    """``python chip_smoke.py --phase PHASE OUT`` in ``world`` processes
    (RANK / WORLD_SIZE set, rendezvous on localhost); each must exit 0."""
    from repro_torch.launch.ranks import run_ranks as launch
    rcs = [rc for rc, _ in launch([sys.executable, str(ROOT / "chip_smoke.py"),
                                   "--phase", phase, str(out)], world,
                                  timeout=timeout)]
    check(all(rc == 0 for rc in rcs), f"phase {phase}: ranks exited {rcs}")


def compress_inputs(world: int):
    import numpy as np
    x = np.arange(world * 8, dtype=np.float32).reshape(world, 8)
    g = np.random.default_rng(3).standard_normal((world, 4096)).astype(
        np.float32)
    return x, g


def nccl1_rank(out: Path) -> None:
    """24 (a), the world-1 NCCL process."""
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models.lm import LM, ModelImpl
    from repro_torch.sharding.specs import DEFAULT_RULES
    from repro_torch.train.optimizer import tree_leaves as lm_leaves
    from repro_torch.train.pipeline import make_pipelined_apply
    from repro_torch.train.step import sharded_specs

    torch.cuda.set_device(0)
    dist.init_process_group("nccl")
    res: dict = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    mesh = make_host_mesh()
    print(f"dist: world {res['world']} over {res['backend']}, mesh "
          f"{tuple(mesh.shape)} {mesh.mesh_dim_names} on {mesh.device_type}",
          flush=True)
    shutil.rmtree(DIST_CKPT, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_a = train_loop(TRAIN_ARCH, steps=DIST_STEPS, batch=TRAIN_BATCH,
                       seq=TRAIN_SEQ, lr=TRAIN_LR, loss_chunk=LOSS_CHUNK,
                       log_every=1, ckpt_dir=str(DIST_CKPT),
                       ckpt_interval=DIST_STEPS, mesh=mesh)
    res["train_s"] = time.perf_counter() - t0
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["losses"] = out_a["losses"]
    res["step_s"] = out_a["step_s"]
    params, opt = out_a["params"], out_a["opt_state"]
    leaves = [t for _, t in lm_leaves({"params": params, "opt": opt})]
    check(all(isinstance(t, DTensor) for t in leaves),
          "the sharded run's state is not all DTensors")
    res["param_bytes"] = sum(t.to_local().numel() * t.element_size()
                             for _, t in lm_leaves(params))
    res["opt_bytes"] = sum(t.to_local().numel() * t.element_size()
                           for _, t in lm_leaves(opt))
    # the step-2 checkpoint, written from the DTensors, restored onto the mesh
    model = LM(get_config(TRAIN_ARCH), ModelImpl(attn="xla", ssd="xla",
               moe="xla", loss_chunk=LOSS_CHUNK), device=mesh.device_type,
               rules=DEFAULT_RULES)
    pspecs, ospecs = sharded_specs(model, mesh)
    t0 = time.perf_counter()
    got, at = load_checkpoint(str(DIST_CKPT), {"params": params, "opt": opt},
                              mesh=mesh, spec_tree={"params": pspecs,
                                                    "opt": ospecs})
    torch.cuda.synchronize()
    res["restore_s"] = time.perf_counter() - t0
    res["restore_step"] = at
    pairs = list(zip(lm_leaves(got), lm_leaves({"params": params, "opt": opt})))
    res["restore_leaves"] = len(pairs)
    res["restore_same"] = sum(
        bool(isinstance(a, DTensor) and a.placements == b.placements
             and a.dtype == b.dtype and torch.equal(a.to_local(), b.to_local()))
        for (_, a), (_, b) in pairs)
    res["ckpt_bytes"] = sum(f.stat().st_size for f in DIST_CKPT.rglob("*")
                            if f.is_file())
    del got, pairs, out_a, params, opt, leaves
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(DIST_CKPT, ignore_errors=True)

    # GPipe at world 1: one stage applying all PIPE_S layers
    rng = np.random.default_rng(0)
    Ws = torch.from_numpy(rng.standard_normal(
        (PIPE_S, PIPE_D, PIPE_D)).astype(np.float32) * 0.3).cuda()
    h = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (PIPE_M, PIPE_MB, PIPE_L, PIPE_D)).astype(np.float32)).cuda()

    def all_layers(W, x):
        for s in range(W.shape[0]):
            x = torch.tanh(x @ W[s])
        return x

    pipe_mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
    got_p = make_pipelined_apply(all_layers, pipe_mesh, axis_name="pod",
                                 num_microbatches=PIPE_M)(Ws[None], h)
    res["pipe_err"] = float((got_p - all_layers(Ws, h)).abs().max())
    dist.destroy_process_group()

    # the dry run of the same cell on a 1x1 fake mesh
    dryrun.init_fake_world(1)
    try:
        rec = dryrun.lower_cell(
            TRAIN_ARCH, ShapeConfig("train_4k_b4", TRAIN_SEQ, TRAIN_BATCH,
                                    "train"),
            make_host_mesh(device_type="cpu"),
            impl=ModelImpl(attn="xla", ssd="xla", moe="xla",
                           loss_chunk=LOSS_CHUNK), microbatches=1)
    finally:
        dist.destroy_process_group()
    res["dry"] = rec
    out.write_text(json.dumps(res))


def gloo4_rank(out: Path) -> None:
    """24 (b), one of the four gloo ranks on the card."""
    import torch
    import torch.distributed as dist
    from repro_torch.train.compression import pod_allreduce_compressed
    torch.cuda.set_device(0)
    dist.init_process_group("gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    x, g = compress_inputs(world)
    red = pod_allreduce_compressed({"x": torch.from_numpy(x[rank]).cuda(),
                                    "g": [torch.from_numpy(g[rank]).cuda()]})
    check(red["x"].is_cuda and red["g"][0].is_cuda,
          "the compressed all-reduce left the card")
    (out / f"rank{rank}.json").write_text(json.dumps({
        "backend": dist.get_backend(), "x": red["x"].cpu().tolist(),
        "g": red["g"][0].cpu().tolist()}))
    dist.barrier()
    dist.destroy_process_group()


def dist_phase(dev, run_a_losses: list) -> None:
    """24. distribution on the card: (a) in a world-1 NCCL subprocess,
    (b) in four gloo subprocesses."""
    import numpy as np
    import torch
    from repro_torch.train.compression import pod_allreduce_formula
    gc.collect()
    torch.cuda.empty_cache()
    out = ROOT / "build" / "chip_smoke_dist.json"
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    run_ranks("nccl1", out, 1, timeout=600)
    res = json.loads(out.read_text())
    wall_a = time.perf_counter() - t0
    losses, want = res["losses"], run_a_losses[:DIST_STEPS]
    check(len(losses) == DIST_STEPS, f"the sharded run ran {len(losses)} steps")
    if losses == want:
        how = "bit for bit"
    else:
        i = next(i for i, (a, b) in enumerate(zip(losses, want)) if a != b)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        check(rel <= DIST_LOSS_RTOL,
              f"sharded losses {losses} vs phase 22's {want}: {rel:.3e}")
        how = (f"within {rel:.3e} relative (first difference at step "
               f"{i + 1}: {losses[i]!r} vs {want[i]!r})")
    print(f"dist: (a) world 1 over {res['backend']}: {TRAIN_ARCH} full width, "
          f"phase 22's cell, {DIST_STEPS} steps through train_loop(mesh=...): "
          f"losses {losses} equal phase 22's run A's first {DIST_STEPS} "
          f"{how}; step_s {[round(x, 3) for x in res['step_s']]}, "
          f"train_loop {res['train_s']:.3f} s (with the step-{DIST_STEPS} "
          "checkpoint's write)")
    check(res["restore_step"] == DIST_STEPS
          and res["restore_same"] == res["restore_leaves"],
          f"elastic restore: {res['restore_same']} of {res['restore_leaves']} "
          f"leaves bit-equal at step {res['restore_step']}")
    print(f"dist: (a) the step-{DIST_STEPS} checkpoint written from the "
          f"DTensors ({res['ckpt_bytes'] / 1e9:.3f} GB) restored onto the "
          f"mesh by load_checkpoint(mesh=..., spec_tree=...) in "
          f"{res['restore_s']:.3f} s: {res['restore_same']} of "
          f"{res['restore_leaves']} leaves equal bit for bit")
    mem = res["dry"]["memory"]
    check(mem["param_bytes"] == res["param_bytes"]
          and mem["opt_bytes"] == res["opt_bytes"],
          f"dry run params/opt bytes {mem['param_bytes']}/{mem['opt_bytes']} "
          f"vs allocated {res['param_bytes']}/{res['opt_bytes']}")
    print(f"dist: (a) dry run of this cell on a 1x1 fake mesh: params "
          f"{mem['param_bytes']} B and optimizer state {mem['opt_bytes']} B "
          f"equal the allocated local shards exactly; bytes_per_device "
          f"{mem['bytes_per_device'] / 2**30:.3f} GiB (step peak "
          f"{mem['peak_step_bytes'] / 2**30:.3f} GiB) beside the measured "
          f"max_memory_allocated {res['peak_bytes'] / 2**30:.3f} GiB; traced "
          f"in {res['dry']['trace_s']} s")
    check(res["pipe_err"] <= PIPE_ATOL, f"pipeline err {res['pipe_err']}")
    print(f"dist: (a) GPipe S={PIPE_S} M={PIPE_M} mb={PIPE_MB} L={PIPE_L} "
          f"d={PIPE_D} at world 1 over NCCL (one stage applying all "
          f"{PIPE_S} layers; no backend takes point-to-point between ranks "
          f"sharing one card): max abs err {res['pipe_err']:.3e} against the "
          f"sequential stages (atol {PIPE_ATOL}); (a) took {wall_a:.3f} s")

    t0 = time.perf_counter()
    outdir = ROOT / "build" / "chip_smoke_gloo"
    outdir.mkdir(parents=True, exist_ok=True)
    for f in outdir.glob("rank*.json"):
        f.unlink()
    run_ranks("gloo4", outdir, GLOO_WORLD, timeout=300)
    x, g = compress_inputs(GLOO_WORLD)
    want_x = pod_allreduce_formula(list(x))
    want_g = pod_allreduce_formula(list(g))
    for r in range(GLOO_WORLD):
        got = json.loads((outdir / f"rank{r}.json").read_text())
        check(got["backend"] == "gloo", f"rank {r} ran over {got['backend']}")
        check(np.array_equal(np.asarray(got["x"], np.float32), want_x)
              and np.array_equal(np.asarray(got["g"], np.float32), want_g),
              f"rank {r}: the compressed all-reduce differs from the formula")
    mean_err = float(np.max(np.abs(want_x - x.mean(axis=0))))
    check(mean_err < 0.2, f"compressed mean error {mean_err}")
    print(f"dist: (b) {GLOO_WORLD} ranks on the one card over gloo: "
          f"pod_allreduce_compressed on CUDA tensors ((8,) and (4096,) f32 a "
          f"rank) equals the numpy formula bit for bit on every rank; "
          f"max abs err from the mean {mean_err:.4f} (< 0.2); "
          f"{time.perf_counter() - t0:.3f} s")


def platform_rank(out: Path) -> None:
    """25. the platform trace through the greedy loop on the card, then the
    dry run of granite x train_4k on the fake 16x16 mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import (PPOAgent, RLPrioritizer, Simulator,
                                  make_cluster)
    from repro_torch.core.costmodel import generate_platform_trace
    from repro_torch.kernels import ops, policy_mlp as pm
    from repro_torch.kernels.batch_score import BucketedScorer
    from repro_torch.kernels.ref import policy_mlp_ref
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    pm.build()
    t0 = time.perf_counter()
    jobs = generate_platform_trace(PLATFORM_JOBS, seed=0)
    gen_s = time.perf_counter() - t0
    rt = np.asarray([j.runtime for j in jobs])
    agent = PPOAgent(device="cuda")
    scorer = BucketedScorer(agent.params["actor"])
    record, counts = [], {"head": 0, "tail": 0}
    in_tail = [False]
    real_policy_mlp, real_score = ops.policy_mlp, scorer.score

    def tapped(x, params, mask):
        out = real_policy_mlp(x, params, mask)
        kind = "tail" if in_tail[0] else "head"
        counts[kind] += 1
        if counts[kind] <= CHECK_DECISIONS:
            record.append((kind, x.clone(), mask.clone(), out.clone()))
        return out

    def tail_score(feats):
        in_tail[0] = True
        try:
            return real_score(feats)
        finally:
            in_tail[0] = False

    scorer.score = tail_score
    sim = Simulator(make_cluster(PLATFORM_CLUSTER), allocator="milp",
                    backfill=True)
    ops.policy_mlp = tapped
    pm.launches = 0
    t0 = time.perf_counter()
    try:
        res = sim.run_batch([j.clone_pending() for j in jobs],
                            RLPrioritizer(agent, explore=False,
                                          deep_scorer=scorer))
        torch.cuda.synchronize()
    finally:
        ops.policy_mlp = real_policy_mlp
    wall = time.perf_counter() - t0
    launches = pm.launches
    done = sum(1 for j in res.jobs if j.finish_time >= 0)
    check(done == PLATFORM_JOBS, f"platform: {done} of {PLATFORM_JOBS} done")
    check(launches > 0 and launches >= res.decisions,
          f"platform: {launches} launches for {res.decisions} decisions")
    flat = [t for lyr in agent.params["actor"] for t in (lyr["w"], lyr["b"])]
    worst = 0.0
    with torch.no_grad():
        for kind, x, mask, got in record:
            plain = policy_mlp_ref(x, *flat, mask)
            worst = max(worst, (got - plain).abs().max().item())
            check(rank_agrees(got.cpu().numpy(), plain.cpu().numpy(), ATOL),
                  f"platform {kind} ranking differs from the plain version's")
    check(worst <= ATOL, f"platform logits vs plain: {worst:.3e}")
    n_head = sum(1 for r in record if r[0] == "head")
    tup = (res.makespan, res.total_wait, res.gpu_seconds_used, res.decisions,
           res.milp_calls, res.backfills, res.restarts)
    print(f"platform: generate_platform_trace({PLATFORM_JOBS}, seed=0) in "
          f"{gen_s:.3f} s over {len({j.arch for j in jobs})} archs; runtimes "
          f"at H100 rates over the V100 SKU: median {np.median(rt):.1f} s, "
          f"{(rt <= 60.0).mean():.4f} at the 60 s clip, "
          f"{(rt >= 7 * 86400.0).mean():.4f} at the 7-day clip", flush=True)
    print(f"platform: {PLATFORM_CLUSTER}, milp + backfill, window 2560, greedy "
          f"actor + BucketedScorer tail: BatchResult {tup}; decisions "
          f"{res.decisions} head calls {counts['head']} tail calls "
          f"{counts['tail']} policy_mlp launches {launches} wall_s "
          f"{wall:.3f}; the first {n_head} head and {len(record) - n_head} "
          f"tail calls against the plain version: max_abs_err {worst:.3e}, "
          "rankings agree", flush=True)
    small = []
    for device in ("cuda", "cpu"):
        a = PPOAgent(device=device)
        r = Simulator(make_cluster(PLATFORM_CLUSTER), allocator="milp",
                      backfill=True).run_batch(
            generate_platform_trace(PLATFORM_SMALL, seed=0),
            RLPrioritizer(a, explore=False,
                          deep_scorer=BucketedScorer(a.params["actor"])))
        small.append((r.makespan, r.total_wait, r.gpu_seconds_used,
                      r.decisions, r.milp_calls, r.backfills, r.restarts))
    check(small[0] == small[1],
          f"platform {PLATFORM_SMALL}: card {small[0]} != CPU {small[1]}")
    print(f"platform: {PLATFORM_SMALL} platform jobs: the card's BatchResult "
          f"equals the CPU's {small[0]}", flush=True)

    dryrun.init_fake_world(256)
    try:
        rec = dryrun.lower_cell(TRAIN_ARCH, "train_4k",
                                make_production_mesh(device_type="cpu"))
    finally:
        dist.destroy_process_group()
    check(rec["dominant"] in ("compute_s", "memory_s", "collective_s"),
          f"dry run: {rec['dominant']}")
    print(f"platform: dry run {TRAIN_ARCH} x train_4k on the fake 16x16 mesh "
          f"(256 ranks, microbatches {rec['microbatches']}), analytic at H100 "
          f"rates: compute {rec['compute_s'] * 1e3:.3f} ms memory "
          f"{rec['memory_s'] * 1e3:.3f} ms collective "
          f"{rec['collective_s'] * 1e3:.3f} ms ({rec['collective_total']} B "
          f"a chip, {sum(rec['collective_counts'].values())} collectives) "
          f"dominant {rec['dominant']}; {rec['memory']['bytes_per_device'] / 2**30:.3f} "
          f"GiB per device; traced FLOPs a chip {rec['hlo_flops_per_chip']:.4g} "
          f"(analytic {rec['flops_per_chip']:.4g}); traced in {rec['trace_s']} s",
          flush=True)
    out.write_text(json.dumps({"launches": launches, "max_abs_err": worst,
                               "decisions": res.decisions}))


PHASES = {"nccl1": nccl1_rank, "gloo4": gloo4_rank, "platform": platform_rank}


def phase_main(argv: list[str]) -> int:
    """``--phase NAME OUT``: one of the subprocess phases above."""
    sys.path.insert(0, str(SRC))
    PHASES[argv[0]](Path(argv[1]))
    return 0


def platform_phase() -> dict:
    """25. in its own subprocess (it owns a fake process group)."""
    out = ROOT / "build" / "chip_smoke_platform.json"
    out.unlink(missing_ok=True)
    run_ranks("platform", out, 1, timeout=600)
    return json.loads(out.read_text())


# phase 26: the paper's tables (benchmarks_torch) at a cut scale
PAPER_TRAIN_BATCHES = 2          # batch pairs of 128 per agent (quick: 60)
PAPER_EVAL_BATCHES = 1           # evaluation batches per eval_pair (quick: 4)
PAPER_AGENTS = ROOT / "build" / "chip_smoke_agents"
PAPER_BENCHES = ("variability", "naive", "util", "transfer", "qssf",
                 "policies", "prediction", "rl_streaming")
PAPER_VARIANTS = ("pro", "naive", "inspector")


def csv_row_finite(line: str) -> bool:
    """A ``name,us_per_call,derived`` row whose numbers are all finite."""
    import math
    import re
    _, us, derived = line.split(",", 2)
    nums = re.findall(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?|nan|inf",
                      derived.lower())
    return math.isfinite(float(us)) and all(math.isfinite(float(x))
                                            for x in nums)


def greedy_tap(log: list):
    """A ``greedy_step`` that also logs (the order of the live rows, the
    smallest gap between two live logits) of every greedy decision."""
    import numpy as np
    from repro_torch.core import agent as agent_mod
    real = agent_mod.greedy_step

    def tapped(net, ov, mask):
        order = real(net, ov, mask)
        logits = agent_mod.actor_logits(net, ov, mask).detach().cpu().numpy()
        live = int((mask > 0).sum())
        gaps = -np.diff(logits[order[:live]].astype(np.float64))
        log.append((order[:live].tolist(),
                    float(gaps.min()) if gaps.size else float("inf")))
        return order
    return tapped


def paper_tables_phase(dev) -> dict:
    """26. the eight paper and stream benches of ``benchmarks_torch`` in
    this process on the card, the first assisted stream's first predictor
    calls held against the plain version, then one cached agent per
    variant evaluated on the card and on the CPU."""
    import os
    import shutil
    import numpy as np
    import torch
    os.environ.update({
        "REPRO_BENCH_TRAIN_BATCHES": str(PAPER_TRAIN_BATCHES),
        "REPRO_BENCH_EVAL_BATCHES": str(PAPER_EVAL_BATCHES),
        "REPRO_BENCH_DEVICE": dev.type,
        "REPRO_BENCH_PREDICT_JSON": str(ROOT / "build" /
                                        "chip_smoke_BENCH_prediction.json"),
        "REPRO_BENCH_RL_JSON": str(ROOT / "build" /
                                   "chip_smoke_BENCH_rl_streaming.json")})
    import benchmarks_torch
    check(Path(benchmarks_torch.__file__).resolve().is_relative_to(ROOT),
          f"benchmarks_torch imported from {benchmarks_torch.__file__}")
    from benchmarks_torch import bench_prediction, common
    from benchmarks_torch.run import SPECIAL, Split
    from repro_torch.core import agent as agent_mod
    from repro_torch.kernels import ops, policy_mlp as pm, predict_mlp as qm
    check((common.TRAIN_BATCHES, common.EVAL_BATCHES) ==
          (PAPER_TRAIN_BATCHES, PAPER_EVAL_BATCHES),
          "benchmarks_torch.common was imported before phase 26's knobs")
    shutil.rmtree(PAPER_AGENTS, ignore_errors=True)
    common.AGENTS = str(PAPER_AGENTS)

    # the assisted arms' launches, per stream; the first assisted stream's
    # first CHECK_PREDICTS predictor calls, for the check against the plain
    # version
    by_arm: dict[str, int] = {}
    record: list = []
    real_stream = bench_prediction.stream_once
    real_predict_mlp = ops.predict_mlp

    def counted_stream(scenario, num_jobs, assisted):
        before = qm.launches
        if assisted and not record:
            ops.predict_mlp = recording_predict_mlp(real_predict_mlp, record)
        try:
            out = real_stream(scenario, num_jobs, assisted)
        finally:
            ops.predict_mlp = real_predict_mlp
        by_arm[f"{scenario}/{'assisted' if assisted else 'blind'}"] = \
            qm.launches - before
        return out

    bench_prediction.stream_once = counted_stream
    rows: list[str] = []
    splits = {}
    pm.launches = qm.launches = 0
    t_all = time.perf_counter()
    try:
        for name in PAPER_BENCHES:
            mod = __import__(SPECIAL.get(name, f"benchmarks_torch.bench_{name}"),
                             fromlist=["run"])
            n_rows = len(rows)
            with Split() as split:
                if name in ("prediction", "rl_streaming"):
                    mod.run(rows, smoke=True)
                else:
                    mod.run(rows)
                torch.cuda.synchronize()
            splits[name] = split
            check(len(rows) > n_rows, f"paper tables: {name} gave no rows")
            print(f"paper tables: {name}: {split.line()}", flush=True)
    finally:
        bench_prediction.stream_once = real_stream
    wall = time.perf_counter() - t_all
    launches = {"policy_mlp": pm.launches, "predict_mlp": qm.launches}
    decisions = sum(sp.calls["act"] for sp in splits.values())
    bad = [r for r in rows if not csv_row_finite(r)]
    check(not bad, f"paper tables: rows not finite: {bad}")
    check(decisions > 0 and launches["policy_mlp"] >= decisions,
          f"paper tables: policy_mlp launches {launches['policy_mlp']} < "
          f"RL decisions {decisions}")
    check(all(n > 0 for k, n in by_arm.items() if k.endswith("/assisted"))
          and all(n == 0 for k, n in by_arm.items() if k.endswith("/blind"))
          and len(by_arm) == 2 * len(bench_prediction.SCENARIOS),
          f"paper tables: predict_mlp launches by arm {by_arm}")
    worst = recorded_predicts_err(record)
    check(record and all(out.is_cuda for _, _, out in record),
          f"paper tables: {len(record)} predictor calls recorded on the card")
    check(worst <= ATOL, f"paper tables: predictor outputs vs plain: max abs "
          f"err {worst:.3e}")
    rows_b = [x.shape[0] for x, _, _ in record]
    print(f"paper tables: the first assisted stream's first {len(record)} "
          f"predictor calls (B {min(rows_b)}-{max(rows_b)}) vs the plain "
          f"version: max_abs_err={worst:.3e}", flush=True)
    for r in rows:
        print(f"paper tables: row {r}")
    print(f"paper tables: {len(PAPER_BENCHES)} benches, {len(rows)} rows, all "
          f"finite, in {wall:.3f} s; {decisions} RL decisions, launches "
          f"{launches}; predict_mlp by arm {by_arm}", flush=True)

    # one cached agent per variant: the card's evaluate() against the CPU's
    real_greedy = agent_mod.greedy_step
    for variant in PAPER_VARIANTS:
        runs = {}
        for device in (dev, "cpu"):
            log: list = []
            tr = common.get_trainer("philly", "fcfs", "wait", variant,
                                    device=device)
            agent_mod.greedy_step = greedy_tap(log)
            try:
                ev = tr.evaluate(num_batches=common.EVAL_BATCHES,
                                 batch_size=common.BATCH_SIZE)
            finally:
                agent_mod.greedy_step = real_greedy
            runs[str(device)] = (ev, log)
        (ev_c, log_c), (ev_h, log_h) = runs[str(dev)], runs["cpu"]
        n, first_tie, first_diff = first_tie_and_diff(
            log_c, log_h, f"paper tables {variant}")
        if first_diff is None:
            check(len(log_c) == len(log_h) and ev_c == ev_h,
                  f"paper tables {variant}: the same decisions but card "
                  f"{ev_c} != CPU {ev_h}")
        tie = f"first near-tie (gap < {NEAR_TIE}) at decision {first_tie}" \
            if first_tie < n else f"no near-tie in {n} decisions"
        same = "equal" if ev_c == ev_h else f"differ (CPU {ev_h})"
        print(f"paper tables: philly/fcfs/wait/{variant} evaluate on the card "
              f"{ev_c}: {len(log_c)} greedy decisions, "
              f"{'all equal' if first_diff is None else f'first differ at {first_diff}'}"
              f" to the CPU's; {tie}; evaluate() {same}", flush=True)
    shutil.rmtree(PAPER_AGENTS, ignore_errors=True)
    return launches



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
    from repro_torch.kernels import flash_attention as fa, moe_router as mr
    from repro_torch.kernels import ops, policy_mlp as pm, predict_mlp as qm
    from repro_torch.kernels import ssd_scan as ss
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

    # ------------------------------------------------- 2. and 12. build --
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=5) as pool:
        builds = [(mod, pool.submit(mod.build))
                  for mod in (pm, qm, fa, ss, mr)]
        for mod, fut in builds:
            print(f"build: {mod.SOURCE.stem} from "
                  f"{mod.SOURCE.relative_to(ROOT)} in {fut.result():.2f} s -> "
                  f"{mod.library_path().relative_to(ROOT)}")
    print(f"build: all five kernels in {time.perf_counter() - t0:.2f} s")

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
    # the kernel's device time at every Q the main path launched, weighted
    # by its launches there (the actor's net; Q absent from QS timed here)
    per_q = {}
    for Q in sorted(by_q):
        if (Q, 8, 64, 32) in timings:
            per_q[Q] = timings[(Q, 8, 64, 32)][0]
        else:
            x, fl, mk, _ = case(Q, 8, 64, 32)
            per_q[Q] = graph_ms(lambda: pm.policy_mlp(x, *fl, mk))
    n_calls = sum(by_q.values())
    weighted = sum(per_q[Q] * n for Q, n in by_q.items())
    print("main: policy_mlp launches by Q " + " ".join(
        f"{Q}:{by_q[Q]}x{per_q[Q] * 1e3:.3f}us" for Q in sorted(by_q)) +
        f"; launch-weighted device_us per call={weighted / n_calls * 1e3:.3f}"
        f", device_ms over the run={weighted:.3f}")

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

    # ---------------------------------------------------- 13. LM kernels --
    lm_rows = lm_kernel_phase(dev)

    # -------------------------------------------- 14-15. LM serve, check --
    lm_launches = lm_serve_phase(dev)

    # ---------------------------------------------------------- 16. train --
    trained = train_phase(dev)

    # ---------------------------------------------------- 17. train check --
    train_check_phase(dev, trained)

    # -------------------------------------------------- 18. stream train --
    rl_launches = stream_train_phase(dev)

    # ---------------------------------------------------------- 19. fleet --
    t0 = time.perf_counter()
    fleet = fleet_phase(dev)
    print(f"fleet: phase 19 took {time.perf_counter() - t0:.3f} s")

    # ---------------------------------------------------- 20. fleet check --
    t0 = time.perf_counter()
    fleet_check = fleet_check_phase(dev)
    print(f"fleet check: phase 20 took {time.perf_counter() - t0:.3f} s")

    # -------------------------------------------------- 21. control plane --
    t0 = time.perf_counter()
    control = control_plane_phase(dev)
    print(f"control plane: phase 21 took {time.perf_counter() - t0:.3f} s")

    # ------------------------------------------------------- 22. LM train --
    t0 = time.perf_counter()
    trained_lm, run_a_losses = lm_train_phase(dev)
    print(f"lm train: phase 22 took {time.perf_counter() - t0:.3f} s")

    # ------------------------------------------------- 23. LM train check --
    t0 = time.perf_counter()
    served = lm_train_check_phase(dev, trained_lm)
    del trained_lm
    print(f"lm train check: phase 23 took {time.perf_counter() - t0:.3f} s")

    # -------------------------------------------------- 24. distribution --
    t0 = time.perf_counter()
    dist_phase(dev, run_a_losses)
    print(f"dist: phase 24 took {time.perf_counter() - t0:.3f} s")

    # ------------------------------------------------ 25. platform trace --
    t0 = time.perf_counter()
    platform = platform_phase()
    print(f"platform: phase 25 took {time.perf_counter() - t0:.3f} s")

    # ------------------------------------------------ 26. paper tables --
    t0 = time.perf_counter()
    paper = paper_tables_phase(dev)
    print(f"paper tables: phase 26 took {time.perf_counter() - t0:.3f} s")
    print(f"chip_smoke: phases 1-26 in {time.perf_counter() - T_START:.3f} s")

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
        "launches_by_path": {"philly-4096": launches,
                             "train": trained["launches"], **rl_launches,
                             "fleet": fleet["policy_mlp"],
                             "fleet-check": fleet_check["policy_mlp"],
                             "control-plane": control["policy_mlp"],
                             f"platform-{PLATFORM_JOBS}": platform["launches"],
                             "paper-tables": paper["policy_mlp"]},
        "max_abs_err": max(max_err, platform["max_abs_err"]),
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
        "launches_by_path": {"mispredict-storm-10000": q["launches"],
                             "fleet": fleet["launches"],
                             "fleet-check": fleet_check["predict_mlp"],
                             "control-plane": control["predict_mlp"],
                             "paper-tables": paper["predict_mlp"]},
        "max_abs_err": max(q_err, q["max_abs_err"], fleet["max_abs_err"]),
        "ms": q_ms,
        "plain_ms": q_plain_ms,
        "bound_ms": q_b_ms,
        "bound_by": q_b_by,
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces,
        "launches": lm_launches[name],
        **({"launches_by_path": {"jamba-superblock-serve": lm_launches[name],
                                 "granite-trained-serve": served[name]}}
           if name in served else {}),
        "max_abs_err": lm_rows[name]["max_abs_err"],
        "ms": lm_rows[name]["ms"],
        "plain_ms": lm_rows[name]["plain_ms"],
        "bound_ms": lm_rows[name]["bound_ms"],
        "bound_by": lm_rows[name]["bound_by"],
        "library_ms": lm_rows[name]["library_ms"],
    } for name, replaces in (
        ("flash_attention", "src/repro/kernels/flash_attention.py:86"),
        ("ssd_scan", "src/repro/kernels/ssd_scan.py:62"),
        ("moe_router", "src/repro/kernels/moe_router.py:43"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(phase_main(sys.argv[2:]) if sys.argv[1:2] == ["--phase"]
             else main())
