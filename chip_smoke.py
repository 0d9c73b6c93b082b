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
    no ranking puts an SLA job behind a non-SLA job.

Then one JSON line describing all five kernels (times, launches, bounds;
``launches_by_path`` gives the policy MLP's on each path), and as
the last line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before that line.  It imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import copy
import gc
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
    from repro_torch.models.lm import ModelImpl
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
    xla = build_model(cfg, impl=ModelImpl(attn="xla", ssd="xla", moe="xla"),
                      device=dev)
    x_engine = ServeEngine(xla, params, batch_size=LM_BATCH, max_len=max_len,
                           device=dev)
    x_rec = tap_engine(x_engine, LM_NEW)
    x_done = x_engine.run([Request(req_id=i, prompt=p, max_new_tokens=LM_NEW)
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
              f"{what}: kernel vs plain path, {bad} logits outside {tol}, "
              f"max abs diff {float(diff.max()):.4f}, relative RMS {rel:.4f}")
        return float(diff.max()), rel

    pre_err, pre_rel = compare(k_logits[0][:, :V], x_logits[0][:, :V],
                               PREFILL_TOL, "prefill logits")
    scale = float(x_logits[0][:, :V].pow(2).mean().sqrt())
    worst, worst_rel, agree, notes = 0.0, 0.0, 0, []
    for i in range(LM_BATCH):
        a, b = done[i].output, x_done[i].output
        for s in range(1, LM_NEW):      # step s is fed token s - 1
            if a[s - 1] != b[s - 1]:
                break
            err, rel = compare(k_logits[s][i, :V], x_logits[s][i, :V],
                               DECODE_TOL, f"row {i} decode step {s}")
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
        for s in range(LM_NEW):
            if a[s] != b[s]:
                kl = k_logits[s][i, :V]
                notes.append(f"row {i} token {s}: {a[s]} vs {b[s]}, kernel-path "
                             f"logit gap {float(kl[a[s]] - kl[b[s]]):.5f}")
                break
            agree += 1
    print(f"lm check: first batch through the plain path on the card: "
          f"prefill logits max_abs_diff={pre_err:.5f} relative_rms={pre_rel:.5f} "
          f"(logits RMS {scale:.4f}); decode logits up to each row's first "
          f"differing token max_abs_diff={worst:.5f} relative_rms="
          f"{worst_rel:.5f} (tolerances {PREFILL_TOL} / {DECODE_TOL} abs+rel, "
          f"{REL_RMS_TOL} relative RMS); greedy tokens agree on {agree} of "
          f"{LM_BATCH * LM_NEW} up to each row's first near-tie: "
          f"{notes or 'none'}; all logits finite")
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
    n = min(len(log_c), len(log_h))
    first_tie = next((i for i in range(n)
                      if min(log_c[i][1], log_h[i][1]) < NEAR_TIE), n)
    first_diff = next((i for i in range(n) if log_c[i][0] != log_h[i][0]),
                      None)
    check(first_diff is None or first_diff >= first_tie,
          f"small training: action {first_diff} differs before the first "
          f"near-tie ({first_tie})")
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
                             "train": trained["launches"], **rl_launches},
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
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces,
        "launches": lm_launches[name],
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
    sys.exit(main())
