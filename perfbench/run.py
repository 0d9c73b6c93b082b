"""One run of one cell of the port's benchmark.

    python3 -m perfbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration (``perfbench/configs/<name>.json``: cluster, trace profile,
scheduler, predictor, the agent's seed) and a traffic mix
(``perfbench/traffic/<name>.json``: rate factor, jobs, the traces' seeds,
snapshot rule, passes a unit).  Set-up makes the agent's weights on the
device and each trace; builds one engine of the program a trace, replays
it to the snapshot, recording every pass, and saves it; then runs one
unit to warm every shape.  A unit visits the traces in an order drawn
from ``--seed`` (the only thing the seed changes: the traces and the agent
are the files'), restoring each snapshot and running the same passes.
The window repeats units until ``--seconds`` have passed, finishing the
unit in progress, and holds each unit against the first as it goes.
After it the records are held against the plain reference
(``perfbench.check``).

``--trace 0`` prints the end-to-end metrics, ``--trace 1`` the per-layer
ones, with the window under ``torch.profiler``; each metric is read by
``perfbench/metrics/<name>.py``, found by its name.  The last line of
standard output is one JSON object; standard error ends with each
compared number beside its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that may not be loaded in a run: JAX and the JAX
#: package, and the program's own benches (compared by whole top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks",
             "benchmarks_torch")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_cell(root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic) for ``workload``, each
    file found by the names ``BENCHMARK.json`` gives."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    cell = cells[workload]
    confs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / confs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "perfbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    return bench, cell, cfg, traffic


def load_reader(root: Path, name: str):
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of this cell reports."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def measure(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, device, override: dict | None = None
            ) -> tuple[dict, list[str]]:
    """Set-up, window and check of one run; returns the result line's
    object and notes for standard error.  ``override`` (the control's
    extra datasets only) replaces keys of the configuration (``config``)
    and of the traffic mix (``traffic``)."""
    import numpy as np
    import torch

    from perfbench import check, harness
    from perfbench import traffic as traffic_gen

    bench, cell, cfg, traffic = load_cell(root, workload)
    if override:
        cfg = {**cfg, **override.get("config", {})}
        traffic = {**traffic, **override.get("traffic", {})}
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    null = contextlib.nullcontext
    weights = harness.make_weights(cfg, device)
    notes = [f"set-up: the device and the weights at "
             f"{time.perf_counter() - T_START:.3f} s"]
    nodes = harness.node_list(cfg)
    taps = harness.Taps()
    taps.install()
    K = int(traffic["segment_passes"])
    # --seed orders the traces in a unit; it changes none of the work
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    order = [int(i) for i in rng.permutation(len(traffic["trace_seeds"]))]
    traces, blobs = [], []
    for i, tseed in enumerate(traffic["trace_seeds"]):
        arrays = traffic_gen.generate(cfg["profile"], traffic["num_jobs"],
                                      int(tseed),
                                      traffic.get("rate_factor", 1.0))
        prog = harness.Program(cfg, traffic, arrays, weights, device, taps)
        t0 = prog.start_state()
        recs = prog.replay()
        snap = prog.start_state()
        blobs.append(prog.snapshot())
        traces.append({"arrays": arrays, "t0": t0, "setup": recs,
                       "snap": snap})
        notes.append(f"set-up: trace {i}: {len(recs)} passes to the snapshot"
                     f" ({len(snap['pending'])} pending, "
                     f"{len(snap['running'])} running), "
                     f"{len(blobs[-1])} B saved, at "
                     f"{time.perf_counter() - T_START:.3f} s")
        del prog
    blobs = [blobs[i] for i in order]
    t_warm = time.perf_counter()
    warm, warm_counts, *_ = harness.run_unit(blobs, K, taps, sync, [],
                                             lambda name: null())
    warm = check.Digest(warm)
    gc.collect()
    # what set-up made lives through the window: keep it out of the
    # collector's scans
    gc.freeze()
    setup_s = time.perf_counter() - T_START
    notes.append(f"set-up: {setup_s:.3f} s, the warm-up unit "
                 f"{setup_s - (t_warm - T_START):.3f} s of it")

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    taps.timing = trace
    taps.policy, taps.predict = [], []
    taps.rank_s = taps.pred_s = taps.alloc_s = 0.0
    pass_s: list = []
    prof = None
    annotate = (lambda name: null())
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        annotate = torch.profiler.record_function
    taps.annotate = annotate
    first, counts, restores, walls = None, [], [], []
    unit_faults = failed = 0
    raised = None
    w0 = time.perf_counter()
    while True:
        recs, c, r_s, f, raised = harness.run_unit(blobs, K, taps, sync,
                                                   pass_s, annotate)
        t1 = time.perf_counter()
        with annotate("perfbench.digest"):
            # each unit is held against the first as the window runs, and
            # only the first unit's records outlive it
            d = check.Digest(recs)
            if first is None:
                first, first_recs = d, recs
            elif not d.same(first):
                unit_faults += 1
            del recs, d
        t2 = time.perf_counter()
        with annotate("perfbench.gc"):
            # the unit's engine goes; what stays, out of later scans
            gc.collect()
            gc.freeze()
        walls.append((c.pop("wall_ms"), (t2 - t1) * 1e3,
                      (time.perf_counter() - t2) * 1e3))
        counts.append(c)
        restores.append(r_s)
        failed += f
        if raised or time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        if cuda:
            from perfbench import trace_reader
            out_dir = root / "build" / "perfbench"
            out_dir.mkdir(parents=True, exist_ok=True)
            path = out_dir / f"trace-{workload}.json"
            prof.export_chrome_trace(str(path))
            tr = trace_reader.read(str(path))
            path.unlink()
            for k, taps_n in (("policy_mlp", len(taps.policy)),
                              ("predict_mlp", len(taps.predict))):
                sec, n = trace_reader.kernel_time(tr["by_name"], k)
                notes.append(f"profiler: {n} {k} kernels, {sec:.6f} s on "
                             f"the device; the taps counted {taps_n}")
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    for i, (c, r_s, (wall, dig, col)) in enumerate(zip(counts, restores,
                                                       walls)):
        notes.append(f"unit {i}: {wall:.3f} ms, restores " +
                     " ".join(f"{x * 1e3:.3f}" for x in r_s) +
                     f" ms, digest {dig:.3f} ms, collection {col:.3f} ms, " +
                     ", ".join(f"{k} {v}" for k, v in c.items()))
    if raised:
        notes.append(f"a pass raised: {raised}")
    if pass_s:
        notes.append("pass walls: p50 {:.6f} ms, p95 {:.6f} ms over {} "
                     "passes".format(float(np.median(pass_s)) * 1e3,
                                     float(np.percentile(pass_s, 95)) * 1e3,
                                     len(pass_s)))

    # the records leave the device; the program's state goes
    notes.append("unit order of the traces: " + " ".join(map(str, order)))
    for t in traces:
        t["setup"] = check.to_host(t["setup"])
    first_h = [check.to_host(seg) for seg in first_recs]
    warm_counts.pop("wall_ms")
    unit_faults += sum(c != warm_counts for c in counts)
    unit_faults += not warm.same(first)
    ctx = {"pass_s": pass_s, "passes": sum(c["passes"] for c in counts),
           "rank_s": taps.rank_s, "alloc_s": taps.alloc_s,
           "pred_s": taps.pred_s,
           "milp_calls": sum(c["milp_calls"] for c in counts),
           "policy": list(taps.policy), "predict": list(taps.predict),
           "trace": tr, "window_s": window_s, "setup_s": setup_s,
           "starts": sum(c["starts"] for c in counts),
           "has_predictor": bool(cfg.get("predictor"))}
    del first, first_recs, warm, blobs
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks, why = check.compare(cfg, nodes, weights, traces, order, first_h)
    checks["unit_faults"] = {"value": unit_faults,
                             "limit": check.LIMITS["unit_faults"]}
    notes += [f"check: {w}" for w in why]
    notes.append(f"check: the reference took "
                 f"{time.perf_counter() - t_check:.3f} s")
    attempted = ctx["passes"]
    correct = check.passed(checks) and failed == 0 and not raised

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        v = load_reader(root, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = window_s
        result["breakdown"] = {"device_ops": tr["ops"],
                               "idle_gaps": tr["gaps"]}
    notes.append(f"window: {len(counts)} units, {attempted} passes, "
                 f"{ctx['starts']} starts, {window_s:.6f} s")
    result["compared"] = checks
    return result, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    os.environ.setdefault("USE_FLAX", "0")
    # one host thread for torch and for numpy's BLAS: the scheduler's
    # arrays are small, and threads that wait on one another only add noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")

    import torch
    torch.set_num_threads(1)
    _, cell, _, _ = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, notes = measure(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for n in notes:
        print(n, file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
