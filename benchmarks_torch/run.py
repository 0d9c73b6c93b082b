"""Benchmark runner of the port: one module per paper table or figure, and
the stream and control-plane benches.

    PYTHONPATH=src python -m benchmarks_torch.run [module ...] [--smoke] [--rss] [--device cuda|cpu]

The analog of ``benchmarks/run.py`` over the port's benches (``MODULES``:
latency, kernels, roofline, variability, naive, qssf, util, transfer,
policies, rl_streaming, prediction, streaming, scale_curve, preemption,
autoscaling, federation, obs, chaos: every module of the reference's;
its hillclimb is a CLI of its own, ``python -m
benchmarks_torch.hillclimb``, as there).
Prints human-readable tables plus ``name,us_per_call,derived`` CSV rows at
the end.  ``--smoke`` runs every selected module that supports it in its
fast mode (modules whose ``run`` accepts a ``smoke`` kwarg); ``--rss``
stamps peak RSS into the bench points of modules that support it;
``--device`` (default ``cuda``) is exported as ``REPRO_BENCH_DEVICE``, so
every module and ``common.get_trainer`` put their agents and predictors
there.  REPRO_BENCH_SCALE=full for paper-scale runs.

After each module the runner prints its wall split into the agents'
``act`` calls, their PPO updates and the rest (simulation, features,
MILP); the seconds in single-cluster engine steps, in a fleet's member
steps and in MILP placement; and the ``policy_mlp`` and ``predict_mlp``
kernel launches it made (0 on the CPU, where the plain versions run).

A module that raises marks the whole run failed: the remaining modules
still run, but the runner exits nonzero.
"""
from __future__ import annotations

import argparse
import inspect
import os
import sys
import threading
import time

MODULES = ("latency", "kernels", "roofline", "variability", "naive", "qssf",
           "util", "transfer", "policies", "rl_streaming", "prediction",
           "streaming", "scale_curve", "preemption", "autoscaling",
           "federation", "obs", "chaos")
SPECIAL = {"roofline": "benchmarks_torch.roofline",
           "naive": "benchmarks_torch.bench_naive_vs_pro"}


class Split:
    """While entered: calls of and seconds in ``PPOAgent.act`` (one a
    decision) and ``PPOAgent._run_update`` (one a PPO update); seconds in
    ``SchedulerEngine.step`` on the main thread outside a federation
    (``engine``), in ``FederatedScheduler._step_members`` (``fleet``: the
    members' steps, serial or in the pool's threads) and in the engines'
    ``choose_allocation`` calls (``milp``, summed over threads, a part of
    the first two); and the launch counts of the ``policy_mlp`` and
    ``predict_mlp`` kernels."""

    def __enter__(self):
        from repro_torch.core.agent import PPOAgent
        from repro_torch.fed.federation import FederatedScheduler
        from repro_torch.kernels import policy_mlp, predict_mlp
        from repro_torch.sched import engine as engine_mod
        self.kernels = {"policy_mlp": policy_mlp, "predict_mlp": predict_mlp}
        self.start = {k: m.launches for k, m in self.kernels.items()}
        self.seconds = {"act": 0.0, "update": 0.0, "engine": 0.0,
                        "fleet": 0.0, "milp": 0.0}
        self.calls = {"act": 0, "update": 0, "milp": 0}
        targets = {"act": (PPOAgent, "act"),
                   "update": (PPOAgent, "_run_update"),
                   "engine": (engine_mod.SchedulerEngine, "step"),
                   "fleet": (FederatedScheduler, "_step_members"),
                   "milp": (engine_mod, "choose_allocation")}
        self.real = {k: (owner, attr, getattr(owner, attr))
                     for k, (owner, attr) in targets.items()}
        lock = threading.Lock()
        in_fleet = [False]
        main = threading.main_thread()
        self.t0 = time.perf_counter()

        def timed(name, counted=lambda: True):
            real = self.real[name][2]

            def call(*args, **kwargs):
                if not counted():
                    return real(*args, **kwargs)
                t = time.perf_counter()
                try:
                    return real(*args, **kwargs)
                finally:
                    dt = time.perf_counter() - t
                    with lock:
                        self.seconds[name] += dt
                        if name in self.calls:
                            self.calls[name] += 1
            return call

        timed_fleet = timed("fleet")

        def fleet(fed, until):
            in_fleet[0] = True
            try:
                return timed_fleet(fed, until)
            finally:
                in_fleet[0] = False

        patched = {name: timed(name) for name in ("act", "update", "milp")}
        patched["engine"] = timed(
            "engine", lambda: threading.current_thread() is main
            and not in_fleet[0])
        patched["fleet"] = fleet
        for name, (owner, attr, _) in self.real.items():
            setattr(owner, attr, patched[name])
        return self

    def __exit__(self, *exc):
        for owner, attr, real in self.real.values():
            setattr(owner, attr, real)
        self.wall = time.perf_counter() - self.t0
        self.launches = {k: m.launches - self.start[k]
                         for k, m in self.kernels.items()}
        return False

    def line(self) -> str:
        s = self.seconds
        act, upd = s["act"], s["update"]
        return (f"wall {self.wall:.1f}s: act {act:.1f}s ({self.calls['act']} "
                f"decisions), update {upd:.1f}s ({self.calls['update']}), "
                f"rest {self.wall - act - upd:.1f}s; engine {s['engine']:.1f}s, "
                f"fleet members {s['fleet']:.1f}s, milp {s['milp']:.1f}s "
                f"({self.calls['milp']} calls); launches " +
                ", ".join(f"{k} {n}" for k, n in self.launches.items()))


def _run_latency(mod, rows: list[str], device: str) -> None:
    from benchmarks_torch.common import row
    for r in mod.run(device):
        rows.append(row(f"latency/queue_{r['queue']}",
                        r["decision_ms"] * 1e3,
                        f"kernel {r['kernel_us']:.1f}us plain "
                        f"{r['plain_us']:.1f}us milp {r['milp_ms']:.1f}ms"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmarks_torch.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("modules", nargs="*", metavar="module",
                    help=f"any of {', '.join(MODULES)} (default all)")
    ap.add_argument("--smoke", action="store_true",
                    help="fast mode of the modules that have one")
    ap.add_argument("--rss", action="store_true",
                    help="stamp peak RSS into the bench points")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of every agent and predictor (default cuda)")
    args = ap.parse_args(argv)
    unknown = [m for m in args.modules if m not in MODULES]
    if unknown:
        ap.error(f"unknown modules {unknown}; choose from {MODULES}")
    # env (not a module global) so benches see it whatever the import order,
    # and standalone `python -m benchmarks_torch.bench_*` reads the same
    from benchmarks_torch.common import DEVICE_ENV, RSS_ENV
    os.environ[DEVICE_ENV] = args.device
    if args.rss:
        os.environ[RSS_ENV] = "1"
    rows: list[str] = []
    artifacts: list[str] = []
    failed: list[str] = []
    t0 = time.time()
    for name in args.modules or MODULES:
        mod = __import__(SPECIAL.get(name, f"benchmarks_torch.bench_{name}"),
                         fromlist=["run"])
        print(f"\n{'=' * 72}\n== {name}\n{'=' * 72}", flush=True)
        ok = True
        with Split() as split:
            try:
                if name == "latency":
                    _run_latency(mod, rows, args.device)
                elif args.smoke and \
                        "smoke" in inspect.signature(mod.run).parameters:
                    mod.run(rows, smoke=True)
                else:
                    mod.run(rows)
            except Exception as e:  # noqa: BLE001
                import traceback
                traceback.print_exc()
                print(f"[bench {name} FAILED] {e!r}")
                rows.append(f"{name}/FAILED,0,{e!r}")
                failed.append(name)
                ok = False
        path = getattr(mod, "JSON_PATH", None)
        # only report the artifact on success: a stale file from an earlier
        # run must not be read as this run's numbers
        if ok and path and os.path.exists(path):
            artifacts.append(os.path.normpath(path))
        print(f"-- {name} done: {split.line()}", flush=True)

    print(f"\n{'=' * 72}\n== CSV (name,us_per_call,derived)\n{'=' * 72}")
    for r in rows:
        print(r)
    for a in artifacts:
        print(f"# json artifact: {a}")
    print(f"# total bench time {time.time() - t0:.0f}s")
    if failed:
        print(f"# FAILED modules: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
