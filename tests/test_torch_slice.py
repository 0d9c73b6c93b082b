"""The port's decision loop end to end against the JAX package's.

trace -> ClusterState -> build_state -> actor ranks the queue (head window
plus, with a deep scorer, the tail beyond 256 rows) -> MILP placement ->
event loop -> BatchResult.  With the reference agent's weights carried
across, a greedy run must give the reference's schedule exactly: the same
BatchResult tuple and the same start/finish time for every job.  The
logits agree within 1e-5 (tests/test_torch_agent.py); exact schedule
identity additionally needs no near-tie to flip, which these runs show.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.kernels.batch_score import BucketedScorer as JBucketedScorer
from repro_torch.kernels.batch_score import BucketedScorer as TBucketedScorer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unit_actor(seed: int) -> list[dict]:
    """Unit-scale actor weights (well separated tail logits)."""
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
             "b": rng.normal(size=(b,)).astype(np.float32)}
            for a, b in ((8, 64), (64, 32), (32, 1))]


class _CountingScorer:
    """Wraps a BucketedScorer; records the row count of every tail call."""

    def __init__(self, inner):
        self.inner = inner
        self.rows: list[int] = []

    def score(self, feats):
        self.rows.append(len(feats))
        return self.inner.score(feats)


def _run(pkg, agent, trace, n, *, deep_scorer=None, allocator="milp"):
    pri = pkg.RLPrioritizer(agent, explore=False, deep_scorer=deep_scorer)
    sim = pkg.Simulator(pkg.make_cluster(trace), allocator=allocator)
    r = sim.run_batch(pkg.generate_trace(trace, n, seed=0), pri)
    tup = (r.makespan, r.total_wait, r.gpu_seconds_used, r.decisions,
           r.milp_calls, r.backfills, r.restarts)
    return tup, sorted((j.job_id, j.start_time, j.finish_time) for j in r.jobs)


def _agents(actor=None):
    ja = J.PPOAgent()
    if actor is not None:
        state = ja.state_dict()
        state["params"]["actor"] = actor
        ja.load_state_dict(state)
    ta = T.PPOAgent(device="cpu")
    ta.load_state_dict(ja.state_dict())
    return ja, ta


def test_greedy_run_batch_identical_helios_milp():
    ja, ta = _agents()
    want = _run(J, ja, "helios", 96)
    got = _run(T, ta, "helios", 96)
    assert got == want
    assert want[0][4] > 0                      # the MILP was consulted


def test_greedy_run_batch_identical_philly_deep_window():
    """Philly 512 jobs builds a backlog beyond the 256-job actor window, so
    the tail is scored by the bucketed policy MLP in both packages."""
    ja, ta = _agents()
    js = _CountingScorer(JBucketedScorer(ja.params["actor"]))
    ts = _CountingScorer(TBucketedScorer(ta.params["actor"]))
    want = _run(J, ja, "philly", 512, deep_scorer=js)
    got = _run(T, ta, "philly", 512, deep_scorer=ts)
    assert got == want
    assert ts.rows == js.rows          # the same tail, decision by decision
    # PPOAgent() at seed 0: the deepest queue is 391 jobs (a 135-row tail)
    # and 155 decisions score a tail
    assert (len(ts.rows), 256 + max(ts.rows)) == (155, 391)
    assert ts.inner.compiled_buckets == js.inner.compiled_buckets == (256,)


def _near_tie_consistent(order, logits, tol) -> bool:
    """``order`` (indices, best first) never puts a row ahead of one whose
    logit is more than ``tol`` higher: equal to the stable argsort of
    ``logits`` up to reordering inside groups closer than ``tol``."""
    seq = np.asarray(logits, np.float64)[np.asarray(order)]
    later_max = np.maximum.accumulate(seq[::-1])[::-1]
    return bool(np.all(later_max - seq <= tol))


@pytest.mark.parametrize("weights", ["reference_init", "unit_scale"])
@pytest.mark.parametrize("depth", [300, 2560])
def test_deep_window_rank_identical(weights, depth):
    """One ranking of a deep queue (head by the actor, tail by the bucketed
    scorer) on a partly busy Philly cluster.  The head permutation is
    identical.  So is a 44-row tail; a 2,292-row tail holds f32 logits a
    few ulps apart, and there the two packages' summation orders may swap
    neighbours: it must agree up to groups of logits within 1e-5 (the
    logits' own bound), judged on the reference's logits."""
    from repro.core.features import build_features, sample_features

    ja, ta = _agents(None if weights == "reference_init" else _unit_actor(3))
    orders = []
    for pkg, agent in ((J, ja), (T, ta)):
        from_scorer = (JBucketedScorer if pkg is J else TBucketedScorer)
        pri = pkg.RLPrioritizer(agent, explore=False,
                                deep_scorer=from_scorer(agent.params["actor"]))
        jobs = pkg.generate_trace("philly", depth, seed=1)
        cluster = pkg.ClusterState(pkg.make_cluster("philly"))
        for job in jobs[:12]:
            placement = cluster.find_placement(job, "pack")
            if placement:
                cluster.allocate(job, placement)
        orders.append(pri.rank(jobs[12:], cluster, jobs[-1].submit_time))
        if pkg is J:
            ov, _ = sample_features(build_features(jobs[12:], cluster,
                                                   jobs[-1].submit_time),
                                    cluster)
    n = 256
    assert orders[0][:n] == orders[1][:n]
    assert sorted(orders[1]) == list(range(depth - 12))
    assert orders[1][n:] != list(range(n, depth - 12))   # the tail was scored
    if depth == 300:
        assert orders[0] == orders[1]
    else:
        ref_tail = JBucketedScorer(ja.params["actor"]).score(ov[n:])
        assert _near_tie_consistent(np.asarray(orders[1][n:]) - n, ref_tail,
                                    1e-5)


def test_inspector_prioritizer_identical():
    ja, ta = _agents(None)
    out = []
    for pkg, agent in ((J, ja), (T, ta)):
        pri = pkg.InspectorPrioritizer(agent, pkg.make_policy("sjf"),
                                       explore=False)
        sim = pkg.Simulator(pkg.make_cluster("helios"), allocator="pack")
        r = sim.run_batch(pkg.generate_trace("helios", 96, seed=0), pri)
        out.append(sorted((j.job_id, j.start_time, j.finish_time)
                          for j in r.jobs))
    assert out[0] == out[1]


def test_port_imports_neither_jax_nor_repro():
    """Import the port and every one of its modules in a fresh interpreter:
    no jax* and no repro.* module may be loaded.  Then walk the syntax tree
    of every source in the port: no ``import``/``from`` of jax* or
    repro/repro.* at any depth (a lazy import inside a function, such as
    the chaos imports of the service and the scenarios, never runs at
    import time)."""
    code = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    names.append(m.name)
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
             or m == "repro")
print(len(names), bad)
assert not bad, bad
for name in ("repro_torch.kernels.policy_mlp", "repro_torch.kernels.predict_mlp",
             "repro_torch.predict", "repro_torch.sched.service",
             "repro_torch.chaos", "repro_torch.configs",
             "repro_torch.kernels.flash_attention",
             "repro_torch.kernels.ssd_scan", "repro_torch.kernels.moe_router",
             "repro_torch.models.lm", "repro_torch.serve.engine",
             "repro_torch.launch.serve", "repro_torch.rl",
             "repro_torch.rl.batch", "repro_torch.rl.episodes",
             "repro_torch.rl.trainer", "repro_torch.core.trainer",
             "repro_torch.core.live", "repro_torch.lifecycle.preemption",
             "repro_torch.lifecycle.migration", "repro_torch.scale.autoscaler",
             "repro_torch.fed.federation", "repro_torch.fed.router",
             "repro_torch.fed.scenarios", "repro_torch.obs.metrics",
             "repro_torch.obs.tracer", "repro_torch.obs.audit",
             "repro_torch.obs.report", "repro_torch.data.lm_data",
             "repro_torch.train.optimizer", "repro_torch.train.step",
             "repro_torch.ckpt.checkpoint", "repro_torch.ckpt._msgpack",
             "repro_torch.launch.train", "repro_torch.launch.mesh",
             "repro_torch.launch.roofline"):
    assert name in names, name
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("[]")
    # imports inside functions run only when called: read every source too
    bad = []
    root = os.path.join(REPO, "src", "repro_torch")
    for dirpath, _, files in os.walk(root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            for node in ast.walk(ast.parse(open(path).read(), path)):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                else:
                    continue
                bad += [f"{path}:{node.lineno} {m}" for m in mods
                        if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_port_benchmarks_import_neither_jax_nor_repro():
    """Every module of ``benchmarks_torch`` imported in a fresh interpreter
    loads no jax*, no repro.* and none of the reference's ``benchmarks``;
    and no source there imports them at any depth."""
    code = r"""
import importlib, pkgutil, sys
import benchmarks_torch
names = ["benchmarks_torch"] + [
    m.name for m in pkgutil.walk_packages(benchmarks_torch.__path__,
                                          "benchmarks_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro", "benchmarks")
             or m.startswith(("jax.", "jaxlib", "repro.", "benchmarks.")))
print(len(names), bad)
assert not bad, bad
for name in ("common", "run", "bench_latency", "bench_variability",
             "bench_naive_vs_pro", "bench_util", "bench_transfer",
             "bench_qssf", "bench_policies", "bench_prediction",
             "bench_rl_streaming", "bench_streaming", "bench_scale_curve",
             "bench_preemption", "bench_autoscaling", "bench_federation",
             "bench_obs", "bench_chaos"):
    assert "benchmarks_torch." + name in names, name
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("[]")
    bad = []
    root = os.path.join(REPO, "benchmarks_torch")
    for dirpath, _, files in os.walk(root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            for node in ast.walk(ast.parse(open(path).read(), path)):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                else:
                    continue
                bad += [f"{path}:{node.lineno} {m}" for m in mods
                        if m.split(".")[0] in ("jax", "jaxlib", "repro",
                                               "benchmarks")]
    assert not bad, bad


def test_port_examples_import_neither_jax_nor_repro():
    """Every example of ``examples_torch`` imported in a fresh interpreter
    loads no jax*, no repro.* and nothing of the reference's ``benchmarks``
    or ``examples``; and no source there imports them at any depth."""
    code = r"""
import importlib, sys
names = ["examples_torch"] + ["examples_torch." + n for n in
         ("quickstart", "cluster_failover", "serve_lm", "train_lm")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro", "benchmarks", "examples")
             or m.startswith(("jax.", "jaxlib", "repro.", "benchmarks.",
                              "examples.")))
print(len(names), bad)
assert not bad, bad
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("[]")
    bad, seen = [], 0
    root = os.path.join(REPO, "examples_torch")
    for dirpath, _, files in os.walk(root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            seen += 1
            path = os.path.join(dirpath, fname)
            for node in ast.walk(ast.parse(open(path).read(), path)):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                else:
                    continue
                bad += [f"{path}:{node.lineno} {m}" for m in mods
                        if m.split(".")[0] in ("jax", "jaxlib", "repro",
                                               "benchmarks", "examples")]
    assert seen == 5 and not bad, (seen, bad)


def test_chip_smoke_imports_neither_jax_nor_repro():
    """chip_smoke.py drives only the port: its source names no JAX module
    and no module of the JAX package, and with no CUDA card visible it fails
    before printing any result."""
    path = os.path.join(REPO, "chip_smoke.py")
    src = open(path).read()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            mod = words[1]
            assert not mod.startswith(("jax", "repro.")) and mod != "repro", line
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, path], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_port_data_files_are_package_data():
    """Every ``data/`` directory of the port that holds data files (not the
    ``repro_torch.data`` package, which is code) is listed in
    pyproject.toml's package data, and its glob matches the files on disk,
    so a non-editable install carries them (the trace-replay scenario reads
    ``repro_torch/sched/data/trace_small.csv``)."""
    import glob
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        package_data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    src = os.path.join(REPO, "src")
    data_dirs = sorted(dirpath for dirpath, _, files in
                       os.walk(os.path.join(src, "repro_torch"))
                       if os.path.basename(dirpath) == "data"
                       and "__init__.py" not in files)
    assert data_dirs, "the port has no data directory"
    for path in data_dirs:
        package = os.path.relpath(os.path.dirname(path), src).replace(os.sep,
                                                                      ".")
        globs = [g for g in package_data.get(package, [])
                 if g.startswith("data/")]
        assert globs, f"{package} lists no data/ files in package-data"
        on_disk = {os.path.basename(f) for f in os.listdir(path)
                   if os.path.isfile(os.path.join(path, f))}
        matched = {os.path.basename(f) for g in globs
                   for f in glob.glob(os.path.join(src, *package.split("."), g))}
        assert on_disk and on_disk <= matched, (package, on_disk - matched)
    assert "trace_small.csv" in os.listdir(os.path.join(src, "repro_torch",
                                                        "sched", "data"))
