"""Nothing a run loads is JAX, the JAX package or the program's benches,
compared by whole top-level name; the reference imports nothing of the
program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from perfbench import run

PERFBENCH = Path(__file__).resolve().parents[1]


def test_top_level_names_compared_whole():
    names = ["repro_torch", "repro_torch.sched.engine", "repro", "repro.core",
             "jax", "jax.numpy", "jaxlib", "flax.linen", "benchmarks",
             "benchmarks_torch.common", "reprox", "jax_extra", "numpy"]
    assert run.forbidden_modules(names) == sorted(
        ["repro", "repro.core", "jax", "jax.numpy", "jaxlib", "flax.linen",
         "benchmarks", "benchmarks_torch.common"])


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    for path in (PERFBENCH / "reference").glob("*.py"):
        assert not _imports(path) & {"repro_torch", "repro", "jax",
                                     "jaxlib", "flax", "torch"}, path


def test_benchmark_sources_import_no_forbidden_module():
    for path in PERFBENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & set(run.FORBIDDEN), path


def test_a_run_loads_no_forbidden_module(checkout):
    code = (
        "import sys, torch; from pathlib import Path; "
        "torch.set_num_threads(1); from perfbench import run; "
        f"r, _ = run.measure(Path({str(checkout)!r}), 'small', 3, 0.05, "
        "False, torch.device('cpu')); "
        "assert r['correct'], r; print(run.forbidden_modules())")
    root = PERFBENCH.parent
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root,
                         env={"PYTHONPATH": f"{root}:{root / 'src'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
