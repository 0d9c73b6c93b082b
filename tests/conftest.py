"""Shared fixtures.  NOTE: device count stays 1 here (smoke tests / benches
must see one device); multi-device tests spawn subprocesses with their own
XLA_FLAGS per the dry-run contract."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def hypothesis_or_stubs():
    """Import (given, settings, st) from hypothesis, or — on minimal installs
    without the [test] extra — return stand-ins that keep the module
    collectable and mark each property test as skipped."""
    try:
        from hypothesis import given, settings
        from hypothesis import strategies as st
        return given, settings, st
    except ImportError:
        skip = pytest.mark.skip(reason="hypothesis not installed")

        def given(*a, **kw):
            def deco(fn):
                @skip
                def stub():
                    raise AssertionError("skipped: hypothesis missing")
                stub.__name__ = fn.__name__
                stub.__doc__ = fn.__doc__
                return stub
            return deco

        def settings(*a, **kw):
            return lambda fn: fn

        class _Strategies:
            def __getattr__(self, name):
                return lambda *a, **kw: None

        return given, settings, _Strategies()


def run_py(code: str, devices: int = 0, timeout: int = 600) -> str:
    """Run a python snippet in a subprocess (optionally with N fake devices)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=timeout)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    return out.stdout


@pytest.fixture(scope="session")
def helios_jobs():
    from repro.core import generate_trace
    return generate_trace("helios", 256, seed=0)


@pytest.fixture(scope="session")
def helios_cluster():
    from repro.core import make_cluster
    return make_cluster("helios")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skips "
        "without one")
