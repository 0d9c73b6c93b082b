"""The five kernel wrappers count their launches exactly when several host
threads launch at once, as a federation stepping its members in parallel
does (``FederatedScheduler(parallel=True)``).

Here, without a card, each wrapper runs with its library, its tensors and
the few ``torch`` calls it makes on the device stubbed: the stubbed launch
yields the GIL and returns success, so the threads interleave around the
increment.  The wrappers' argument checks run as they are.  The launches of
the real kernels from several threads are held on the card by
``tests/test_torch_fleet_gpu.py``.  Imports no JAX.
"""
import sys
import threading
import time
import types

import pytest
import torch

from repro_torch.kernels import flash_attention as fa, moe_router as mr
from repro_torch.kernels import policy_mlp as pm, predict_mlp as qm
from repro_torch.kernels import ssd_scan as ss

THREADS = 8
CALLS = 250
CUDA = torch.device("cuda", 0)


class _Tensor:
    """What a wrapper reads of a CUDA tensor: shape, dtype, device,
    contiguity and a 16-byte aligned address."""

    def __init__(self, shape, dtype=torch.float32):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = CUDA

    def dim(self) -> int:
        return len(self.shape)

    def is_contiguous(self) -> bool:
        return True

    def data_ptr(self) -> int:
        return 1 << 12


class _Lib:
    """Every C function of a kernel library: a launch yields the GIL and
    returns 0 (success); a query (route, scratch size) returns 0."""

    def __getattr__(self, name):
        if name.endswith("_launch"):
            def launch(*args):
                time.sleep(0)
                return 0
            return launch
        return lambda *args: 0


class _Torch:
    """``torch`` with the device allocations and the stream query stubbed."""

    cuda = types.SimpleNamespace(
        current_stream=lambda dev: types.SimpleNamespace(cuda_stream=None))

    @staticmethod
    def empty(shape, dtype=torch.float32, device=None):
        return _Tensor(shape, dtype)

    @staticmethod
    def empty_like(t):
        return _Tensor(t.shape, t.dtype)

    def __getattr__(self, name):
        return getattr(torch, name)


def _calls():
    """(module, wrapper, arguments, output shapes) at small shapes."""
    f32, bf16 = torch.float32, torch.bfloat16
    T = _Tensor
    B, L, H, P, N = 1, 64, 4, 16, 8
    return {
        "policy_mlp": (pm, pm.policy_mlp,
                       (T((300, 8)), T((8, 64)), T((64,)), T((64, 32)),
                        T((32,)), T((32, 1)), T((1,)), T((300,))), {},
                       [(300,)]),
        "predict_mlp": (qm, qm.predict_mlp,
                        (T((37, 21)), T((21, 24)), T((24,)), T((24, 12)),
                         T((12,)), T((12, 2)), T((2,))), {}, [(37, 2)]),
        "flash_attention": (fa, fa.flash_attention,
                            (T((1, 4, 32, 64), bf16), T((1, 2, 32, 64), bf16),
                             T((1, 2, 32, 64), bf16)), {"causal": True},
                            [(1, 4, 32, 64)]),
        "ssd_scan": (ss, ss.ssd_scan,
                     (T((B, L, H, P), f32), T((B, L, H)), T((H,)),
                      T((B, L, N)), T((B, L, N))), {},
                     [(B, L, H, P), (B, H, P, N)]),
        "moe_router": (mr, mr.moe_router, (T((6, 64), bf16), T((64, 16)), 2),
                       {}, [(6, 2), (6, 2)]),
    }


@pytest.mark.parametrize("kernel", sorted(_calls()))
def test_launch_count_exact_under_threads(kernel, monkeypatch):
    mod, fn, args, kwargs, shapes = _calls()[kernel]
    monkeypatch.setattr(mod, "_LIBRARY", types.SimpleNamespace(lib=_Lib()))
    monkeypatch.setattr(mod, "torch", _Torch())
    if hasattr(mod, "_limits"):
        monkeypatch.setattr(mod, "_limits", (1 << 20,) * len(mod._limits))
    if hasattr(mod, "_max_e"):
        monkeypatch.setattr(mod, "_max_e", 1 << 20)
    monkeypatch.setattr(mod, "launches", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    start = threading.Barrier(THREADS)
    outs: list = []
    errors: list = []

    def work():
        try:
            start.wait(timeout=60)
            for _ in range(CALLS):
                out = fn(*args, **kwargs)
                outs.append(out if isinstance(out, tuple) else (out,))
        except Exception as exc:          # reported below, not swallowed
            errors.append(exc)

    try:
        threads = [threading.Thread(target=work) for _ in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert mod.launches == THREADS * CALLS
    assert len(outs) == THREADS * CALLS
    assert all([tuple(o.shape) for o in out] == shapes for out in outs)


def test_wrappers_hold_a_lock_around_the_count():
    for mod in (pm, qm, fa, ss, mr):
        assert isinstance(mod._count_lock, type(threading.Lock()))
        assert "with _count_lock:" in open(mod.__file__).read()
