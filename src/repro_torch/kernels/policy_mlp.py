"""Binding and wrapper of the fused policy-MLP CUDA kernel.

``csrc/policy_mlp.cu`` holds the kernel (it replaces the Pallas kernel
``repro/kernels/policy_mlp.py::policy_mlp``; its source note gives the bound
and the design).  ``nvcc_build`` compiles it for ``sm_90a`` at first use and
loads it with ``ctypes``; nothing is built when this module is imported.

``policy_mlp`` takes CUDA tensors only and always launches the kernel;
``launches`` counts those launches (the CPU path is ``ref.policy_mlp_ref``,
chosen by ``ops.policy_mlp``).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels.nvcc_build import CudaLibrary, check_arg

#: kernel launches made by ``policy_mlp`` since the process started (or since
#: a caller last reset it to 0)
launches = 0
#: held around each increment, so that launches from several host threads
#: at once (a federation stepping its members in parallel) all count
_count_lock = threading.Lock()

_limits: tuple[int, int, int] = (0, 0, 0)


def _declare(lib: ctypes.CDLL) -> None:
    global _limits
    ptr = ctypes.c_void_p
    lib.policy_mlp_launch.argtypes = [ptr] * 9 + [ctypes.c_int] * 5 + [ptr]
    lib.policy_mlp_launch.restype = ctypes.c_int
    for name in ("policy_mlp_max_f", "policy_mlp_max_h1", "policy_mlp_max_h2"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    _limits = (lib.policy_mlp_max_f(), lib.policy_mlp_max_h1(),
               lib.policy_mlp_max_h2())


_LIBRARY = CudaLibrary("policy_mlp", _declare)
SOURCE = _LIBRARY.source


def library_path() -> Path:
    return _LIBRARY.path()


def build() -> float:
    """Compile the kernel library if it is not built yet and load it.

    Returns the seconds spent (0.0 when it was already loaded)."""
    return _LIBRARY.load()


def policy_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
               b3: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked actor logits on the GPU: x (Q, F); w1 (F, H1); b1 (H1,);
    w2 (H1, H2); b2 (H2,); w3 (H2, 1); b3 (1,); mask (Q,) -> (Q,) f32.

    Launches on the current stream of ``x``'s device without synchronising.
    Raises on anything the kernel does not take."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"policy_mlp kernel needs CUDA tensors, got {x.device}")
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("policy_mlp: x, w1 and w2 must be 2-D")
    Q, F = x.shape
    H1, H2 = w1.shape[1], w2.shape[1]
    dev = x.device
    for name, t, shape in (("x", x, (Q, F)), ("w1", w1, (F, H1)),
                           ("b1", b1, (H1,)), ("w2", w2, (H1, H2)),
                           ("b2", b2, (H2,)), ("w3", w3, (H2, 1)),
                           ("b3", b3, (1,)), ("mask", mask, (Q,))):
        check_arg("policy_mlp", name, t, shape, dev)
    lib = _LIBRARY.lib
    max_f, max_h1, max_h2 = _limits
    if Q < 1 or not (1 <= F <= max_f and 1 <= H1 <= max_h1
                     and 1 <= H2 <= max_h2):
        raise ValueError(f"policy_mlp: (Q, F, H1, H2) = {(Q, F, H1, H2)} "
                         f"outside Q >= 1, F <= {max_f}, H1 <= {max_h1}, "
                         f"H2 <= {max_h2}")
    out = torch.empty((Q,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.policy_mlp_launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), mask.data_ptr(),
        out.data_ptr(), Q, F, H1, H2, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"policy_mlp kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out
