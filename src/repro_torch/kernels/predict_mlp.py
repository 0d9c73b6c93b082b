"""Binding and wrapper of the fused runtime-predictor MLP CUDA kernel.

``csrc/predict_mlp.cu`` holds the kernel (it replaces the Pallas kernel
``repro/kernels/predict_mlp.py::predict_mlp``; its source note gives the
bound and the design).  ``nvcc_build`` compiles it for ``sm_90a`` at first
use and loads it with ``ctypes``; nothing is built when this module is
imported.

``predict_mlp`` takes CUDA tensors only and always launches the kernel;
``launches`` counts those launches (the CPU path is ``ref.predict_mlp_ref``,
chosen by ``ops.predict_mlp``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.nvcc_build import CudaLibrary, check_arg

#: kernel launches made by ``predict_mlp`` since the process started (or
#: since a caller last reset it to 0)
launches = 0

_limits: tuple[int, int, int, int] = (0, 0, 0, 0)


def _declare(lib: ctypes.CDLL) -> None:
    global _limits
    ptr = ctypes.c_void_p
    lib.predict_mlp_launch.argtypes = [ptr] * 8 + [ctypes.c_int] * 6 + [ptr]
    lib.predict_mlp_launch.restype = ctypes.c_int
    names = ("predict_mlp_max_f", "predict_mlp_max_h1", "predict_mlp_max_h2",
             "predict_mlp_max_q")
    for name in names:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    _limits = tuple(getattr(lib, name)() for name in names)


_LIBRARY = CudaLibrary("predict_mlp", _declare)
SOURCE = _LIBRARY.source


def library_path() -> Path:
    return _LIBRARY.path()


def build() -> float:
    """Compile the kernel library if it is not built yet and load it.

    Returns the seconds spent (0.0 when it was already loaded)."""
    return _LIBRARY.load()


def predict_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                b3: torch.Tensor) -> torch.Tensor:
    """Per-quantile log-runtime residuals on the GPU: x (B, F); w1 (F, H1);
    b1 (H1,); w2 (H1, H2); b2 (H2,); w3 (H2, Q); b3 (Q,) -> (B, Q) f32.

    Launches on the current stream of ``x``'s device without synchronising.
    Raises on anything the kernel does not take."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"predict_mlp kernel needs CUDA tensors, got {x.device}")
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2 or w3.dim() != 2:
        raise ValueError("predict_mlp: x, w1, w2 and w3 must be 2-D")
    B, F = x.shape
    H1, H2, Q = w1.shape[1], w2.shape[1], w3.shape[1]
    dev = x.device
    for name, t, shape in (("x", x, (B, F)), ("w1", w1, (F, H1)),
                           ("b1", b1, (H1,)), ("w2", w2, (H1, H2)),
                           ("b2", b2, (H2,)), ("w3", w3, (H2, Q)),
                           ("b3", b3, (Q,))):
        check_arg("predict_mlp", name, t, shape, dev)
    lib = _LIBRARY.lib
    max_f, max_h1, max_h2, max_q = _limits
    if B < 1 or not (1 <= F <= max_f and 1 <= H1 <= max_h1
                     and 1 <= H2 <= max_h2 and 1 <= Q <= max_q):
        raise ValueError(f"predict_mlp: (B, F, H1, H2, Q) = "
                         f"{(B, F, H1, H2, Q)} outside B >= 1, F <= {max_f}, "
                         f"H1 <= {max_h1}, H2 <= {max_h2}, Q <= {max_q}")
    out = torch.empty((B, Q), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.predict_mlp_launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        B, F, H1, H2, Q, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"predict_mlp kernel launch failed: CUDA error {err}")
    launches += 1
    return out
