"""Binding and wrapper of the flash-attention CUDA kernel.

``csrc/flash_attention.cu`` holds the kernel (it replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_bh`` and the GQA repeat
and head-dim padding of its wrapper; its source note gives the bound and the
design).  ``nvcc_build`` compiles it for ``sm_90a`` at first use and loads
it with ``ctypes``; nothing is built when this module is imported.

``flash_attention`` takes CUDA tensors only and always launches the kernel;
``launches`` counts those launches (the CPU path is
``ref.flash_attention_ref``, chosen by ``ops.flash_attention``).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.nvcc_build import CudaLibrary, check_arg

#: kernel launches made by ``flash_attention`` since the process started (or
#: since a caller last reset it to 0)
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_max_d = 0


def _declare(lib: ctypes.CDLL) -> None:
    global _max_d
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = ([ptr] * 4 + [i32] * 7
                                           + [ctypes.c_float, i32, i32, ptr])
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_max_d.argtypes = []
    lib.flash_attention_max_d.restype = i32
    _max_d = lib.flash_attention_max_d()


_LIBRARY = CudaLibrary("flash_attention", _declare)
SOURCE = _LIBRARY.source


def library_path() -> Path:
    return _LIBRARY.path()


def build() -> float:
    """Compile the kernel library if it is not built yet and load it.

    Returns the seconds spent (0.0 when it was already loaded)."""
    return _LIBRARY.load()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention on the GPU: q (B, H, L, D); k, v (B, KV, L, D), H a
    multiple of KV, D <= 128, all f32 or all bf16 -> (B, H, L, D) in q's
    dtype.  ``window`` > 0 keeps keys j > i - window.

    Launches on the current stream of ``q``'s device without synchronising.
    Raises on anything the kernel does not take."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-D")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype}, expected "
                        "torch.float32 or torch.bfloat16")
    B, H, L, D = q.shape
    KV = k.shape[1]
    dev = q.device
    for name, t, shape in (("q", q, (B, H, L, D)), ("k", k, (B, KV, L, D)),
                           ("v", v, (B, KV, L, D))):
        check_arg("flash_attention", name, t, shape, dev, q.dtype)
    lib = _LIBRARY.lib
    if (min(B, H, KV, L, D) < 1 or H % KV or D > _max_d or window < 0
            or max(B, H) > 65535):
        raise ValueError(f"flash_attention: (B, H, KV, L, D, window) = "
                         f"{(B, H, KV, L, D, window)} outside H % KV == 0, "
                         f"D <= {_max_d}, window >= 0")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV, L,
        D, int(causal), window, 1.0 / math.sqrt(D), DTYPES[q.dtype],
        dev.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
