"""Binding and wrapper of the flash-attention CUDA kernel.

``csrc/flash_attention.cu`` holds the kernel (it replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_bh`` and the GQA repeat
and head-dim padding of its wrapper; its source note gives the bound and the
design).  ``nvcc_build`` compiles it for ``sm_90a`` at first use and loads
it with ``ctypes``; nothing is built when this module is imported.

``flash_attention`` takes CUDA tensors only and always launches a kernel,
chosen by dtype with no fallback between them: bf16 runs on the tensor
cores (``mma.sync``) in the instantiated head width ``head_width(D)``, f32
on IEEE FMAs.  ``launches`` counts those launches (the CPU path is
``ref.flash_attention_ref``, chosen by ``ops.flash_attention``).
"""
from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path

import torch

from repro_torch.kernels.nvcc_build import CudaLibrary, check_arg

#: kernel launches made by ``flash_attention`` since the process started (or
#: since a caller last reset it to 0)
launches = 0
#: held around each increment, so that launches from several host threads
#: at once (a federation stepping its members in parallel) all count
_count_lock = threading.Lock()

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head widths the bf16 kernel is instantiated for (64: stablelm, granite,
#: whisper; 80: h2o-danube; 128: jamba, qwen3, yi, nemotron, internvl2)
HEAD_WIDTHS = (64, 80, 128)


def head_width(D: int) -> int:
    """The instantiated head width the bf16 kernel runs a head dim ``D`` in:
    ``D`` itself where it is instantiated, else the next one up (the dims
    past ``D`` are zero-filled in shared memory).  Raises for D < 1 or
    D > 128."""
    for width in HEAD_WIDTHS:
        if 1 <= D <= width:
            return width
    raise ValueError(f"flash_attention: head dim {D} outside 1 <= D <= "
                     f"{HEAD_WIDTHS[-1]}")


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = ([ptr] * 4 + [i32] * 8
                                           + [ctypes.c_float, i32, i32, ptr])
    lib.flash_attention_launch.restype = i32


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
    dtype.  ``window`` > 0 keeps keys j > i - window.  bf16 runs on the
    tensor cores, f32 on IEEE FMAs.

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
    width = head_width(D)
    if min(B, H, KV, L) < 1 or H % KV or window < 0 or max(B, H) > 65535:
        raise ValueError(f"flash_attention: (B, H, KV, L, window) = "
                         f"{(B, H, KV, L, window)} outside H % KV == 0, "
                         f"window >= 0")
    lib = _LIBRARY.lib
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV, L,
        D, width, int(causal), window, 1.0 / math.sqrt(D), DTYPES[q.dtype],
        dev.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        launches += 1
    return out
