"""Binding and wrapper of the Mamba2 SSD chunk-parallel scan in CUDA.

``csrc/ssd_scan.cu`` holds the kernels (they replace the Pallas kernel
``repro/kernels/ssd_scan.py::ssd_scan_bh`` and the final-state and
initial-state terms of its wrapper; its source note gives the bound and the
design).  One call launches ``kernels_per_call()`` CUDA kernels: chunk
states, state passing, outputs.  ``nvcc_build`` compiles the source for
``sm_90a`` at first use and loads it with ``ctypes``; nothing is built when
this module is imported.

``ssd_scan`` takes CUDA tensors only and always launches the kernels;
``launches`` counts those calls (the CPU path is ``ref.ssd_scan_ref``,
chosen by ``ops.ssd_scan``).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels.nvcc_build import CudaLibrary, check_arg

#: calls of ``ssd_scan`` that launched its kernels since the process started
#: (or since a caller last reset it to 0)
launches = 0
#: held around each increment, so that launches from several host threads
#: at once (a federation stepping its members in parallel) all count
_count_lock = threading.Lock()

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_limits: tuple[int, int, int] = (0, 0, 0)


def _declare(lib: ctypes.CDLL) -> None:
    global _limits
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_scratch_bytes.argtypes = [i32] * 6
    lib.ssd_scan_scratch_bytes.restype = ctypes.c_longlong
    for name in ("ssd_scan_max_p", "ssd_scan_max_n",
                 "ssd_scan_kernels_per_call"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    _limits = (lib.ssd_scan_max_p(), lib.ssd_scan_max_n(),
               lib.ssd_scan_kernels_per_call())


_LIBRARY = CudaLibrary("ssd_scan", _declare)
SOURCE = _LIBRARY.source


def library_path() -> Path:
    return _LIBRARY.path()


def build() -> float:
    """Compile the kernel library if it is not built yet and load it.

    Returns the seconds spent (0.0 when it was already loaded)."""
    return _LIBRARY.load()


def kernels_per_call() -> int:
    """CUDA kernels one ``ssd_scan`` call launches (builds the library)."""
    build()
    return _limits[2]


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bs: torch.Tensor, Cs: torch.Tensor,
             init_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan on the GPU: xh (B, L, H, P) and Bs/Cs (B, L, N), all f32 or
    all bf16; dt (B, L, H), A (H,) and init_state (B, H, P, N) f32 ->
    (y (B, L, H, P) in xh's dtype, final state (B, H, P, N) f32).

    Launches on the current stream of ``xh``'s device without
    synchronising.  Raises on anything the kernel does not take."""
    global launches
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan kernel needs CUDA tensors, got {xh.device}")
    if xh.dim() != 4 or Bs.dim() != 3:
        raise ValueError("ssd_scan: xh must be 4-D and Bs 3-D")
    if xh.dtype not in DTYPES:
        raise TypeError(f"ssd_scan: dtype {xh.dtype}, expected torch.float32 "
                        "or torch.bfloat16")
    B, L, H, P = xh.shape
    N = Bs.shape[-1]
    dev = xh.device
    f32 = torch.float32
    args = [("xh", xh, (B, L, H, P), xh.dtype), ("dt", dt, (B, L, H), f32),
            ("A", A, (H,), f32), ("Bs", Bs, (B, L, N), xh.dtype),
            ("Cs", Cs, (B, L, N), xh.dtype)]
    if init_state is not None:
        args.append(("init_state", init_state, (B, H, P, N), f32))
    for name, t, shape, dtype in args:
        check_arg("ssd_scan", name, t, shape, dev, dtype)
    lib = _LIBRARY.lib
    max_p, max_n, _ = _limits
    if (min(B, L, H, P, N) < 1 or P > max_p or N > max_n or B > 65535
            or H > 65535):
        raise ValueError(f"ssd_scan: (B, L, H, P, N) = {(B, L, H, P, N)} "
                         f"outside P <= {max_p}, N <= {max_n}")
    y = torch.empty_like(xh)
    state = torch.empty((B, H, P, N), dtype=f32, device=dev)
    scratch = torch.empty(
        (lib.ssd_scan_scratch_bytes(B, L, H, P, N, DTYPES[xh.dtype]),),
        dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ssd_scan_launch(
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bs.data_ptr(),
        Cs.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), scratch.data_ptr(), B, L, H, P, N,
        DTYPES[xh.dtype], dev.index, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return y, state
