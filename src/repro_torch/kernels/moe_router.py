"""Binding and wrapper of the fused MoE-router CUDA kernels.

``csrc/moe_router.cu`` holds the kernels (they replace the Pallas kernel
``repro/kernels/moe_router.py::moe_router``; its source note gives the
bound and the design).  A call takes one of three routes (``ROUTES``), by
its token count, dtype and width: ``split`` (d split over blocks, then a
top-k kernel; decode), ``mma`` (bf16 x on the tensor cores against W split
into three exact bf16 parts; prefill) or ``tiled`` (SIMT register tiles;
f32 prefill).  One call launches ``kernels_per_call(...)`` CUDA kernels.
``nvcc_build`` compiles the source for ``sm_90a`` at first use and loads it
with ``ctypes``; nothing is built when this module is imported.

``moe_router`` takes CUDA tensors only and always launches the kernels;
``launches`` counts those calls (the CPU path is ``ref.moe_router_ref``,
chosen by ``ops.moe_router``).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels.nvcc_build import CudaLibrary, check_arg

#: calls of ``moe_router`` that launched its kernels since the process
#: started (or since a caller last reset it to 0)
launches = 0
#: held around each increment, so that launches from several host threads
#: at once (a federation stepping its members in parallel) all count
_count_lock = threading.Lock()

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel library's route numbers
ROUTES = {"split": 0, "tiled": 1, "mma": 2}
_max_e = 0


def _declare(lib: ctypes.CDLL) -> None:
    global _max_e
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.moe_router_launch.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.moe_router_launch.restype = i32
    lib.moe_router_path.argtypes = [i32] * 5
    lib.moe_router_path.restype = i32
    lib.moe_router_kernels.argtypes = [i32]
    lib.moe_router_kernels.restype = i32
    lib.moe_router_scratch_bytes.argtypes = [i32] * 4
    lib.moe_router_scratch_bytes.restype = ctypes.c_longlong
    lib.moe_router_max_e.argtypes = []
    lib.moe_router_max_e.restype = i32
    _max_e = lib.moe_router_max_e()


_LIBRARY = CudaLibrary("moe_router", _declare)
SOURCE = _LIBRARY.source


def library_path() -> Path:
    return _LIBRARY.path()


def build() -> float:
    """Compile the kernel library if it is not built yet and load it.

    Returns the seconds spent (0.0 when it was already loaded)."""
    return _LIBRARY.load()


def route(T: int, d: int = 4096, E: int = 16,
          dtype: torch.dtype = torch.bfloat16) -> str:
    """The route a call on a contiguous, 16-byte aligned x (T, d) of
    ``dtype`` and E experts takes (builds the library)."""
    path = _LIBRARY.lib.moe_router_path(T, d, E, DTYPES[dtype], 1)
    return next(name for name, n in ROUTES.items() if n == path)


def kernels_per_call(T: int, d: int = 4096, E: int = 16,
                     dtype: torch.dtype = torch.bfloat16) -> int:
    """CUDA kernels one ``moe_router`` call launches at that shape (builds
    the library): 2 on the split and mma routes, 1 on the tiled one."""
    return _LIBRARY.lib.moe_router_kernels(ROUTES[route(T, d, E, dtype)])


def moe_router(x: torch.Tensor, router_w: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Router on the GPU: x (T, d) f32 or bf16, router_w (d, E) f32 ->
    (weights (T, k) f32, expert indices (T, k) int32).

    Launches on the current stream of ``x``'s device without synchronising.
    Raises on anything the kernels do not take."""
    return run(x, router_w, k)


def run(x: torch.Tensor, router_w: torch.Tensor, k: int,
        path: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_router`` on the route ``path`` (one of ``ROUTES``; None: the
    library's choice).  A route that does not take the call raises."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"moe_router kernel needs CUDA tensors, got {x.device}")
    if x.dim() != 2 or router_w.dim() != 2:
        raise ValueError("moe_router: x and router_w must be 2-D")
    if x.dtype not in DTYPES:
        raise TypeError(f"moe_router: dtype {x.dtype}, expected torch.float32 "
                        "or torch.bfloat16")
    T, d = x.shape
    E = router_w.shape[1]
    dev = x.device
    check_arg("moe_router", "x", x, (T, d), dev, x.dtype)
    check_arg("moe_router", "router_w", router_w, (d, E), dev)
    lib = _LIBRARY.lib
    if min(T, d, E, k) < 1 or E > _max_e or k > E:
        raise ValueError(f"moe_router: (T, d, E, k) = {(T, d, E, k)} outside "
                         f"E <= {_max_e}, 1 <= k <= E")
    dtype = DTYPES[x.dtype]
    n = (lib.moe_router_path(T, d, E, dtype, int(x.data_ptr() % 16 == 0))
         if path is None else ROUTES[path])
    weights = torch.empty((T, k), dtype=torch.float32, device=dev)
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    scratch = torch.empty((lib.moe_router_scratch_bytes(T, d, E, n),),
                          dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.moe_router_launch(x.data_ptr(), router_w.data_ptr(),
                                weights.data_ptr(), idx.data_ptr(),
                                scratch.data_ptr(), T, d, E, k, dtype, n,
                                dev.index, stream)
    if err != 0:
        raise RuntimeError(f"moe_router kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return weights, idx
