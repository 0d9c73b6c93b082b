"""Build, binding and wrapper of the fused policy-MLP CUDA kernel.

``csrc/policy_mlp.cu`` holds the kernel (it replaces the Pallas kernel
``repro/kernels/policy_mlp.py::policy_mlp``; its source note gives the bound
and the design).  It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, cached under ``build/`` beside
this module by the source's content hash, and loaded with ``ctypes``.
Nothing is built or loaded when the module is imported.

``policy_mlp`` takes CUDA tensors only and always launches the kernel;
``launches`` counts those launches (the CPU path is ``ref.policy_mlp_ref``,
chosen by ``ops.policy_mlp``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).with_name("csrc") / "policy_mlp.cu"
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: kernel launches made by ``policy_mlp`` since the process started (or since
#: a caller last reset it to 0)
launches = 0

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()
_limits: tuple[int, int, int] = (0, 0, 0)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the policy_mlp kernel needs the "
                           "CUDA toolkit to build")
    return str(path)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpolicy_mlp-{digest}.so"


def build() -> float:
    """Compile the kernel library if it is not built yet and load it.

    Returns the seconds spent (0.0 when it was already loaded)."""
    global _lib, _limits
    with _lib_lock:
        if _lib is not None:
            return 0.0
        t0 = time.perf_counter()
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                       str(SOURCE)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {SOURCE}:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(path))
        ptr = ctypes.c_void_p
        lib.policy_mlp_launch.argtypes = [ptr] * 9 + [ctypes.c_int] * 5 + [ptr]
        lib.policy_mlp_launch.restype = ctypes.c_int
        for name in ("policy_mlp_max_f", "policy_mlp_max_h1",
                     "policy_mlp_max_h2"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        _limits = (lib.policy_mlp_max_f(), lib.policy_mlp_max_h1(),
                   lib.policy_mlp_max_h2())
        _lib = lib
        return time.perf_counter() - t0


def _check(name: str, t: torch.Tensor, shape: tuple[int, ...],
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"policy_mlp: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != torch.float32:
        raise TypeError(f"policy_mlp: {name} has dtype {t.dtype}, expected "
                        "torch.float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"policy_mlp: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"policy_mlp: {name} is not contiguous")


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
        _check(name, t, shape, dev)
    build()
    max_f, max_h1, max_h2 = _limits
    if Q < 1 or not (1 <= F <= max_f and 1 <= H1 <= max_h1
                     and 1 <= H2 <= max_h2):
        raise ValueError(f"policy_mlp: (Q, F, H1, H2) = {(Q, F, H1, H2)} "
                         f"outside Q >= 1, F <= {max_f}, H1 <= {max_h1}, "
                         f"H2 <= {max_h2}")
    out = torch.empty((Q,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib.policy_mlp_launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), mask.data_ptr(),
        out.data_ptr(), Q, F, H1, H2, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"policy_mlp kernel launch failed: CUDA error {err}")
    launches += 1
    return out
