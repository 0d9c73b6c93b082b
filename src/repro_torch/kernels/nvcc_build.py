"""Build, load and argument checks of the port's hand-written CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface.  At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/`` beside this module, named by the source's content hash (so
an edited source is rebuilt and an unchanged one is reused), and loaded with
``ctypes``.  Nothing is built or loaded when a module is imported.
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
from typing import Callable

import torch

CSRC_DIR = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA "
                           "toolkit to build")
    return str(path)


class CudaLibrary:
    """The shared library of one kernel source, built and loaded once.

    ``declare(lib)`` runs once right after loading: it sets the ``argtypes``
    and ``restype`` of the library's C functions (and may read constants
    from it)."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self._declare = declare
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    @property
    def lib(self) -> ctypes.CDLL:
        """The loaded library (built first if needed)."""
        if self._lib is None:
            self.load()
        return self._lib

    def load(self) -> float:
        """Compile the library if it is not built yet and load it.

        Returns the seconds spent (0.0 when it was already loaded)."""
        with self._lock:
            if self._lib is not None:
                return 0.0
            t0 = time.perf_counter()
            path = self.path()
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp,
                                           str(self.source)],
                                          capture_output=True, text=True)
                    if proc.returncode != 0:
                        raise RuntimeError(f"nvcc failed on {self.source}:\n"
                                           f"{proc.stdout}{proc.stderr}")
                    os.replace(tmp, path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(str(path))
            self._declare(lib)
            self._lib = lib
            return time.perf_counter() - t0


def check_arg(kernel: str, name: str, t: torch.Tensor,
              shape: tuple[int, ...], device: torch.device) -> None:
    """Raise unless tensor ``t`` is contiguous float32 of ``shape`` on
    ``device``: what every kernel wrapper checks before a launch."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected "
                        "torch.float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")
