"""Fault-tolerant checkpointing in the reference's on-disk format: a
msgpack manifest + zlib-compressed leaves, atomic commit, restore onto any
device or, elastically, onto any mesh.

Layout:  <dir>/step_<N>.tmp/  ->  rename  ->  <dir>/step_<N>/
           manifest.msgpack   {step, codec, leaves: {key: {shape, dtype, file}}}
           <leaf-id>.bin      zlib(raw bytes, C-order), stored blocks

Keys are the tree path joined by ``/`` (dict keys, list indices as
numbers), so a tree of the same nesting gives the reference's keys and file
names, and either package reads what the other wrote.  bf16 leaves are
written as their raw 16-bit words under dtype ``"bfloat16"``, as the
reference (numpy + ml_dtypes) writes them.  Writes always use zlib (the
card's machine has no ``zstandard``); reading a ``zstd`` checkpoint needs
the ``zstandard`` package and raises without it, as the reference does.
Leaves are compressed and decompressed on a thread pool (zlib releases the
interpreter lock).

Async save: ``CheckpointManager.maybe_save`` copies every leaf to host
memory before returning — a copy even of CPU tensors, which the train step
updates in place — and a worker thread writes the copy.

Sharded trees (DTensor leaves): every rank gathers each leaf's full array
(``full_tensor``, a collective) and rank 0 alone writes, so the files are
those of the same values saved unsharded.  ``load_checkpoint(...,
mesh=..., spec_tree=...)`` reads the full arrays on every rank and places
each by its spec (``distribute_tensor``): a checkpoint restores onto any
mesh, whatever mesh wrote it.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import shutil
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.ckpt import _msgpack

CODEC = "zlib"
# zlib level of the leaves (any level reads back with zlib.decompress):
# stored blocks.  Trained weights and f32 Adam moments barely compress, and
# deflating them at level 1 runs some 30x slower than storing them (the
# codec line of chip_smoke.py's phase 22 measures both on the card's host).
ZLIB_LEVEL = 0
_WORKERS = min(8, os.cpu_count() or 1)


def _decompress(blob: bytes, codec: str) -> bytes:
    if codec == "zstd":
        try:
            import zstandard
        except ImportError:
            raise RuntimeError("checkpoint was written with zstd; install the "
                               "[compress] extra") from None
        return zstandard.ZstdDecompressor().decompress(blob)
    if codec == "zlib":
        return zlib.decompress(blob)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _map_keyed(fn: Callable[[str, Any], Any], tree, prefix: tuple = ()) -> Any:
    """``fn(key, leaf)`` for every leaf, keeping the nesting; ``key`` is
    the path joined by ``/``."""
    if isinstance(tree, dict):
        return {k: _map_keyed(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_keyed(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def _is_writer() -> bool:
    """Rank 0 of a distributed job, or any process outside one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _at(tree, key: str):
    """The entry of a nested dict/list tree at a ``/``-joined key path (a
    spec tree's leaves are tuples, so they are looked up, not walked)."""
    for part in key.split("/") if key else ():
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _host_copy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(a host copy of the tensor's bytes as numpy, its dtype name); a
    DTensor's full array, gathered on every rank."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _snapshot(tree) -> dict[str, tuple[np.ndarray, str]]:
    flat: dict[str, tuple[np.ndarray, str]] = {}

    def take(key, leaf):
        flat[key] = _host_copy(leaf)

    _map_keyed(take, tree)
    return flat


def _write(path: str, step: int, flat: dict[str, tuple[np.ndarray, str]]
           ) -> str:
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    items = sorted(flat.items())

    def write_leaf(i: int) -> None:
        arr = items[i][1][0]
        with open(os.path.join(tmp, f"{i:05d}.bin"), "wb") as f:
            f.write(zlib.compress(np.ascontiguousarray(arr).tobytes(),
                                  ZLIB_LEVEL))

    with cf.ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        for fut in [pool.submit(write_leaf, i) for i in range(len(items))]:
            fut.result()
    manifest = {key: {"shape": list(arr.shape), "dtype": dtype,
                      "file": f"{i:05d}.bin"}
                for i, (key, (arr, dtype)) in enumerate(items)}
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(_msgpack.packb({"step": step, "codec": CODEC,
                                "leaves": manifest}))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    return final


def save_checkpoint(path: str, step: int, tree) -> str:
    """Synchronous atomic save of a nested dict/list tree of tensors (or
    DTensors: call on every rank; rank 0 writes, and every rank returns
    once the checkpoint is committed).  Returns the committed directory."""
    import torch.distributed as dist
    flat = _snapshot(tree)
    final = os.path.join(path, f"step_{step:08d}")
    if _is_writer():
        _write(path, step, flat)
    if dist.is_initialized():
        dist.barrier()
    return final


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _read_leaf(d: str, meta: dict, codec: str) -> torch.Tensor:
    with open(os.path.join(d, meta["file"]), "rb") as f:
        raw = _decompress(f.read(), codec)
    if meta["dtype"] == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.uint16).copy()
        t = torch.from_numpy(arr).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(meta["dtype"]))
                             .copy())
    return t.reshape(meta["shape"])


def load_checkpoint(path: str, target_tree, step: int | None = None,
                    device: torch.device | str | None = None, mesh=None,
                    spec_tree=None):
    """Restore into the structure and dtypes of ``target_tree`` (a tree of
    tensors, DTensors or meta tensors).  Leaves go to ``device``, or to
    each target leaf's device; with ``mesh`` and ``spec_tree`` (a matching
    tree of specs) each becomes a DTensor on ``mesh`` placed by its spec:
    elastic restore onto any mesh.  Missing keys raise; extra keys in the
    checkpoint are ignored.  Returns (tree, step)."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = _msgpack.unpackb(f.read())
    leaves_meta = manifest["leaves"]
    codec = manifest.get("codec", "zstd")   # pre-fallback checkpoints: zstd

    if mesh is not None:
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.sharding.specs import placements
        if device is None:
            device = mesh.device_type
    keys: list[str] = []
    _map_keyed(lambda key, leaf: keys.append(key), target_tree)
    for key in keys:
        if key not in leaves_meta:
            raise KeyError(f"checkpoint missing leaf {key}")
    with cf.ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        futs = {key: pool.submit(_read_leaf, d, leaves_meta[key], codec)
                for key in keys}

        def place(key, leaf):
            dev = leaf.device if device is None else torch.device(device)
            t = futs[key].result().to(device=dev, dtype=leaf.dtype)
            if mesh is None:
                return t
            return distribute_tensor(t, mesh,
                                     placements(_at(spec_tree, key), mesh))

        return _map_keyed(place, target_tree), manifest["step"]


class CheckpointManager:
    """Periodic async checkpointing with retention + crash-safe restore."""

    def __init__(self, path: str, *, interval: int = 100, keep: int = 3):
        self.path = path
        self.interval = interval
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: cf.Future | None = None
        os.makedirs(path, exist_ok=True)

    def maybe_save(self, step: int, tree) -> bool:
        """At every ``interval``-th step, snapshot ``tree`` (on every rank,
        for a sharded tree) and write it in the background (rank 0)."""
        if step % self.interval != 0:
            return False
        self.wait()
        flat_snapshot = _snapshot(tree)        # host copy before async write
        if not _is_writer():
            return True

        def _write_and_gc():
            _write(self.path, step, flat_snapshot)
            self._gc()

        self._pending = self._pool.submit(_write_and_gc)
        return True

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.path)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore(self, target_tree, device: torch.device | str | None = None,
                mesh=None, spec_tree=None):
        """(tree, step) from the newest checkpoint, or (None, None); with
        ``mesh`` and ``spec_tree``, placed on the mesh (see
        ``load_checkpoint``)."""
        self.wait()
        step = latest_step(self.path)
        if step is None:
            return None, None
        return load_checkpoint(self.path, target_tree, step, device, mesh,
                               spec_tree)

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
