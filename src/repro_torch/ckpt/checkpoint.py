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

Async save: ``CheckpointManager.maybe_save`` copies every leaf to the
writer's host memory before returning — a copy even of CPU tensors, which
the train step updates in place — and a worker thread writes the copy.

Sharded trees (DTensor leaves): the owner of each distinct shard of a
leaf (replicas stay silent) sends it to rank 0, and rank 0 alone places
the shards into the full array on the host and writes, so the files are
those of the same values saved unsharded; no other rank copies anything to
the host, and rank 0's device holds one received shard at a time.
``load_checkpoint(..., mesh=..., spec_tree=...)`` inflates each leaf on
the host, cuts out the rank's own shard there and moves only that shard to
the device (``DTensor.from_local``): a checkpoint restores onto any mesh,
whatever mesh wrote it, and the read threads hold at most ``_WORKERS`` full
leaves at a time.
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
# bytes a read thread takes from a leaf's file (and inflates) at a time
_CHUNK = 1 << 20


def _inflate(f, codec: str, out: np.ndarray) -> None:
    """Inflate the open leaf file ``f`` into ``out`` (a uint8 array of the
    leaf's size), reading at most ``_CHUNK`` bytes at a time and asking for
    no more inflated bytes than ``out`` has room for."""
    if codec == "zstd":
        try:
            import zstandard
        except ImportError:
            raise RuntimeError("checkpoint was written with zstd; install the "
                               "[compress] extra") from None
        reader = zstandard.ZstdDecompressor().stream_reader(f)

        def take(n: int) -> bytes:
            return reader.read(n)
    elif codec == "zlib":
        z = zlib.decompressobj()
        buf = bytearray(min(_CHUNK, f.seek(0, os.SEEK_END)))
        f.seek(0)
        data = memoryview(b"")

        def take(n: int) -> bytes:
            """Up to ``n`` inflated bytes; empty at the end."""
            nonlocal data
            while True:
                if data:
                    piece = z.decompress(data, n)
                    data = memoryview(z.unconsumed_tail)
                    if piece:
                        return piece
                elif k := f.readinto(buf):
                    data = memoryview(buf)[:k]
                else:
                    return z.flush()
    else:
        raise ValueError(f"unknown checkpoint codec {codec!r}")
    pos = 0
    # one byte more than the room left, so that a leaf too long shows
    while piece := take(min(_CHUNK, out.size - pos + 1)):
        if pos + len(piece) > out.size:
            raise ValueError(f"leaf inflates past {out.size} bytes")
        out[pos:pos + len(piece)] = np.frombuffer(piece, np.uint8)
        pos += len(piece)
    if pos != out.size:
        raise ValueError(f"leaf inflates to {pos} of {out.size} bytes")


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


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's numpy view (bf16 as its raw 16-bit words)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _shard_slices(shape, mesh_shape, coord, placements) -> tuple:
    """The slices of a ``shape`` array that the rank at mesh coordinate
    ``coord`` holds under ``placements``: DTensor's ``Shard`` splits a dim
    as ``torch.chunk`` does (pieces of ceil(n / ranks), the last ones short
    or empty), over the mesh dims in mesh order."""
    start, size = [0] * len(shape), list(shape)
    for mdim, p in enumerate(placements):
        if not p.is_shard():
            continue
        if type(p).__name__ != "Shard":
            raise NotImplementedError(f"checkpoint of a {p} placement")
        d, n = p.dim, mesh_shape[mdim]
        step = -(-size[d] // n)
        lo = min(coord[mdim] * step, size[d])
        start[d] += lo
        size[d] = min(lo + step, size[d]) - lo
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a flat uint8 tensor (a view where it is
    contiguous): gloo takes neither bf16 nor int16, and every dtype is
    bytes."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _gather_dtensor(t, writer: bool) -> np.ndarray | None:
    """Rank 0 gets the DTensor's full array on the host, put together from
    its shards; other ranks get ``None``.  Each distinct shard crosses the
    wire once: its owner, the rank at coordinate 0 of every mesh dim the
    leaf is not sharded over, sends it to rank 0, which receives the shards
    one at a time and places each on the host, so its device holds one
    received shard beside its own.  The mesh must span the default group."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    if any(p.is_partial() for p in t.placements):
        t = t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                           else p for p in t.placements])
    ranks = t.device_mesh.mesh.cpu().numpy()
    world = dist.get_world_size()
    if ranks.size != world:
        raise ValueError(f"a mesh of {ranks.size} ranks in a world of {world}")
    shape = tuple(t.shape)
    owners = {}                     # rank -> the slices of its shard
    for c in np.ndindex(*ranks.shape):
        if any(c[m] for m, p in enumerate(t.placements) if not p.is_shard()):
            continue                # a replica of another rank's shard
        sl = _shard_slices(shape, ranks.shape, c, t.placements)
        if all(s.stop > s.start for s in sl):
            owners[int(ranks[c])] = sl
    rank, local = dist.get_rank(), t.to_local()
    if not writer:
        if rank in owners:
            dist.send(_bytes(local), dst=0)
        return None
    full = np.empty(shape, _numpy(torch.empty(0, dtype=t.dtype)).dtype)
    for r, sl in sorted(owners.items()):
        if r == rank:
            piece = _bytes(local)
        else:
            piece = local.new_empty(
                full.itemsize * int(np.prod([s.stop - s.start for s in sl])),
                dtype=torch.uint8)
            dist.recv(piece, src=r)
        full[sl] = piece.cpu().numpy().view(full.dtype).reshape(
            [s.stop - s.start for s in sl])
        del piece
    return full


def _host_copy(t: torch.Tensor, writer: bool
               ) -> tuple[np.ndarray, str] | None:
    """(a host copy of the tensor's bytes as numpy, its dtype name) on the
    writer; for a DTensor a collective, after which other ranks get
    ``None``."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        full = _gather_dtensor(t.detach(), writer)
        return None if full is None else (full, _dtype_name(t))
    if not writer:
        return None
    return _numpy(t.detach().to("cpu", copy=True)), _dtype_name(t)


def _snapshot(tree) -> dict[str, tuple[np.ndarray, str]]:
    """The writer's host copy of every leaf, by key; on other ranks (which
    send the shards they own) an empty dict."""
    writer = _is_writer()
    flat: dict[str, tuple[np.ndarray, str]] = {}

    def take(key, leaf):
        got = _host_copy(leaf, writer)
        if got is not None:
            flat[key] = got

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


def _read_leaf(d: str, meta: dict, codec: str,
               slices: tuple | None = None) -> np.ndarray:
    """The leaf as numpy (bf16 as uint16 words), or, given ``slices``, a
    contiguous copy of that part of it: the full leaf lives only inside
    this call."""
    dtype = np.dtype(np.uint16 if meta["dtype"] == "bfloat16"
                     else meta["dtype"])
    arr = np.empty(meta["shape"], dtype)
    with open(os.path.join(d, meta["file"]), "rb") as f:
        _inflate(f, codec, arr.reshape(-1).view(np.uint8))
    if slices is None or all(s == slice(0, n)
                             for s, n in zip(slices, arr.shape)):
        return arr
    return arr[slices].copy()         # a copy even where the view is contiguous


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
        from torch.distributed.tensor import DTensor

        from repro_torch.sharding.specs import placements
        if device is None:
            device = mesh.device_type
        coord = mesh.get_coordinate()
        mesh_shape = tuple(mesh.shape)
    keys: list[str] = []
    _map_keyed(lambda key, leaf: keys.append(key), target_tree)
    for key in keys:
        if key not in leaves_meta:
            raise KeyError(f"checkpoint missing leaf {key}")

    def read(key):
        """(this rank's part of the leaf on the host, its placements)."""
        meta = leaves_meta[key]
        if mesh is None:
            return _read_leaf(d, meta, codec), None
        pl = placements(_at(spec_tree, key), mesh)
        sl = _shard_slices(meta["shape"], mesh_shape, coord, pl)
        return _read_leaf(d, meta, codec, sl), pl

    with cf.ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        futs = {key: pool.submit(read, key) for key in keys}

        def place(key, leaf):
            dev = leaf.device if device is None else torch.device(device)
            arr, pl = futs.pop(key).result()
            t = torch.from_numpy(arr)
            if leaves_meta[key]["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            t = t.to(device=dev, dtype=leaf.dtype)
            if mesh is None:
                return t
            shape = leaves_meta[key]["shape"]
            stride = [int(np.prod(shape[i + 1:])) for i in range(len(shape))]
            return DTensor.from_local(t, mesh, pl, run_check=False,
                                      shape=torch.Size(shape),
                                      stride=tuple(stride))

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
        """At every ``interval``-th step, snapshot ``tree`` (every rank sends
        the shards it owns of a sharded tree) and write it in the background
        (rank 0)."""
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
