"""The port's checkpoints (``repro_torch.ckpt``) against ``repro.ckpt`` on
the CPU: either package reads what the other wrote (f32, int32 and bf16
leaves, nested dicts and lists), the manifests are byte for byte the same,
the port's manifest codec gives ``msgpack``'s bytes and reads them; plus
the port analogs of ``tests/test_ckpt.py`` (round trip, codec errors,
atomic commit, retention, restore) and the async snapshot's copy."""
import os
import threading

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt_mod
from repro.ckpt import load_checkpoint as jload
from repro.ckpt import save_checkpoint as jsave
from repro_torch.ckpt import (CheckpointManager, latest_step, load_checkpoint,
                              save_checkpoint)
from repro_torch.ckpt import _msgpack
from repro_torch.ckpt import checkpoint as ckpt_mod


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": {"w": torch.randn(8, 16, generator=g),
                  "b": torch.randn(16, generator=g).to(torch.bfloat16)},
            "layers": [{"k": torch.randint(-9, 9, (3,), generator=g,
                                           dtype=torch.int32)},
                       {"k": torch.randint(-9, 9, (3,), generator=g,
                                           dtype=torch.int32)}],
            "step": torch.tensor(7, dtype=torch.int32)}


def _jtree(tree):
    if isinstance(tree, dict):
        return {k: _jtree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jtree(v) for v in tree]
    arr = jnp.asarray(tree.float().numpy() if tree.dtype == torch.bfloat16
                      else tree.numpy())
    return arr.astype(jnp.bfloat16) if tree.dtype == torch.bfloat16 else arr


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _assert_same(got, want):
    for (k, a), (k2, b) in zip(_leaves(got), _leaves(want)):
        assert k == k2
        assert str(a.dtype).split(".")[-1] == str(b.dtype).split(".")[-1], k
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=k)


def test_roundtrip(tmp_path):
    t = _tree()
    d = save_checkpoint(str(tmp_path), 5, t)
    assert d.endswith("step_00000005")
    restored, step = load_checkpoint(str(tmp_path), t)
    assert step == 5
    _assert_same(restored, t)
    assert restored["a"]["b"].dtype == torch.bfloat16


def test_port_writes_reference_reads(tmp_path):
    t = _tree(1)
    save_checkpoint(str(tmp_path), 3, t)
    restored, step = jload(str(tmp_path), _jtree(t))
    assert step == 3
    _assert_same(restored, _jtree(t))


def _reference_writes_zlib(monkeypatch):
    """The reference's minimal-install codec (``tests/test_ckpt.py``)."""
    monkeypatch.setattr(jckpt_mod, "_zstd", None)
    monkeypatch.setattr(jckpt_mod, "_CODEC", "zlib")


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_reference_writes_port_reads(tmp_path, monkeypatch, codec):
    """zstd where ``zstandard`` is installed (the port reads it through
    the same package); zlib always."""
    if codec == "zlib":
        _reference_writes_zlib(monkeypatch)
    elif jckpt_mod._zstd is None:
        pytest.skip("zstandard is not installed")
    t = _tree(2)
    d = jsave(str(tmp_path), 4, _jtree(t))
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        assert msgpack.unpackb(f.read())["codec"] == codec
    restored, step = load_checkpoint(str(tmp_path), t)
    assert step == 4
    _assert_same(restored, t)


def test_manifest_bytes_equal_reference(tmp_path, monkeypatch):
    """The same tree gives the reference's manifest byte for byte (keys,
    file names, shapes, dtype strings), the reference writing zlib."""
    _reference_writes_zlib(monkeypatch)
    t = _tree(3)
    a = save_checkpoint(str(tmp_path / "port"), 9, t)
    b = jsave(str(tmp_path / "ref"), 9, _jtree(t))
    with open(os.path.join(a, "manifest.msgpack"), "rb") as f:
        mine = f.read()
    with open(os.path.join(b, "manifest.msgpack"), "rb") as f:
        ref = f.read()
    assert msgpack.unpackb(ref)["codec"] == "zlib"
    assert mine == ref
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
    2**64 - 1, -1, -32, -33, -128, -129, -2**15, -2**15 - 1, -2**31,
    -2**31 - 1, -2**63, "", "x" * 31, "x" * 32, "x" * 255, "x" * 256,
    "x" * 70000, "é/ü", [], [1] * 15, [1] * 16, list(range(70000)), {},
    {str(i): i for i in range(15)}, {str(i): [i, None] for i in range(16)},
    {"step": 8, "codec": "zlib", "leaves": {
        "params/blocks/0/attn/wq": {"shape": [1024, 16, 64],
                                    "dtype": "bfloat16", "file": "00012.bin"}}},
])
def test_manifest_codec_matches_msgpack(obj):
    assert _msgpack.packb(obj) == msgpack.packb(obj)
    assert _msgpack.unpackb(msgpack.packb(obj)) == msgpack.unpackb(
        msgpack.packb(obj))


def test_manifest_codec_rejects_what_it_cannot_hold():
    with pytest.raises(TypeError):
        _msgpack.packb({"x": 1.5})
    with pytest.raises(ValueError, match="trailing"):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="unsupported"):
        _msgpack.unpackb(msgpack.packb(b"raw"))


def test_codec_error_paths():
    with pytest.raises(ValueError, match="unknown checkpoint codec"):
        ckpt_mod._decompress(b"x", "lz4")
    try:
        import zstandard  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="compress"):
            ckpt_mod._decompress(b"x", "zstd")


def test_port_imports_no_optional_codec_packages():
    import ast
    for name in ("checkpoint.py", "_msgpack.py", "__init__.py"):
        path = os.path.join(os.path.dirname(ckpt_mod.__file__), name)
        tree = ast.parse(open(path).read())
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        mods = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in top if isinstance(n, ast.ImportFrom)]
        assert not {"msgpack", "ml_dtypes", "zstandard"} & set(mods), (name, mods)


def test_restore_converts_to_target_dtype_and_device(tmp_path):
    t = _tree(4)
    save_checkpoint(str(tmp_path), 1, t)
    target = {"a": {"w": torch.zeros(8, 16, dtype=torch.bfloat16),
                    "b": torch.zeros(16)},
              "layers": [{"k": torch.zeros(3, dtype=torch.int64)}] * 2,
              "step": torch.zeros((), dtype=torch.int32)}
    restored, _ = load_checkpoint(str(tmp_path), target, device="cpu")
    assert restored["a"]["w"].dtype == torch.bfloat16
    assert torch.equal(restored["a"]["w"], t["a"]["w"].to(torch.bfloat16))
    assert torch.equal(restored["a"]["b"], t["a"]["b"].float())
    assert restored["layers"][1]["k"].dtype == torch.int64
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(str(tmp_path), {"nope": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"), t)


def test_atomicity_tmp_cleanup(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    assert latest_step(str(tmp_path)) == 1
    os.makedirs(tmp_path / "step_00000009.tmp")      # a crashed write
    save_checkpoint(str(tmp_path), 2, t)
    assert latest_step(str(tmp_path)) == 2
    assert not os.path.exists(tmp_path / "step_00000002.tmp")


def test_manager_interval_retention_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), interval=2, keep=2)
    t = _tree()
    saved = [s for s in range(1, 9) if mgr.maybe_save(s, t)]
    mgr.wait()
    assert saved == [2, 4, 6, 8]
    kept = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                  if d.startswith("step_") and not d.endswith(".tmp"))
    assert kept == [6, 8]
    restored, step = mgr.restore(t)
    assert step == 8
    _assert_same(restored, t)
    mgr.close()
    assert CheckpointManager(str(tmp_path / "none")).restore(t) == (None, None)


def test_async_snapshot_is_a_copy(tmp_path, monkeypatch):
    """The train step updates CPU tensors in place right after
    ``maybe_save`` returns; the checkpoint must hold the values at the
    save.  The worker's write is held back until the tensors have moved."""
    release = threading.Event()
    real_write = ckpt_mod._write

    def held_write(*args):
        assert release.wait(timeout=60)
        return real_write(*args)

    monkeypatch.setattr(ckpt_mod, "_write", held_write)
    t = _tree(5)
    want = {"a": {"w": t["a"]["w"].clone(), "b": t["a"]["b"].clone()},
            "layers": [{"k": lyr["k"].clone()} for lyr in t["layers"]],
            "step": t["step"].clone()}
    mgr = CheckpointManager(str(tmp_path), interval=1)
    assert mgr.maybe_save(1, t)
    with torch.no_grad():
        t["a"]["w"].add_(1.0)
        t["a"]["b"].mul_(2)
        t["layers"][0]["k"].add_(1)
        t["step"].add_(1)
    release.set()
    mgr.wait()
    restored, step = load_checkpoint(str(tmp_path), t)
    assert step == 1
    _assert_same(restored, want)
    mgr.close()
