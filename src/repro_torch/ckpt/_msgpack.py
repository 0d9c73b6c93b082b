"""The subset of MessagePack a checkpoint manifest needs: maps, str, int,
lists (and tuples), bool and nil.  ``packb`` gives the bytes
``msgpack.packb`` gives for these (smallest encoding of each int, str as
the str family, use_bin_type semantics); ``unpackb`` reads them back as
``msgpack.unpackb`` does (lists for arrays, str for str).  The machine with
the card has no ``msgpack`` package.
"""
from __future__ import annotations

import struct


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += struct.pack(">BB", 0xD9, n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xDA, n)
        else:
            out += struct.pack(">BI", 0xDB, n)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 0xDC, out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 0xDE, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} in a manifest")


def _pack_len(n: int, fix: int, code16: int, out: bytearray) -> None:
    if n < 16:
        out.append(fix | n)
    elif n < 1 << 16:
        out += struct.pack(">BH", code16, n)
    else:
        out += struct.pack(">BI", code16 + 1, n)


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif n >= 0:
        for code, fmt, lim in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if n < lim:
                out += struct.pack(fmt, code, n)
                return
        raise OverflowError(n)
    elif n >= -32:
        out += struct.pack(">b", n)
    else:
        for code, fmt, lim in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15),
                               (0xD2, ">Bi", 1 << 31), (0xD3, ">Bq", 1 << 63)):
            if n >= -lim:
                out += struct.pack(fmt, code, n)
                return
        raise OverflowError(n)


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _unpack(buf: bytes, i: int):
    """(object at buf[i], index after it)."""
    b = buf[i]
    i += 1
    if b < 0x80:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0xA0 <= b < 0xC0:
        return _str(buf, i, b & 0x1F)
    if 0x90 <= b < 0xA0:
        return _array(buf, i, b & 0x0F)
    if 0x80 <= b < 0x90:
        return _map(buf, i, b & 0x0F)
    if b == 0xC0:
        return None, i
    if b in (0xC2, 0xC3):
        return b == 0xC3, i
    if b in _INTS:
        fmt = _INTS[b]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    for code, fmt, read in ((0xD9, ">B", _str), (0xDA, ">H", _str),
                            (0xDB, ">I", _str), (0xDC, ">H", _array),
                            (0xDD, ">I", _array), (0xDE, ">H", _map),
                            (0xDF, ">I", _map)):
        if b == code:
            n = struct.unpack_from(fmt, buf, i)[0]
            return read(buf, i + struct.calcsize(fmt), n)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {i - 1}")


def _str(buf: bytes, i: int, n: int):
    return bytes(buf[i:i + n]).decode("utf-8"), i + n


def _array(buf: bytes, i: int, n: int):
    out = []
    for _ in range(n):
        item, i = _unpack(buf, i)
        out.append(item)
    return out, i


def _map(buf: bytes, i: int, n: int):
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


def unpackb(data: bytes):
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes after the object")
    return obj
