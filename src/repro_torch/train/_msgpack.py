"""The subset of MessagePack that checkpoints use, without the ``msgpack``
package.

``repro.train.checkpoint`` writes each leaf as
``msgpack.packb({"i", "dtype", "shape", "data"}, use_bin_type=True)``:
maps with str keys, str, non-negative ints, arrays of ints and bin data.
:func:`packb` encodes that subset byte for byte as ``msgpack.packb`` does
(the smallest format that holds each value); :func:`unpack_stream` reads
a file of concatenated objects of that subset, as ``msgpack.Unpacker``
does.
"""
from __future__ import annotations

import struct
from typing import BinaryIO, Iterator


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple) -> None:
    """Header of a str, bin, array or map of length ``n``: the fix form
    when there is one and ``n`` fits, else the 8/16/32-bit forms."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} exceeds MessagePack's 32-bit limit")


def _pack(out: bytearray, obj) -> None:
    if isinstance(obj, int) and not isinstance(obj, bool):
        if obj < 0:
            raise ValueError("negative ints are outside the subset")
        if obj <= 0x7F:
            out.append(obj)
        else:
            for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                     (0xCE, ">I", 0xFFFFFFFF),
                                     (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
                if obj <= limit:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError(f"int {obj} exceeds 64 bits")
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        _pack_len(out, data.nbytes, None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r} is not a str")
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"{type(obj).__name__} is outside the subset")


def packb(obj) -> bytes:
    """``obj`` as ``msgpack.packb(obj, use_bin_type=True)`` encodes it."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f

    def take(self, n: int) -> bytes:
        data = self.f.read(n)
        if len(data) != n:
            raise ValueError("truncated MessagePack stream")
        return data

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_UINTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}


def _unpack(r: _Reader, head: int):
    if head <= 0x7F:
        return head
    if 0x80 <= head <= 0x8F:
        kind, n = "map", head & 0x0F
    elif 0x90 <= head <= 0x9F:
        kind, n = "array", head & 0x0F
    elif 0xA0 <= head <= 0xBF:
        kind, n = "str", head & 0x1F
    elif head in _UINTS:
        return r.num(_UINTS[head])
    elif head in _SIZED:
        kind, fmt = _SIZED[head]
        n = r.num(fmt)
    else:
        raise ValueError(f"MessagePack type 0x{head:02x} is outside the "
                         f"subset")
    if kind == "bin":
        return r.take(n)
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "array":
        return [_unpack(r, r.take(1)[0]) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r, r.take(1)[0])
        out[k] = _unpack(r, r.take(1)[0])
    return out


def unpack_stream(f: BinaryIO) -> Iterator:
    """The objects of a file of concatenated MessagePack objects, in
    order, as ``msgpack.Unpacker(f, raw=False)`` yields them."""
    r = _Reader(f)
    while True:
        head = f.read(1)
        if not head:
            return
        yield _unpack(r, head[0])

