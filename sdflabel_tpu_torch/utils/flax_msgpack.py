"""Reader and writer for flax msgpack checkpoints, in pure Python.

The JAX package saves its CSS variables with ``flax.serialization.to_bytes``
(pipelines/train_css.py::save_checkpoint): a msgpack map of maps whose
leaves are numpy arrays, each packed as msgpack ext type 1 around the
msgpack tuple ``(shape, dtype name, C-order bytes)``. This module decodes
and encodes that format without the ``msgpack`` or ``flax`` packages:
maps, arrays, strings, bins, ints, floats, booleans, nil and the ndarray /
numpy-scalar ext types. The writer picks msgpack's shortest form for each
value, as the msgpack package does, and writes maps in key order; flax's
variable trees are key-sorted, so for them its bytes are flax's. flax's
chunked
form of arrays above 1 GiB is not handled: no checkpoint of this
repository comes near that size.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
            0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
            0xDC: ("H", "array"), 0xDD: ("I", "array"),
            0xDE: ("H", "map"), 0xDF: ("I", "map"),
            0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack("b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack("b"), fixext[b])
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} is not handled")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(payload)
            return arr if code == _EXT_NDARRAY else arr[()]
        raise ValueError(f"msgpack ext type {code} is not handled")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 arrays need ml_dtypes; save as float32")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def unpackb(data: bytes):
    """Decode one msgpack value (the whole buffer)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack value")
    return out


def msgpack_restore(data: bytes):
    """Counterpart of ``flax.serialization.msgpack_restore``: the nested
    dict of numpy arrays a flax checkpoint holds."""
    return unpackb(data)


def load(path: str):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _head(out: bytearray, n: int, fix: int | None, fix_max: int,
          codes: tuple) -> None:
    """A size header: the fix form below `fix_max`, else 8/16/32 bits."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt in zip(codes, ("B", "H", "I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError(f"msgpack size {n} is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")) if v >= 0 \
        else ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q"))
    for code, fmt in forms:
        try:
            packed = struct.pack(">" + fmt, v)
        except struct.error:
            continue
        out.append(code)
        out += packed
        return
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixext:
        out.append(fixext[len(payload)])
    else:
        _head(out, len(payload), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + payload


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif isinstance(v, (bool, np.bool_)):
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        raw = v.encode()
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(v, (bytes, bytearray)):
        _head(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 16, (None, 0xDE, 0xDF))
        for k in sorted(v):
            _pack(out, k)
            _pack(out, v[k])
    elif isinstance(v, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
    else:
        raise TypeError(f"cannot msgpack {type(v).__name__}")


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject:
        raise TypeError("object arrays are not serialized")
    return msgpack_serialize((tuple(int(d) for d in arr.shape),
                              arr.dtype.name, arr.tobytes("C")))


def msgpack_serialize(tree) -> bytes:
    """Counterpart of ``flax.serialization.msgpack_serialize``: one value
    (a nested dict with string keys and numpy leaves, say) as msgpack,
    flax's ndarray ext types included."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def save(path: str, tree) -> None:
    """Write `tree` where ``flax.serialization.from_bytes`` (and
    :func:`load`) read it; the file appears whole or not at all."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(tree))
    os.replace(tmp, path)
