"""Read the checkpoints of the JAX package without flax or msgpack.

The JAX package saves a checkpoint with `flax.serialization.to_bytes`
(puresound_tpu/tasks/base.py:695-700): one msgpack document whose leaves
are flax's extension types. `msgpack_restore` decodes it into the tree
that `flax.serialization.msgpack_restore` returns, leaf for leaf:

- msgpack maps -> dict, arrays -> list, str -> str, bin -> bytes, ints,
  floats (float32 ones widened to Python floats, as msgpack does), bools
  and nil;
- ext type 1, an ndarray packed as the msgpack array (shape, dtype name,
  C-order bytes) -> a read-only `np.ndarray` over those bytes;
- ext type 3, a numpy scalar packed the same way -> that numpy scalar;
- ext type 2, a complex number packed as (real, imag) -> complex;
- a map holding `"__msgpack_chunked_array__"` (flax splits arrays above
  `MAX_CHUNK_SIZE = 2**30` bytes into flat chunks) -> the array put back
  together, as flax's `_unchunk_array_leaves_in_place` does.

bfloat16 arrays have no numpy dtype here: they come back as float32
arrays holding the same values (bfloat16 widens to float32 exactly).
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


def is_msgpack_map(data: bytes) -> bool:
    """Whether `data` starts a msgpack map (what `to_bytes` writes for a
    checkpoint's tree)."""
    return len(data) > 0 and (0x80 <= data[0] <= 0x8F or data[0] in (0xDE, 0xDF))


def _dtype_array(buf, name: str, shape) -> np.ndarray:
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
        arr.flags.writeable = False
        return arr.reshape(shape, order="C")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


class _Reader:
    """One msgpack document. `raw` keeps str as bytes (flax decodes the
    ndarray triple with raw=True, the outer tree with raw=False)."""

    def __init__(self, data, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, code: int, n: int):
        return _ext_value(code, self._take(n))

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", bytes), 0xC5: (">H", bytes), 0xC6: (">I", bytes),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self._unpack(fmt)
            if kind is bytes:
                return bytes(self._take(n))
            return {"str": self._str, "array": self._array, "map": self._map}[kind](n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self._unpack(">b")
            return self._ext(code, fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(self._unpack(">b"), n)
        raise ValueError(f"msgpack byte 0x{b:02x} at {self.pos - 1} is not a type code")


def _unpackb(data, raw: bool = False) -> Any:
    reader = _Reader(data, raw)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack document")
    return out


def _ndarray(buf) -> np.ndarray:
    shape, name, data = _unpackb(buf, raw=True)
    return _dtype_array(data, name.decode("ascii"), shape)


def _ext_value(code: int, buf):
    if code == EXT_NDARRAY:
        return _ndarray(buf)
    if code == EXT_NPSCALAR:
        return _ndarray(buf)[()]
    if code == EXT_COMPLEX:
        re, im = _unpackb(buf)
        return complex(re, im)
    raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: dict) -> np.ndarray:
    return np.concatenate(_tuple(d["chunks"])).reshape(_tuple(d["shape"]))


def _unchunk_leaves(d):
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            d[k] = _unchunk_leaves(v)
    return d


def msgpack_restore(data: bytes) -> Any:
    """The tree of a `flax.serialization.to_bytes` document (what
    `flax.serialization.msgpack_restore` returns)."""
    return _unchunk_leaves(_unpackb(data))
