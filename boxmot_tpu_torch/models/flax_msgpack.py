"""Flax's msgpack checkpoints, read and written without flax or msgpack.

``flax.serialization.to_bytes`` of a ``{"params", "batch_stats"}`` tree is
msgpack (https://github.com/msgpack/msgpack/blob/master/spec.md) of nested
maps with string keys, whose leaves are ext code 1 (an ndarray: the msgpack
array ``(shape, dtype name, C-order bytes)``) or ext code 3 (a numpy
scalar, the same payload of a 0-d array); an array larger than 2**30 bytes
is split into a ``__msgpack_chunked_array__`` map of flat chunks.  This
module writes what ``to_bytes`` writes for a tree of smaller arrays, byte
for byte (the smallest header for every int, string, bin, map and ext;
Python floats as float64), and reads anything ``from_bytes`` reads: every
msgpack type, ext 1 and 3 as numpy, chunked arrays joined.  The JAX
package's ``.msgpack`` weights (``reid/exporters.py::export_checkpoint``, the
yololite predictor's) load into the port through it, and the port's
exports load in the JAX package.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2**30  # flax's limit for one array leaf, in bytes
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ write

def _head(out: bytearray, n: int, fix: int | None, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit
    form (``codes``: their type bytes; None where the type has no 8-bit
    form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int) and not isinstance(obj, np.generic):
        _pack_int(out, obj)
    elif isinstance(obj, float) and not isinstance(obj, np.generic):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _head(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (dict, list, tuple, str, bytes, int, float,
    bool, None; numpy arrays and scalars as flax's ext types)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def to_bytes(tree: dict) -> bytes:
    """``flax.serialization.to_bytes`` of a nested dict of numpy arrays below
    ``MAX_CHUNK_SIZE`` bytes each (flax chunks larger ones; no ReID model
    has one)."""
    return packb({str(k): v for k, v in tree.items()})


# ------------------------------------------------------------------- read

class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int, raw: bool):
        data = self.take(n)
        return data if raw else data.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self, raw: bool = False):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.read(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return self.take(self.unpack(sized[b]))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]), raw)
        if b in (0xDC, 0xDD):
            return [self.read(raw) for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")

    def map_(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.read(raw)
            out[k] = self.read(raw)
        return out


def _ndarray_from(data: bytes) -> np.ndarray:
    """Flax reads an ndarray's payload with raw strings: the dtype name is
    bytes.  ``bfloat16`` (no numpy dtype) becomes float32, exactly."""
    shape, name, buf = _Reader(data).read(raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _unchunked(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunked(v) for k, v in tree.items()}
    return tree


def unpackb(buf: bytes):
    """The object ``packb`` (or msgpack) wrote; numpy arrays for flax's ext
    types."""
    reader = _Reader(buf)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return out


def from_bytes(buf: bytes) -> dict:
    """The nested dict ``flax.serialization.to_bytes`` wrote, its leaves numpy
    arrays (read-only views of ``buf``)."""
    tree = _unchunked(unpackb(buf))
    if not isinstance(tree, dict):
        raise ValueError("a flax checkpoint holds a map at its top level")
    return tree


def read_variables(path) -> dict:
    """A ``.msgpack`` file of Flax variables as nested dicts of numpy arrays."""
    return from_bytes(Path(path).read_bytes())


def write_variables(tree: dict, path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(to_bytes(tree))
    return path
