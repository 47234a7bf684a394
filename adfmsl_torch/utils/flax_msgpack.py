"""Reader and writer of flax's msgpack serialization, in numpy and ``struct``.

adfmsl exports a Wav2Vec2 parameter tree with
``flax.serialization.msgpack_serialize`` (``adfmsl/models/pretrained.py:32``)
and reads it with ``msgpack_restore`` / ``from_bytes``. The port reads and
writes the same files without flax or the ``msgpack`` package, for the subset
flax writes:

- maps with str keys, arrays (a tuple or list), str, bin, int, float, bool
  and nil;
- ext type 1, an ndarray: the msgpack of ``(shape, dtype name, C-order
  bytes)``; ext type 3, a numpy scalar, as a 0-d ndarray;
- a leaf of more than ``MAX_CHUNK_SIZE`` bytes as flax's
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": ..., "1": ...}}`` map of flat chunks.

``packb`` writes flax's bytes for the same tree: flax copies the tree with
``jax.tree_util.tree_map``, which orders every map's keys, so ``packb`` sorts
the keys of the tree's maps (a chunk map keeps flax's own order), and packs
each value in msgpack's shortest form. ``unpackb`` returns nested dicts of
numpy arrays (lists for arrays), chunked leaves joined again. A ``bfloat16``
leaf, which numpy cannot hold without ``ml_dtypes``, reads as its exact
float32 widening.
"""
from __future__ import annotations

import struct
from typing import Any, List, Mapping, Tuple

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30          # flax/serialization.py: a leaf above it is chunked
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------------- writer

def _head(out: List[bytes], n: int, fix: int, fix_max: int, codes: Tuple[int, int, int],
          small: bool = True) -> None:
    """A length header: the fix form below ``fix_max``, else 8 (if ``small``),
    16 or 32 bits."""
    c8, c16, c32 = codes
    if n < fix_max:
        out.append(bytes([fix | n]))
    elif small and n <= 0xFF:
        out.append(bytes([c8, n]))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", c16, n))
    else:
        out.append(struct.pack(">BI", c32, n))


def _pack_int(out: List[bytes], v: int) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(bytes([v]))
        elif v <= 0xFF:
            out.append(struct.pack(">BB", 0xCC, v))
        elif v <= 0xFFFF:
            out.append(struct.pack(">BH", 0xCD, v))
        elif v <= 0xFFFFFFFF:
            out.append(struct.pack(">BI", 0xCE, v))
        else:
            out.append(struct.pack(">BQ", 0xCF, v))
    elif v >= -0x20:
        out.append(struct.pack(">b", v))
    elif v >= -0x80:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif v >= -0x8000:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif v >= -0x80000000:
        out.append(struct.pack(">Bi", 0xD2, v))
    else:
        out.append(struct.pack(">Bq", 0xD3, v))


def _pack_bin(out: List[bytes], data: bytes) -> None:
    n = len(data)
    if n <= 0xFF:
        out.append(bytes([0xC4, n]))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xC5, n))
    else:
        out.append(struct.pack(">BI", 0xC6, n))
    out.append(data)


def _pack_ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n]]))
    elif n <= 0xFF:
        out.append(bytes([0xC7, n]))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xC8, n))
    else:
        out.append(struct.pack(">BI", 0xC9, n))
    out.append(struct.pack(">b", code))
    out.append(data)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    out: List[bytes] = []
    _pack(out, (arr.shape, arr.dtype.name, arr.tobytes("C")), False, False)
    return b"".join(out)


def _chunk(arr: np.ndarray) -> dict:
    """flax's chunked form of an oversized leaf (``_chunk``), in its key order."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(out: List[bytes], obj: Any, sort_keys: bool, chunkable: bool) -> None:
    """``chunkable``: flax chunks an oversized leaf that is the tree itself or
    a map's value, not a list's item."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        if chunkable and obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack(out, _chunk(obj), False, False)
        else:
            _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif type(obj) in (bytes, bytearray):
        _pack_bin(out, bytes(obj))
    elif isinstance(obj, Mapping):
        keys = sorted(obj) if sort_keys else list(obj)
        _head(out, len(keys), 0x80, 16, (0, 0xDE, 0xDF), small=False)
        for k in keys:
            _pack(out, k, sort_keys, False)
            _pack(out, obj[k], sort_keys, True)
    elif type(obj) in (list, tuple):
        _head(out, len(obj), 0x90, 16, (0, 0xDC, 0xDD), small=False)
        for v in obj:
            _pack(out, v, sort_keys, False)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(tree: Any) -> bytes:
    """The msgpack bytes of ``tree``, as ``flax.serialization.msgpack_serialize``
    writes them (the tree's map keys in sorted order, as flax's copy of the
    tree has them)."""
    out: List[bytes] = []
    _pack(out, tree, True, True)
    return b"".join(out)


# --------------------------------------------------------------------------- reader

_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
          0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
          0xD2: (">i", 4), 0xD3: (">q", 8)}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def num(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def length(self, n: int) -> int:
        return self.num(_LEN[n], n)

    def text(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.num(">b", 1)
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self) -> Any:
        b = self.num(">B", 1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.length(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.length(1 << (b - 0xC7)))
        if b in _FIXED:
            return self.num(*_FIXED[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(self.length(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self.array(self.length(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self.map(self.length(2 if b == 0xDE else 4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _ndarray_from(data: memoryview) -> np.ndarray:
    r = _Reader(data, raw=True)
    shape, name, buf = r.read()
    if name == b"bfloat16":      # numpy has no bfloat16: widen the bits exactly
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape, order="C")
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape, order="C")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes) -> Any:
    """The tree of ``packb`` / ``flax.serialization.msgpack_serialize`` bytes
    (``msgpack_restore``)."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)
