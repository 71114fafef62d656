"""The JAX package's weight files without flax or msgpack (port of
``save_params`` / ``load_params`` in ``semantic_depth_tpu/models/weights.py``).

A weight file is flax's ``serialization.to_bytes`` of the variable tree: one
msgpack map of string keys down to the leaves, each leaf a msgpack ext of
type 1 whose payload is itself msgpack, ``(shape, dtype name, C-order
bytes)``. This module reads and writes that layout with numpy alone, so the
CLIs run where neither flax nor msgpack is installed. Array payloads decode
as ``np.frombuffer`` views of the file's bytes (read-only, no copy): the
411 MB fc6 kernel is in memory once.

Read: maps, arrays, str, bin, ints, floats, nil, bool and ext type 1. Ext
types 2 (complex) and 3 (numpy scalar) and flax's chunked arrays (leaves
over 2**30 bytes) raise, as does a truncated file. Written: maps of str keys
whose leaves are numpy arrays, as flax writes them.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Mapping

import numpy as np

_EXT_NDARRAY = 1
_MAX_LEAF_BYTES = 2**30  # flax chunks leaves above this


class MsgpackError(ValueError):
    pass


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError(
                f"truncated msgpack data: needs {n} bytes at offset {self.pos}, "
                f"{len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            return self.take(n) if kind == "bin" else getattr(self, kind)(n)
        numbers = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        if out.get("__msgpack_chunked_array__"):
            raise MsgpackError(
                "a chunked array (a leaf over 2**30 bytes, which flax splits) is not supported")
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = self.take(n)
        if code != _EXT_NDARRAY:
            kinds = {2: "a complex number", 3: "a numpy scalar"}
            raise MsgpackError(
                f"msgpack ext type {code} ({kinds.get(code, 'unknown')}) is not supported; "
                "weight files hold arrays only (ext type 1)")
        return _ndarray_from_payload(data)


def _ndarray_from_payload(data: memoryview) -> np.ndarray:
    inner = _Reader(data)
    shape, dtype_name, buf = inner.obj()
    if inner.pos != len(data):
        raise MsgpackError("trailing bytes in an array payload")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def unpackb(data) -> Any:
    """Decode one msgpack document (bytes or any buffer)."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.buf):
        raise MsgpackError(f"{len(reader.buf) - reader.pos} trailing bytes after the document")
    return out


# --- writer -------------------------------------------------------------------


def _pack_len(out: list, n: int, fix: int, fix_max: int, wide: tuple) -> None:
    if n <= fix_max and fix is not None:
        out.append(struct.pack(">B", fix | n))
        return
    for code, fmt, limit in wide:
        if n < limit:
            out.append(struct.pack(">B" + fmt[1:], code, n))
            return
    raise MsgpackError(f"object of length {n} is too large for msgpack")


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            out.append(struct.pack(">B", obj))
        elif -32 <= obj < 0:
            out.append(struct.pack(">b", obj))
        elif obj > 0:
            for code, fmt, limit in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16),
                                     (0xCE, ">I", 2**32), (0xCF, ">Q", 2**64)):
                if obj < limit:
                    out.append(struct.pack(">B", code) + struct.pack(fmt, obj))
                    break
        else:
            for code, fmt, limit in ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15),
                                     (0xD2, ">i", 2**31), (0xD3, ">q", 2**63)):
                if -obj <= limit:
                    out.append(struct.pack(">B", code) + struct.pack(fmt, obj))
                    break
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31,
                  ((0xD9, ">B", 2**8), (0xDA, ">H", 2**16), (0xDB, ">I", 2**32)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B")
        _pack_len(out, len(raw), None, -1,
                  ((0xC4, ">B", 2**8), (0xC5, ">H", 2**16), (0xC6, ">I", 2**32)))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, ((0xDC, ">H", 2**16), (0xDD, ">I", 2**32)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, Mapping):
        _pack_len(out, len(obj), 0x80, 15, ((0xDE, ">H", 2**16), (0xDF, ">I", 2**32)))
        for key, value in obj.items():
            _pack(str(key), out)
            _pack(value, out)
    elif isinstance(obj, np.ndarray):
        _pack_ndarray(obj, out)
    else:
        raise MsgpackError(f"cannot pack {type(obj).__name__}")


def _pack_ndarray(arr: np.ndarray, out: list) -> None:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise MsgpackError("object and structured arrays cannot be written")
    if arr.nbytes > _MAX_LEAF_BYTES:
        raise MsgpackError(
            f"an array of {arr.nbytes} bytes is over 2**30; flax would chunk it, "
            "which this writer does not")
    inner: list = []
    raw = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    _pack([list(arr.shape), arr.dtype.name, raw], inner)
    n = sum(len(piece) for piece in inner)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(struct.pack(">Bb", fixext[n], _EXT_NDARRAY))
    else:
        for code, fmt, limit in ((0xC7, "B", 2**8), (0xC8, "H", 2**16), (0xC9, "I", 2**32)):
            if n < limit:
                out.append(struct.pack(">B" + fmt + "b", code, n, _EXT_NDARRAY))
                break
    out.extend(inner)  # the array's bytes stay a view until they are written


def packb(tree: Any) -> bytes:
    """Encode a tree of maps, lists, scalars and numpy arrays as flax does."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# --- weight files ---------------------------------------------------------------


def save_params(params: Mapping[str, Any], path: str) -> str:
    """Write a flax variable tree (nested dicts of arrays) as a weight file
    that the JAX package's ``load_params`` reads."""
    out: list = []
    _pack(params, out)
    with open(path, "wb") as f:
        f.writelines(out)
    return path


def load_params(path: str) -> Dict[str, Any]:
    """Read a weight file written by the JAX package's ``save_params`` (or
    ``save_params`` here): nested dicts whose leaves are read-only numpy
    views of the file's bytes."""
    with open(path, "rb") as f:
        data = f.read()
    tree = unpackb(data)
    if not isinstance(tree, dict):
        raise MsgpackError(f"{path}: the document is a {type(tree).__name__}, not a map")
    return tree
