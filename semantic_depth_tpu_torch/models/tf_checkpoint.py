"""TF1 checkpoints read without TensorFlow (the counterpart of
``tf.train.load_checkpoint`` and ``tf.train.latest_checkpoint`` behind
``_read_tf_checkpoint`` in ``semantic_depth_tpu/models/weights.py``).

A checkpoint ``<prefix>`` is a TensorBundle: ``<prefix>.index``, a LevelDB
table, and ``<prefix>.data-NNNNN-of-NNNNN`` shards of raw little-endian
tensor bytes.

* The table ends in a 48-byte footer: two block handles (varint64 offset,
  varint64 size) padded to 40 bytes, then the magic ``0xdb4775248b80fb57``.
  The index block's values are the handles of the data blocks. A block's
  entries are prefix-compressed (varint32 shared, unshared and value
  lengths, then the key's new bytes and the value), followed by its restart
  array (uint32 offsets, then their count). After each block come a type
  byte (0: not compressed) and the masked CRC-32C of the block and that byte.
* The entry under the empty key is a ``BundleHeaderProto`` (``num_shards`` 1,
  ``endianness`` 2); every other key is a variable name whose value is a
  ``BundleEntryProto`` (``dtype`` 1, ``shape`` 2, ``shard_id`` 3, ``offset``
  4, ``size`` 5, ``crc32c`` 6 fixed32, ``slices`` 7). Both are decoded here
  by hand; unknown fields are skipped by wire type.
* A tensor is ``size`` bytes at ``offset`` of its shard, checked against the
  entry's masked CRC-32C. A string tensor is its varint64 lengths, a masked
  CRC-32C of the lengths, then the bytes; its entry's checksum runs over
  each length as 4 bytes (8 above 2^32), the lengths' checksum and the bytes.

Every checksum is verified. Compressed tables, big-endian bundles,
partitioned variables (``slices``) and other dtypes than float16/32/64,
bfloat16, int8/16/32/64, uint8, bool and string raise and name what they
found. bfloat16 comes back widened to float32 (exact; numpy has no
bfloat16); ``dtypes()`` still names it. Only the tensors asked for are read,
each into a buffer of its own, so a reader holds one copy of what it keeps.

The checksum runs in ``native/crc32c.cpp`` where g++ built it, and in plain
Python (``crc32c_plain``, the same value) elsewhere.
"""

from __future__ import annotations

import codecs
import dataclasses
import glob
import os
import re
import struct
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..native.build import library as native_library

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_BYTES = 48
_BLOCK_TRAILER_BYTES = 5
_COMPRESSION = {0: "none", 1: "snappy", 2: "zstd"}
_MASK_DELTA = 0xA282EAD8

# TensorFlow's DataType enum (types.proto): the types read, as numpy dtypes
# of their little-endian bytes ("string" and "bfloat16" are decoded apart)
_DTYPES = {
    1: "float32", 2: "float64", 3: "int32", 4: "uint8", 5: "int16", 6: "int8", 7: "string",
    9: "int64", 10: "bool", 14: "bfloat16", 19: "float16",
}
_OTHER_DTYPES = {
    0: "invalid", 8: "complex64", 11: "qint8", 12: "quint8", 13: "qint32", 15: "qint16",
    16: "quint16", 17: "uint16", 18: "complex128", 20: "resource", 21: "variant", 22: "uint32",
    23: "uint64", 24: "float8_e5m2", 25: "float8_e4m3fn", 29: "int4", 30: "uint4",
}
_NUMPY = {"float32": "<f4", "float64": "<f8", "int32": "<i4", "uint8": "u1", "int16": "<i2",
          "int8": "i1", "int64": "<i8", "bool": "?", "bfloat16": "<u2", "float16": "<f2"}

# what a read costs, summed over reads since the last reset_read_stats()
READ_STATS = {"bytes": 0, "seconds": 0.0, "crc_seconds": 0.0}


class CheckpointError(ValueError):
    pass


def reset_read_stats() -> None:
    READ_STATS.update(bytes=0, seconds=0.0, crc_seconds=0.0)


# ---------------------------------------------------------------------------
# CRC-32C
# ---------------------------------------------------------------------------


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c_plain(data, crc: int = 0) -> int:
    """CRC-32C of ``data`` (any buffer) continued from ``crc``, byte by byte
    in Python: ``crc32c_plain(b"123456789") == 0xE3069283``."""
    c = crc ^ 0xFFFFFFFF
    table = _CRC_TABLE
    for b in memoryview(data).cast("B"):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of ``data`` continued from ``crc`` (TensorFlow's
    ``crc32c::Extend``), through the native library where there is one."""
    lib = native_library()
    if lib is None:
        return crc32c_plain(data, crc)
    buf = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    if buf.size == 0:
        return crc
    return int(lib.crc32c_extend(crc, buf.ctypes.data, buf.size))


def mask_crc(crc: int) -> int:
    """The masked form TensorFlow stores (``crc32c::Mask``)."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + _MASK_DELTA) & 0xFFFFFFFF


def _timed_crc(data, crc: int = 0) -> int:
    t0 = time.perf_counter()
    out = crc32c(data, crc)
    READ_STATS["crc_seconds"] += time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# varints, protobuf fields, table blocks
# ---------------------------------------------------------------------------


def _varint(buf, pos: int, what: str) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise CheckpointError(f"truncated varint in {what}")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise CheckpointError(f"varint over 64 bits in {what}")


def _fields(buf, what: str) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a protobuf message: varints as
    ints, fixed32 / fixed64 / length-delimited as bytes."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos, what)
        num, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _varint(buf, pos, what)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, pos = bytes(buf[pos:pos + n]), pos + n
        elif wire == 2:
            n, pos = _varint(buf, pos, what)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise CheckpointError(f"unsupported protobuf wire type {wire} in {what}")
        if pos > len(buf):
            raise CheckpointError(f"truncated protobuf field {num} in {what}")
        yield num, wire, value


def _block(table: bytes, offset: int, size: int, what: str) -> memoryview:
    """A table block's contents, after its trailer's checks."""
    end = offset + size + _BLOCK_TRAILER_BYTES
    if offset < 0 or end > len(table):
        raise CheckpointError(f"{what}: block at {offset} (+{size}) runs past the table's end")
    raw = memoryview(table)[offset:end]
    kind = raw[size]
    (stored,) = struct.unpack_from("<I", raw, size + 1)
    if mask_crc(_timed_crc(raw[:size + 1])) != stored:
        raise CheckpointError(f"{what}: block at {offset} fails its crc32c")
    if kind != 0:
        raise CheckpointError(
            f"{what}: block at {offset} is compressed "
            f"({_COMPRESSION.get(kind, 'unknown')}, type {kind}); only uncompressed tables "
            "are read")
    return raw[:size]


def _block_entries(block: memoryview, what: str) -> Iterator[Tuple[bytes, memoryview]]:
    """The (key, value) entries of a block, prefix compression undone; each
    restart point must hold a whole key."""
    if len(block) < 4:
        raise CheckpointError(f"{what}: a block of {len(block)} bytes has no restart array")
    (n_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    end = len(block) - 4 - 4 * n_restarts
    if n_restarts == 0 or end < 0:
        raise CheckpointError(f"{what}: bad restart count {n_restarts}")
    restarts = set(struct.unpack_from(f"<{n_restarts}I", block, end))
    pos, key = 0, b""
    while pos < end:
        at = pos
        shared, pos = _varint(block, pos, what)
        unshared, pos = _varint(block, pos, what)
        n_value, pos = _varint(block, pos, what)
        if shared > len(key) or (at in restarts and shared):
            raise CheckpointError(f"{what}: corrupt entry at block offset {at}")
        key = key[:shared] + bytes(block[pos:pos + unshared])
        pos += unshared
        value = block[pos:pos + n_value]
        pos += n_value
        if pos > end:
            raise CheckpointError(f"{what}: entry at block offset {at} runs into the restarts")
        yield key, value


def _table_entries(path: str) -> Iterator[Tuple[bytes, memoryview]]:
    """Every (key, value) of a LevelDB table file, in key order."""
    with open(path, "rb") as f:
        table = f.read()
    if len(table) < _FOOTER_BYTES:
        raise CheckpointError(f"{path}: {len(table)} bytes is too short for a table")
    footer = memoryview(table)[len(table) - _FOOTER_BYTES:]
    (magic,) = struct.unpack_from("<Q", footer, 40)
    if magic != _TABLE_MAGIC:
        raise CheckpointError(f"{path}: not a TensorFlow table (magic {magic:#x})")
    pos = 0
    for _ in range(2):  # the metaindex handle, then the index handle
        offset, pos = _varint(footer, pos, f"{path} footer")
        size, pos = _varint(footer, pos, f"{path} footer")
    index = _block(table, offset, size, f"{path} index")
    for _, handle in _block_entries(index, f"{path} index"):
        offset, p = _varint(handle, 0, f"{path} index handle")
        size, _ = _varint(handle, p, f"{path} index handle")
        yield from _block_entries(_block(table, offset, size, f"{path} data"), f"{path} data")


# ---------------------------------------------------------------------------
# bundle entries
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Entry:
    """One variable's ``BundleEntryProto``."""

    name: str
    dtype: str
    shape: Tuple[int, ...]
    shard_id: int
    offset: int
    size: int
    crc32c: int


def _shape(buf, what: str) -> Tuple[int, ...]:
    dims = []
    for num, wire, value in _fields(buf, what):
        if num == 2 and wire == 2:  # dim
            size = 0
            for n, w, v in _fields(value, what):
                if n == 1 and w == 0:
                    size = v
            dims.append(size)
        elif num == 3 and wire == 0 and value:
            raise CheckpointError(f"{what}: unknown rank")
    return tuple(dims)


def _entry(name: str, buf) -> Entry:
    what = f"entry {name!r}"
    fields = dict(dtype=0, shape=(), shard_id=0, offset=0, size=0, crc32c=0)
    for num, wire, value in _fields(buf, what):
        if num == 1 and wire == 0:
            fields["dtype"] = value
        elif num == 2 and wire == 2:
            fields["shape"] = _shape(value, what)
        elif num in (3, 4, 5) and wire == 0:
            fields[{3: "shard_id", 4: "offset", 5: "size"}[num]] = value
        elif num == 6 and wire == 5:
            (fields["crc32c"],) = struct.unpack("<I", value)
        elif num == 7:
            raise CheckpointError(
                f"{name} is a partitioned variable (saved in slices), which is not read")
    code = fields["dtype"]
    if code not in _DTYPES:
        raise CheckpointError(
            f"{name}: dtype {_OTHER_DTYPES.get(code, 'unknown')} (enum {code}) is not read")
    fields["dtype"] = _DTYPES[code]
    return Entry(name=name, **fields)


def _header(buf, path: str) -> int:
    num_shards, endianness = 1, 0
    for num, wire, value in _fields(buf, f"{path} header"):
        if num == 1 and wire == 0:
            num_shards = value
        elif num == 2 and wire == 0:
            endianness = value
    if endianness != 0:
        raise CheckpointError(f"{path}: a big-endian bundle is not read")
    return num_shards


def _decode_strings(raw: memoryview, count: int, entry: Entry) -> np.ndarray:
    what = f"{entry.name} (string)"
    pos, lengths, crc = 0, [], 0
    for _ in range(count):
        n, pos = _varint(raw, pos, what)
        lengths.append(n)
        crc = _timed_crc(struct.pack("<I" if n <= 0xFFFFFFFF else "<Q", n), crc)
    if pos + 4 > len(raw):
        raise CheckpointError(f"{what}: truncated")
    (stored,) = struct.unpack_from("<I", raw, pos)
    if mask_crc(crc) != stored:
        raise CheckpointError(f"{what}: the lengths fail their crc32c")
    crc = _timed_crc(raw[pos:pos + 4], crc)
    pos += 4
    out = np.empty(count, dtype=object)
    for i, n in enumerate(lengths):
        out[i] = bytes(raw[pos:pos + n])
        pos += n
    if pos != len(raw):
        raise CheckpointError(f"{what}: {len(raw) - pos} bytes left after the strings")
    if mask_crc(_timed_crc(raw[pos - sum(lengths):pos], crc)) != entry.crc32c:
        raise CheckpointError(f"{what}: data fails its crc32c")
    return out.reshape(entry.shape)


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------


def _prefix(path: str) -> str:
    """A checkpoint prefix, or a directory's latest checkpoint (as
    ``tf.train.load_checkpoint`` resolves one)."""
    if os.path.isdir(path):
        latest = latest_checkpoint(path)
        if latest is None:
            raise ValueError(
                f"Couldn't find 'checkpoint' file or checkpoints in given directory {path}")
        return latest
    if not os.path.isfile(path + ".index"):
        raise FileNotFoundError(f"no TF checkpoint at {path} (no {path}.index)")
    return path


class CheckpointReader:
    """The variables of a TF checkpoint (a prefix, or a directory with a
    ``checkpoint`` state file): ``names()``, ``shapes()``, ``dtypes()``,
    ``read(name)`` (a numpy array) and ``read_bytes(name)`` (its stored
    bytes), each read checked against its checksum."""

    def __init__(self, path: str):
        self.prefix = _prefix(path)
        self.num_shards = 1
        self.entries: Dict[str, Entry] = {}
        for key, value in _table_entries(self.prefix + ".index"):
            if key == b"":
                self.num_shards = _header(value, self.prefix)
            else:
                name = key.decode("utf-8")
                self.entries[name] = _entry(name, value)

    def names(self) -> List[str]:
        return list(self.entries)

    def shapes(self) -> Dict[str, List[int]]:
        return {n: list(e.shape) for n, e in self.entries.items()}

    def dtypes(self) -> Dict[str, str]:
        return {n: e.dtype for n, e in self.entries.items()}

    def shard_path(self, shard_id: int) -> str:
        return f"{self.prefix}.data-{shard_id:05d}-of-{self.num_shards:05d}"

    def _raw(self, entry: Entry, f=None) -> np.ndarray:
        """The entry's bytes, read into a buffer of their own; numeric
        tensors' checksums checked here."""
        t0 = time.perf_counter()
        buf = np.empty(entry.size, np.uint8)
        if entry.size:
            own = f is None
            f = open(self.shard_path(entry.shard_id), "rb") if own else f
            try:
                f.seek(entry.offset)
                got = f.readinto(memoryview(buf))
            finally:
                if own:
                    f.close()
            if got != entry.size:
                raise CheckpointError(
                    f"{entry.name}: {entry.size} bytes at {entry.offset} of "
                    f"{self.shard_path(entry.shard_id)}, {got} there")
        if entry.dtype != "string" and mask_crc(_timed_crc(buf)) != entry.crc32c:
            raise CheckpointError(f"{entry.name}: data fails its crc32c")
        READ_STATS["bytes"] += entry.size
        READ_STATS["seconds"] += time.perf_counter() - t0
        return buf

    def _decode(self, entry: Entry, buf: np.ndarray) -> np.ndarray:
        count = int(np.prod(entry.shape, dtype=np.int64))
        if entry.dtype == "string":
            t0 = time.perf_counter()
            out = _decode_strings(memoryview(buf), count, entry)
            READ_STATS["seconds"] += time.perf_counter() - t0
            return out
        dtype = np.dtype(_NUMPY[entry.dtype])
        if entry.size != count * dtype.itemsize:
            raise CheckpointError(
                f"{entry.name}: {entry.size} bytes for {entry.dtype} of shape {entry.shape}")
        arr = buf.view(dtype).reshape(entry.shape)
        if entry.dtype == "bfloat16":
            return (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.astype(dtype.newbyteorder("="), copy=False)

    def read(self, name: str) -> np.ndarray:
        entry = self._entry(name)
        return self._decode(entry, self._raw(entry))

    def read_bytes(self, name: str) -> bytes:
        """The tensor's bytes as stored (bfloat16 unwidened; a string
        tensor's lengths, their checksum and its bytes), checksum checked."""
        entry = self._entry(name)
        buf = self._raw(entry)
        if entry.dtype == "string":
            self._decode(entry, buf)
        return buf.tobytes()

    def read_many(self, names) -> Dict[str, np.ndarray]:
        """Several tensors, read shard by shard in file order."""
        entries = sorted((self._entry(n) for n in names), key=lambda e: (e.shard_id, e.offset))
        out: Dict[str, np.ndarray] = {}
        for shard in sorted({e.shard_id for e in entries}):
            with open(self.shard_path(shard), "rb") as f:
                for e in (e for e in entries if e.shard_id == shard):
                    out[e.name] = self._decode(e, self._raw(e, f))
        return {n: out[n] for n in names}

    def _entry(self, name: str) -> Entry:
        try:
            return self.entries[name]
        except KeyError:
            raise KeyError(f"{name} not in checkpoint {self.prefix}") from None


def is_model_variable(name: str) -> bool:
    """False for what the converters never read: optimizer slots (``/Adam``,
    ``/Adam_1``, ``Momentum``), ``beta1_power``, ``beta2_power`` and
    ``global_step``."""
    if name.endswith("/Adam") or name.endswith("/Adam_1") or "Momentum" in name:
        return False
    return name not in ("beta1_power", "beta2_power", "global_step")


def read_checkpoint(path: str,
                    keep: Callable[[str], bool] = is_model_variable) -> Dict[str, np.ndarray]:
    """Every variable of a TF checkpoint that ``keep`` admits, as numpy
    arrays; the others are never read from disk."""
    reader = CheckpointReader(path)
    return reader.read_many([n for n in reader.names() if keep(n)])


# ---------------------------------------------------------------------------
# checkpoint state files
# ---------------------------------------------------------------------------

_STATE_PATH = re.compile(r'^\s*model_checkpoint_path\s*:\s*"((?:[^"\\]|\\.)*)"', re.M)


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """``tf.train.latest_checkpoint``: the prefix named by the directory's
    ``checkpoint`` state file (``model_checkpoint_path``, relative paths
    joined to the directory) when its files exist; None when there is no
    state file (a SavedModel's ``variables/``, a prefix, a missing path), it
    names nothing, or what it names is gone."""
    state = os.path.join(checkpoint_dir, "checkpoint")
    try:
        with open(state, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return None
    m = _STATE_PATH.search(text)
    if m is None:
        return None
    path = codecs.escape_decode(m.group(1).encode("utf-8"))[0].decode("utf-8")
    if not path:
        return None
    if not os.path.isabs(path):
        path = os.path.join(checkpoint_dir, path)
    if glob.glob(path + ".index") or glob.glob(path):
        return path
    return None
