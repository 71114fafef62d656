"""Write TF1 checkpoints (TensorBundle V2) without TensorFlow: a
verification helper for the port's reader (``models/tf_checkpoint.py``),
outside the package.

``write_bundle(prefix, tensors)`` writes ``<prefix>.index`` (a LevelDB
table: 4 KiB data blocks by default, restart points every 16 entries,
uncompressed, each block followed by its type byte and masked CRC-32C) and
``<prefix>.data-00000-of-00001`` (the tensors' little-endian bytes in name
order, each entry with the masked CRC-32C of its bytes), plus a
``checkpoint`` state file naming the prefix relative to its directory.
``tf.train.load_checkpoint`` reads what it writes (tier-1 test
``tests/test_torch_tf_checkpoint.py``).

``seeded_bundle(kind, prefix, seed)`` writes a full-width network's bundle
under the reference's TF variable names from seeded parameters, with Adam
slots, ``beta1_power``, ``beta2_power`` and ``global_step`` beside them, as
in the published sets: ``fcn`` (the VGG16 layers under the Udacity
SavedModel's ``<layer>/filter`` / ``/biases``, the decoder under
tf.layers' ``conv2d{_i}`` / ``conv2d_transpose{_i}``) or ``monodepth``
(slim's ``model/encoder/Conv{_i}`` and ``model/decoder/Conv{_i}``). It
returns the flax variable tree the converters must give back. Each slot
holds values of its own (the variable + 1 and the variable x 2), so a
reader that returned a slot for its variable fails the comparison. Used by
``chip_smoke.py`` phase 15 and the tier-1 tests.
"""

from __future__ import annotations

import os
import struct
import sys
from typing import Dict, Mapping, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from semantic_depth_tpu_torch.models import weights as W  # noqa: E402
from semantic_depth_tpu_torch.models.tf_checkpoint import crc32c, mask_crc  # noqa: E402

_MAGIC = 0xDB4775248B80FB57
_DTYPE_ENUM = {"float32": 1, "float64": 2, "int32": 3, "uint8": 4, "int16": 5, "int8": 6,
               "int64": 9, "bool": 10, "float16": 19}


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value) if value else b""


def _field_bytes(num: int, value: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(value)) + value


def _entry_proto(dtype: str, shape, offset: int, size: int, crc: int) -> bytes:
    dims = b"".join(_field_bytes(2, _field_varint(1, d)) for d in shape)
    return (_field_varint(1, _DTYPE_ENUM[dtype]) + _field_bytes(2, dims) + _field_varint(4, offset)
            + _field_varint(5, size) + _varint((6 << 3) | 5) + struct.pack("<I", crc))


class _Table:
    """A LevelDB table writer: keys added in sorted order."""

    def __init__(self, f, block_size: int):
        self.f, self.block_size, self.offset = f, block_size, 0
        self.index = []  # (last key of a data block, its handle)
        self._reset()

    def _reset(self):
        self.buf, self.restarts, self.n, self.last = bytearray(), [0], 0, b""

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.n % 16 == 0:
            if self.n:
                self.restarts.append(len(self.buf))
        else:
            while (shared < min(len(key), len(self.last))
                   and key[shared] == self.last[shared]):
                shared += 1
        self.buf += (_varint(shared) + _varint(len(key) - shared) + _varint(len(value))
                     + key[shared:] + value)
        self.n, self.last = self.n + 1, key
        if len(self.buf) >= self.block_size:
            self._flush()

    def _write_block(self, contents: bytes) -> bytes:
        trailer = b"\x00" + struct.pack("<I", mask_crc(crc32c(contents + b"\x00")))
        handle = _varint(self.offset) + _varint(len(contents))
        self.f.write(contents + trailer)
        self.offset += len(contents) + len(trailer)
        return handle

    @staticmethod
    def _block(entries: bytes, restarts) -> bytes:
        return entries + struct.pack(f"<{len(restarts)}I", *restarts) + struct.pack(
            "<I", len(restarts))

    def _flush(self):
        if self.n:
            self.index.append((self.last, self._write_block(self._block(self.buf,
                                                                        self.restarts))))
            self._reset()

    def finish(self) -> None:
        self._flush()
        meta = self._write_block(self._block(b"", [0]))
        index, restarts = bytearray(), []
        for key, handle in self.index:  # a restart at every index entry
            restarts.append(len(index))
            index += _varint(0) + _varint(len(key)) + _varint(len(handle)) + key + handle
        idx = self._write_block(self._block(bytes(index), restarts or [0]))
        footer = (meta + idx).ljust(40, b"\x00") + struct.pack("<Q", _MAGIC)
        self.f.write(footer)


def write_bundle(prefix: str, tensors: Mapping[str, np.ndarray],
                 block_size: int = 4096, state_file: bool = True) -> int:
    """Write ``tensors`` (name -> numpy array) as a TF1 checkpoint at
    ``prefix``; returns the bytes written."""
    names = sorted(tensors, key=lambda n: n.encode("utf-8"))
    entries = {}
    offset = 0
    d = os.path.dirname(prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        for name in names:
            arr = np.asarray(tensors[name], order="C")
            if arr.dtype.name not in _DTYPE_ENUM:
                raise ValueError(f"{name}: dtype {arr.dtype} is not written")
            raw = memoryview(arr.astype(arr.dtype.newbyteorder("<"), copy=False)
                             .reshape(-1).view(np.uint8))
            f.write(raw)
            entries[name] = _entry_proto(arr.dtype.name, arr.shape, offset, len(raw),
                                         mask_crc(crc32c(raw)))
            offset += len(raw)
    header = _field_varint(1, 1) + _field_bytes(3, _field_varint(1, 1))  # 1 shard, producer 1
    with open(f"{prefix}.index", "wb") as f:
        table = _Table(f, block_size)
        table.add(b"", header)
        for name in names:
            table.add(name.encode("utf-8"), entries[name])
        table.finish()
        index_bytes = f.tell()
    if state_file:
        base = os.path.basename(prefix)
        with open(os.path.join(d or ".", "checkpoint"), "w") as f:
            f.write(f'model_checkpoint_path: "{base}"\nall_model_checkpoint_paths: "{base}"\n')
    return offset + index_bytes


def _tf_names(kind: str, params: Mapping[str, Mapping[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """The flax tree's leaves under the reference's TF variable names."""
    out = {}
    if kind == "fcn":
        for scope, ours in W._FCN_VGG_NAME_MAP.items():
            out[f"{scope}/filter"] = params[ours]["kernel"]
            out[f"{scope}/biases"] = params[ours]["bias"]
        for base, order in (("conv2d", W._FCN_DECODER_CONV_ORDER),
                            ("conv2d_transpose", W._FCN_DECODER_DECONV_ORDER)):
            for i, ours in enumerate(order):
                scope = base if i == 0 else f"{base}_{i}"
                out[f"{scope}/kernel"] = params[ours]["kernel"]
                out[f"{scope}/bias"] = params[ours]["bias"]
        return out
    for scope, order in (("model/encoder", W._MONODEPTH_VGG_ENCODER),
                         ("model/decoder", W._monodepth_decoder_order(7))):
        for i, ours in enumerate(order):
            conv = "Conv" if i == 0 else f"Conv_{i}"
            out[f"{scope}/{conv}/weights"] = params[ours]["kernel"]
            out[f"{scope}/{conv}/biases"] = params[ours]["bias"]
    return out


def seeded_params(kind: str, seed: int = 0, width_mult: float = 1.0,
                  fc_channels: Optional[int] = None) -> Dict[str, Dict[str, np.ndarray]]:
    """A flax variable tree of the network's shapes (full width by default),
    normal kernels of std 1/sqrt(fan-in) and small biases, from ``seed``."""
    import torch

    from semantic_depth_tpu_torch.models import FCN8s, Monodepth

    with torch.device("meta"):
        if kind == "fcn":
            kw = {} if fc_channels is None else {"fc_channels": fc_channels}
            model = FCN8s(width_mult=width_mult, **kw)
        else:
            model = Monodepth("vgg", width_mult=width_mult)
    rng = np.random.default_rng(seed)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for layer, leaves in W.module_template(model)["params"].items():
        k = leaves["kernel"].shape
        params[layer] = {
            "kernel": (rng.standard_normal(k, np.float32)
                       * np.float32(1.0 / np.sqrt(k[0] * k[1] * k[2]))),
            "bias": rng.standard_normal(leaves["bias"].shape, np.float32) * np.float32(0.05),
        }
    return {"params": params}


def seeded_bundle(kind: str, prefix: str, seed: int = 0, **shape_kw):
    """Write a seeded network's bundle at ``prefix`` with Adam slots (the
    variable + 1 and the variable x 2), ``beta1_power``, ``beta2_power`` and
    ``global_step``; returns (the flax tree, the bytes written)."""
    tree = seeded_params(kind, seed, **shape_kw)
    tensors = _tf_names(kind, tree["params"])
    for name in list(tensors):
        tensors[f"{name}/Adam"] = tensors[name] + np.float32(1)
        tensors[f"{name}/Adam_1"] = tensors[name] * np.float32(2)
    tensors["beta1_power"] = np.float32(0.9 ** 1000)
    tensors["beta2_power"] = np.float32(0.999 ** 1000)
    tensors["global_step"] = np.int64(1000)
    return tree, write_bundle(prefix, tensors)
