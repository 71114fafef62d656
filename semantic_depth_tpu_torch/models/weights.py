"""Weight files and TF1-checkpoint conversion without flax, msgpack or
TensorFlow (port of ``semantic_depth_tpu/models/weights.py``).

Conversion: the reference publishes its weight sets as TF1 checkpoints
(the Udacity VGG16 SavedModel, the trained FCN-8s sets, the monodepth
checkpoints). ``convert_monodepth_checkpoint``, ``convert_fcn_checkpoint``
and ``convert_vgg_checkpoint`` map their variables onto the networks' flax
variable trees, as the JAX functions of the same names do, reading the
checkpoint with ``tf_checkpoint`` instead of TensorFlow. Nothing is
transposed: conv kernels stay HWIO and ``conv2d_transpose`` kernels stay
(H, W, O, I), the flax layout, and ``from_flax`` makes the one move to
torch's. slim numbers a scope's layers Conv, Conv_1, ... in creation order,
the order the modules create their layers in, so the mapping is positional
per scope. ``as_torch_params`` (``as_jax_params`` there) loads a converted
tree into a module strictly; ``graft_partial`` loads the layers present.

Weight files:
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

import re
import struct
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from .from_flax import flax_from_module, load_flax
from .tf_checkpoint import read_checkpoint

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


# --- TF1 checkpoints -------------------------------------------------------------


def _read_tf_checkpoint(ckpt_path: str) -> Dict[str, np.ndarray]:
    """Every model variable of a TF1 checkpoint (a prefix, or a directory
    with a ``checkpoint`` state file) as numpy; optimizer slots and step
    counters are never read."""
    return read_checkpoint(ckpt_path)


def _slim_layer_ids(names: List[str], scope: str) -> List[int]:
    """Integer indices of slim auto-named layers (Conv, Conv_1, Conv_2, ...)
    of one scope, sorted in creation order."""

    def key(n):
        m = re.match(rf"{re.escape(scope)}/Conv(?:_(\d+))?/", n)
        if not m:
            return None
        return int(m.group(1) or 0)

    return sorted({key(n) for n in names if key(n) is not None})


# monodepth: the modules' layer creation order, which is the reference
# graph's per-scope slim numbering
_MONODEPTH_VGG_ENCODER = [f"enc{i}{s}" for i in range(1, 8) for s in ("a", "b")]


def _monodepth_decoder_order(n_ups: int) -> List[str]:
    names = []
    for level in range(n_ups, 0, -1):
        names.append(f"upconv{level}")
        names.append(f"iconv{level}")
        if level <= 4:
            names.append(f"disp{level}")
    return names


def _monodepth_resnet_encoder_order() -> List[str]:
    """Encoder conv creation order of the resnet50 variant. Every resconv
    carries a projection shortcut (upstream's ``do_proj`` compares a TF1
    tensor to an int with ``!=``, always True), so a published checkpoint
    has 1 + 16 * 4 = 65 encoder convs."""
    names = ["enc1"]
    for blk, n in (("res2", 3), ("res3", 4), ("res4", 6), ("res5", 3)):
        for i in range(n):
            base = f"{blk}_{i}"
            names += [f"{base}_c1", f"{base}_c2", f"{base}_c3", f"{base}_sc"]
    return names


def convert_monodepth_checkpoint(
    ckpt_path: str, encoder: str = "vgg", use_deconv: bool = False
) -> Dict:
    """TF1 monodepth checkpoint -> flax variable tree for ``Monodepth``.

    use_deconv: for checkpoints trained with the transposed-conv decoder
    (slim names those ``Conv2d_transpose{_i}``, numbered apart from the
    ``Conv{_i}`` sequence)."""
    tf_vars = _read_tf_checkpoint(ckpt_path)
    names = list(tf_vars)
    params: Dict[str, Dict[str, np.ndarray]] = {}

    def take(scope: str, slim_idx: int, our_name: str, op: str = "Conv"):
        suffix = "" if slim_idx == 0 else f"_{slim_idx}"
        w = tf_vars[f"{scope}/{op}{suffix}/weights"]
        bias_name = f"{scope}/{op}{suffix}/biases"
        if bias_name not in tf_vars:
            # slim convs always have biases: a missing one means the naming
            # or the mapping is wrong, which silently zeroed biases would hide
            raise KeyError(
                f"{bias_name} not in checkpoint (kernel found at "
                f"{scope}/{op}{suffix}/weights) — unexpected variable naming"
            )
        params[our_name] = {"kernel": w, "bias": tf_vars[bias_name]}

    if encoder == "vgg":
        enc_names = _MONODEPTH_VGG_ENCODER
        n_ups = 7
    elif encoder == "resnet50":
        enc_names = _monodepth_resnet_encoder_order()
        n_ups = 6
        n_enc = len(_slim_layer_ids(names, "model/encoder"))
        if n_enc != len(enc_names):
            raise ValueError(
                f"resnet50 checkpoint has {n_enc} encoder convs; expected "
                f"{len(enc_names)} — not a monodepth resnet50 checkpoint?"
            )
    else:
        raise ValueError(encoder)

    for idx, our in enumerate(enc_names):
        take("model/encoder", idx, our)
    if use_deconv:
        conv_idx = deconv_idx = 0
        for our in _monodepth_decoder_order(n_ups):
            if our.startswith("upconv"):
                take("model/decoder", deconv_idx, our, op="Conv2d_transpose")
                deconv_idx += 1
            else:
                take("model/decoder", conv_idx, our)
                conv_idx += 1
    else:
        for idx, our in enumerate(_monodepth_decoder_order(n_ups)):
            take("model/decoder", idx, our)
    return {"params": params}


# FCN-8s: the Udacity VGG16 SavedModel's scopes and the module's names
_FCN_VGG_NAME_MAP = {
    f"conv{b}_{c}": f"conv{b}_{c}"
    for b, n in [(1, 2), (2, 2), (3, 3), (4, 3), (5, 3)]
    for c in range(1, n + 1)
}
_FCN_VGG_NAME_MAP.update({"fc6": "fc6", "fc7": "fc7"})

# the decoder's tf.layers in graph order (fcn.py:165-213): auto-named conv2d,
# conv2d_1, conv2d_2 and conv2d_transpose, conv2d_transpose_1, _2
_FCN_DECODER_CONV_ORDER = ["score_fc7", "score_pool4", "score_pool3"]
_FCN_DECODER_DECONV_ORDER = ["upscore2", "upscore4", "upscore8"]


def _resolve_vgg_layer(tf_vars: Dict, tf_scope: str):
    """A VGG conv's (kernel, bias) under any of the three export namings:
    '<layer>/filter' (Udacity SavedModel), '<layer>/weights' (slim) or
    '<layer>/kernel' (tf.layers)."""
    for wkey, bkey in (
        (f"{tf_scope}/filter", f"{tf_scope}/biases"),
        (f"{tf_scope}/weights", f"{tf_scope}/biases"),
        (f"{tf_scope}/kernel", f"{tf_scope}/bias"),
    ):
        if wkey in tf_vars:
            return tf_vars[wkey], tf_vars[bkey]
    raise KeyError(f"VGG variable for layer {tf_scope} not found in checkpoint")


def convert_fcn_checkpoint(ckpt_path: str) -> Dict:
    """TF1 FCN-8s checkpoint (VGG and decoder, fcn.py's save_model) -> flax
    variable tree for ``FCN8s``; the transposed-conv kernels pass through
    in TF's (H, W, O, I)."""
    tf_vars = _read_tf_checkpoint(ckpt_path)
    params: Dict[str, Dict[str, np.ndarray]] = {}

    def put(our_name: str, w: np.ndarray, b: np.ndarray):
        params[our_name] = {"kernel": w, "bias": b}

    for tf_scope, our_name in _FCN_VGG_NAME_MAP.items():
        put(our_name, *_resolve_vgg_layer(tf_vars, tf_scope))

    def auto_name(base: str, i: int) -> str:
        return base if i == 0 else f"{base}_{i}"

    for i, our_name in enumerate(_FCN_DECODER_CONV_ORDER):
        base = auto_name("conv2d", i)
        put(our_name, tf_vars[f"{base}/kernel"], tf_vars[f"{base}/bias"])
    for i, our_name in enumerate(_FCN_DECODER_DECONV_ORDER):
        base = auto_name("conv2d_transpose", i)
        put(our_name, tf_vars[f"{base}/kernel"], tf_vars[f"{base}/bias"])
    return {"params": params}


def convert_vgg_checkpoint(ckpt_path: str) -> Dict:
    """Encoder-only VGG16 checkpoint (the 'vgg' download of helper.py:60-94)
    -> flax variable tree of the encoder layers alone. The reference starts
    its decoder from trunc-normal (fcn.py:82-95): load this with
    ``graft_partial``."""
    tf_vars = _read_tf_checkpoint(ckpt_path)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for tf_scope, our_name in _FCN_VGG_NAME_MAP.items():
        w, b = _resolve_vgg_layer(tf_vars, tf_scope)
        params[our_name] = {"kernel": w, "bias": b}
    return {"params": params}


def graft_tree(template: Mapping[str, Any], converted: Mapping[str, Any],
               strict: bool = False) -> Tuple[Dict[str, Any], List[str]]:
    """Put ``converted``'s leaves onto a flax variable tree ``template``
    where both have them, cast to the template's dtype; the template's
    other leaves stay (``strict``: a missing one raises KeyError). A shape
    mismatch raises ValueError. Returns (tree, sorted loaded layer names)."""
    out: Dict[str, Any] = {}
    loaded = set()
    for col, layers in template.items():
        for layer, leaves in layers.items():
            for kind, v in leaves.items():
                key = (col, layer, kind)
                cv = converted.get(col, {}).get(layer, {}).get(kind)
                if cv is None:
                    if strict:
                        raise KeyError(f"missing converted weight for {key}")
                    cv = v
                else:
                    cv = np.asarray(cv)
                    if cv.shape != tuple(v.shape):
                        raise ValueError(
                            f"shape mismatch at {key}: ckpt {cv.shape} vs model {tuple(v.shape)}")
                    cv = cv.astype(np.asarray(v).dtype, copy=False)
                    loaded.add(layer)
                out.setdefault(col, {}).setdefault(layer, {})[kind] = cv
    return out, sorted(loaded)


def module_template(module: torch.nn.Module) -> Dict[str, Any]:
    """The module's parameters as a flax tree of float32 placeholders of
    their flax shapes (no copy of the weights)."""
    params: Dict[str, Any] = {}
    for name, t in module.state_dict().items():
        layer, kind = name.rsplit(".", 1)
        shape = tuple(t.shape[i] for i in (2, 3, 1, 0)) if kind == "weight" else tuple(t.shape)
        params.setdefault(layer, {})["kernel" if kind == "weight" else "bias"] = (
            np.broadcast_to(np.float32(0), shape))
    return {"params": params}


def graft_partial(module: torch.nn.Module, converted: Mapping[str, Any]) -> List[str]:
    """Load the layers of ``converted`` into ``module`` where present; the
    others keep their (seeded) init. A shape mismatch raises. Returns the
    loaded layer names."""
    tree, loaded = graft_tree(flax_from_module(module), converted)
    load_flax(module, tree)
    return loaded


def as_torch_params(module: torch.nn.Module, converted: Mapping[str, Any]) -> torch.nn.Module:
    """Load a converted tree into ``module`` strictly (``as_jax_params``):
    a missing layer raises KeyError, a shape mismatch ValueError."""
    tree, _ = graft_tree(module_template(module), converted, strict=True)
    return load_flax(module, tree)
