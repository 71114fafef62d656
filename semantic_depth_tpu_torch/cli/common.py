"""Shared CLI plumbing: image IO, annotation, weight loading, artifact suite
(port of ``semantic_depth_tpu/cli/common.py``).

Host-side by design: everything here happens before or after the frame
program (reading frames, writing PNGs, PLYs and text files). cv2 is used
when it imports (it is what the reference used, and keeps annotation and
codec parity); PIL is the fallback. Nothing here needs matplotlib, flax,
msgpack or TensorFlow: the disparity PNG reproduces ``plt.imsave(...,
cmap="gray")`` pixel for pixel, weight files are read by ``models.weights``
and TF1 checkpoints by ``models.tf_checkpoint``.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import PipelineConfig
from ..io import artifacts as art
from ..io.ply import PlyCloud
from ..models import FCN8s, Monodepth
from ..models import weights as weights_lib
from ..models.from_flax import load_flax
from ..models.tf_checkpoint import latest_checkpoint
from ..ops.pcl import MaskedCloud
from ..pipeline import FrameOutputs, SemanticDepthPipeline
from ..runtime import resolve_device

_WARNED_NO_TEXT = False

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


def imread_bgr(path: str) -> np.ndarray:
    """Read an image as BGR uint8: cv2.imread semantics (semantic_depth.py:105)."""
    if _HAS_CV2:
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return img
    from PIL import Image

    rgb = np.asarray(Image.open(path).convert("RGB"))
    return rgb[:, :, ::-1].copy()


def prefetch_decoded(paths, load, depth: int = 4, workers: int = 2):
    """Yield (path, load(path)) in order, decoding up to ``depth`` frames
    ahead on worker threads: cv2 and PIL release the interpreter lock inside
    the codec, so decoding overlaps the card's work on earlier frames.
    ``load`` failures propagate per item (callers map unreadable frames to
    None and skip them)."""
    import concurrent.futures as cf
    from collections import deque

    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        q = deque()
        for p in paths:
            q.append((p, ex.submit(load, p)))
            if len(q) >= depth:
                path, fut = q.popleft()
                yield path, fut.result()
        while q:
            path, fut = q.popleft()
            yield path, fut.result()


def imwrite(path: str, img: np.ndarray) -> None:
    """Write a BGR uint8 image: cv2.imwrite semantics."""
    img = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    if _HAS_CV2:
        cv2.imwrite(path, img)
        return
    from PIL import Image

    Image.fromarray(img[:, :, ::-1]).save(path)


def save_gray_png(path: str, img: np.ndarray) -> None:
    img = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    if _HAS_CV2:
        cv2.imwrite(path, img)
    else:
        from PIL import Image

        Image.fromarray(img, mode="L").save(path)


def host_resize(img: np.ndarray, oh: int, ow: int, cubic: bool = True) -> np.ndarray:
    """Host-side resize for artifact writing only (the frame program's resize
    is ``ops/resize.py`` on the card)."""
    img = np.asarray(img)
    if _HAS_CV2:
        interp = cv2.INTER_CUBIC if cubic else cv2.INTER_LINEAR
        return cv2.resize(img, (ow, oh), interpolation=interp)
    from PIL import Image

    mode = Image.BICUBIC if cubic else Image.BILINEAR
    return np.asarray(Image.fromarray(img.astype(np.uint8)).resize((ow, oh), mode))


# matplotlib's "gray" lookup table as ``Colormap(..., bytes=True)`` reads it:
# _create_lookup_table's linear ramp, then (lut * 255).astype(uint8), which
# truncates (entry i is i - 1 where i / 255 * 255 rounds below i).
_GRAY_LUT = (np.concatenate([[0.0], (255.0 * np.linspace(0.0, 1.0, 256))[1:-1] / 255.0, [1.0]])
             * 255).astype(np.uint8)


def gray_colormap_rgba(img: np.ndarray) -> np.ndarray:
    """(H, W) uint8 -> (H, W, 4) uint8: the pixels ``plt.imsave(...,
    cmap="gray")`` writes. The map normalises to the image's own min and
    max in float32, scales by 256, maps 256 to 255 and truncates to a table
    index; a constant image maps to entry 0. Alpha is 255."""
    x = np.asarray(img, np.uint8).astype(np.float32)
    lo, hi = x.min(), x.max()
    if lo == hi:
        idx = np.zeros(x.shape, np.intp)
    else:
        x = (x - lo) / (hi - lo)
        x *= 256
        x[x == 256] = 255
        idx = x.astype(np.intp)
    level = _GRAY_LUT[idx]
    return np.stack([level, level, level, np.full_like(level, 255)], -1)


def save_disparity_png(disp: np.ndarray, output_name: str, oh: int, ow: int) -> None:
    """Disparity visualisation: normalise to 0..255, upsample to the frame's
    size, write as an RGBA gray PNG (semantic_depth.py:681-683 used
    scipy.misc.imresize + plt.imsave; the pixels equal plt.imsave's)."""
    d = host_resize((disp / max(float(np.max(disp)), 1e-9) * 255.0).astype(np.float32),
                    oh, ow, cubic=False)
    rgba = gray_colormap_rgba(np.clip(d, 0, 255).astype(np.uint8))
    write_rgba_png(f"{output_name}_disp.png", rgba)


def write_rgba_png(path: str, rgba: np.ndarray) -> None:
    """An (H, W, 4) RGBA uint8 image as a PNG, as ``plt.imsave`` writes its
    pixels."""
    if _HAS_CV2:
        cv2.imwrite(path, rgba[..., [2, 1, 0, 3]])
        return
    from PIL import Image

    Image.fromarray(rgba, mode="RGBA").save(path)


# ---------------------------------------------------------------------------
# Annotation (cv2.putText / rectangle layout of semantic_depth.py:339-399)
# ---------------------------------------------------------------------------
#
# With cv2 present the calls match the reference pixel for pixel; without it
# a PIL ImageDraw fallback renders the same text and layout (another font
# rasterisation). With neither, text is skipped with a one-time warning.


def _fill_rect(img: np.ndarray, p0, p1, color_bgr) -> None:
    if _HAS_CV2:
        cv2.rectangle(img, p0, p1, color_bgr, -1)
        return
    x0, y0 = p0
    x1, y1 = p1
    img[max(0, y0): max(0, y1), max(0, x0): max(0, x1)] = np.asarray(color_bgr, np.uint8)


def _put_text(img: np.ndarray, text, org, font_scale, color_bgr, thickness) -> None:
    if _HAS_CV2:
        cv2.putText(img, text, org, fontFace=16, fontScale=font_scale, color=color_bgr,
                    thickness=thickness)
        return
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError:
        global _WARNED_NO_TEXT
        if not _WARNED_NO_TEXT:
            warnings.warn("neither cv2 nor PIL imports: annotation text skipped")
            _WARNED_NO_TEXT = True
        return

    pil = Image.fromarray(img[:, :, ::-1])
    draw = ImageDraw.Draw(pil)
    size = max(10, int(22 * font_scale))  # ~cv2 Hershey glyph height
    try:
        font = ImageFont.load_default(size=size)
    except TypeError:  # older Pillow: fixed-size bitmap font
        font = ImageFont.load_default()
    rgb = tuple(int(c) for c in color_bgr[::-1])
    # cv2's org is the text baseline; PIL anchors at the ascender
    draw.text((org[0], max(0, org[1] - size)), text, fill=rgb, font=font)
    img[:] = np.asarray(pil)[:, :, ::-1]


def annotate_single(
    img: np.ndarray,
    depth: float,
    is_city: bool,
    approach: str,
    dist_rw: float,
    left_rw: np.ndarray,
    right_rw: np.ndarray,
    dist_f2f: Optional[float] = None,
    left_f2f: Optional[np.ndarray] = None,
    right_f2f: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Header band + distance texts, matching semantic_depth.py:350-395."""
    img = np.clip(np.asarray(img), 0, 255).astype(np.uint8).copy()
    h, w = img.shape[:2]
    if is_city:
        thickness, font_scale = 2, 2
    else:
        thickness, font_scale = 5, 4
    left, middle = 0.01, 0.33
    right = 0.68 if is_city else 0.67
    h_zero, h_first, h_second = 0.05 * h, 0.12 * h, 0.18 * h
    white = (255, 255, 255)

    _fill_rect(img, (0, 0), (w, int(0.2 * h)), (156, 157, 159))
    _put_text(img, "At {:.2f}m depth:".format(depth), (int(middle * w), int(h_zero)),
              font_scale, white, thickness)
    if approach == "both" and dist_f2f is not None and np.isfinite(dist_f2f):
        _put_text(img, "{:.2f}m to l fence".format(-left_f2f[0]), (int(left * w), int(h_first)),
                  font_scale, white, thickness)
        _put_text(img, "{:.2f}m to r fence".format(right_f2f[0]),
                  (int(right * w), int(h_first)), font_scale, white, thickness)
        _put_text(img, "Fence2Fence: {:.2f}m".format(dist_f2f), (int(middle * w), int(h_first)),
                  font_scale, white, thickness)
    _put_text(img, "{:.2f}m to road's l".format(-left_rw[0]), (int(left * w), int(h_second)),
              font_scale, white, thickness)
    _put_text(img, "{:.2f}m to road's r".format(right_rw[0]), (int(right * w), int(h_second)),
              font_scale, white, thickness)
    _put_text(img, "Road's width: {:.2f}m".format(dist_rw), (int(middle * w), int(h_second)),
              font_scale, white, thickness)
    return img


def annotate_sequence(
    img: np.ndarray,
    depth: float,
    line_found: bool,
    dist_rw: float = float("nan"),
    left_rw=None,
    right_rw=None,
) -> np.ndarray:
    """Sequence-script annotation incl. the 'Cannot compute width' fallback
    (seq:310-328)."""
    img = np.clip(np.asarray(img), 0, 255).astype(np.uint8).copy()
    h, w = img.shape[:2]
    thickness, font_scale = 2, 2
    white = (255, 255, 255)
    if line_found:
        _fill_rect(img, (0, 0), (w, int(0.25 * h)), (156, 157, 159))
        _put_text(img, "At {:.2f} m depth:".format(depth), (int(0.36 * w), int(0.05 * h)),
                  font_scale + 0.2, white, thickness)
        _put_text(img, "{:.2f}m to road's left end".format(-left_rw[0]),
                  (int(0.05 * w), int(0.13 * h)), font_scale, white, thickness)
        _put_text(img, "{:.2f}m to road's right end".format(right_rw[0]),
                  (int(0.5 * w), int(0.13 * h)), font_scale, white, thickness)
        _put_text(img, "Road's width: {:.2f} m".format(dist_rw), (int(0.35 * w), int(0.22 * h)),
                  font_scale, white, thickness)
    else:
        _put_text(img, "Cannot compute width of road at {:.2f} m depth:".format(depth),
                  (int(0.28 * w), int(0.035 * h)), font_scale + 0.2, (0, 255, 0), thickness)
    return img


# ---------------------------------------------------------------------------
# Weight loading
# ---------------------------------------------------------------------------

def _load_msgpack(module: torch.nn.Module, path: str) -> torch.nn.Module:
    return load_flax(module, weights_lib.load_params(path))


def fcn_weights_file(path: str) -> Optional[str]:
    """The FCN-8s .msgpack of a path: the file itself, or fcn8s.msgpack in
    a directory; None where there is none."""
    if os.path.isfile(path) and path.endswith(".msgpack"):
        return path
    native = os.path.join(path, "fcn8s.msgpack")
    return native if os.path.isfile(native) else None


def fcn_checkpoint(path: str) -> Optional[str]:
    """The latest TF1 checkpoint under ``<path>/variables`` (the reference's
    SavedModel layout, fcn.py:100-107) or ``path``; None where there is
    none (a prefix among them, as ``tf.train.latest_checkpoint``)."""
    ckpt_dir = os.path.join(path, "variables")
    return latest_checkpoint(ckpt_dir if os.path.isdir(ckpt_dir) else path)


def fcn_params(path: str, template):
    """FCN-8s weights as a flax variable tree: ``fcn_weights_file``, else
    ``fcn_checkpoint`` converted on the fly and checked strictly against
    ``template`` (a flax tree of the network's parameters)."""
    native = fcn_weights_file(path)
    if native is not None:
        return weights_lib.load_params(native)
    ckpt = fcn_checkpoint(path)
    if ckpt is None:
        raise FileNotFoundError(f"no FCN weights found under {path}")
    converted = weights_lib.convert_fcn_checkpoint(ckpt)
    return weights_lib.graft_tree(template, converted, strict=True)[0]


def load_fcn_params(model: FCN8s, path: str) -> FCN8s:
    """Load FCN-8s weights into ``model`` from a .msgpack file, a directory
    holding fcn8s.msgpack, or a TF1 checkpoint directory (converted on the
    fly; ``fcn_params``). ``path == 'random'`` keeps the seeded init."""
    if path == "random":
        return model
    return load_flax(model, fcn_params(path, weights_lib.module_template(model)))


def load_mono_params(model: Monodepth, path: str) -> Monodepth:
    """Monodepth weights from a .msgpack file, monodepth.msgpack inside a
    directory argument or beside a TF checkpoint prefix, or else the TF1
    checkpoint itself (a prefix, or a directory's latest; the
    get_monodepth_model.sh layout), converted on the fly. 'random' keeps the
    seeded init."""
    if path == "random":
        return model
    if os.path.isfile(path) and path.endswith(".msgpack"):
        return _load_msgpack(model, path)
    # inside a directory argument, or as a sibling of a checkpoint prefix (a
    # bare dirname(path) would resolve 'w' and 'w/' differently)
    base = path if os.path.isdir(path) else (os.path.dirname(path) or ".")
    native = os.path.join(base, "monodepth.msgpack")
    if os.path.isfile(native):
        return _load_msgpack(model, native)
    converted = weights_lib.convert_monodepth_checkpoint(path, encoder=model.encoder)
    return weights_lib.as_torch_params(model, converted)


class FrozenPipeline:
    """Serves frames from a program of ``cli.export_pipeline`` (``export.py``):
    the reference's ``--use_frozen optimized_graph.pb`` path
    (semantic_depth.py:472-513), with the whole fused program in the
    artifact. No model code runs. The frame shape (and batch, for a batched
    export) and the device are fixed at export, like the reference's frozen
    graph; ``self.batch`` is the batch it serves (None: single-frame).

    mesh: dp-shard a batched program over a mesh's 'dp' dim
    (``export.load_pipeline_sharded``): every rank runs the program on its
    slice of a global batch of export batch x dp (``self.batch``), on its
    own card for a program exported on a card. Either way a program
    exported for another device type than ``device`` is refused."""

    def __init__(self, path: str, cfg: PipelineConfig, mesh=None, device: Optional[str] = None):
        from ..export import load_pipeline, load_pipeline_meta, load_pipeline_sharded

        if not os.path.isfile(path):
            raise SystemExit(f"--use_frozen: no frozen program at {path}")
        if mesh is not None:
            self._call = load_pipeline_sharded(path, mesh)
            self.batch = self._call.global_batch
        else:
            self._call = load_pipeline(path)
            shape = self._call.frame_shape
            self.batch = shape[0] if len(shape) == 4 else None
        if device is not None and torch.device(device).type != self._call.device.type:
            raise SystemExit(f"--use_frozen: {path} was exported for {self._call.device}; "
                             f"serve it there or export again on {device}")
        meta = load_pipeline_meta(path)
        if meta is not None:
            # depth, approach and camera are fixed inside the program: the
            # scalar defaults come from the EXPORT config, and a serving flag
            # that disagrees is ignored with a warning
            for key, got in (("depth", cfg.depth), ("approach", cfg.approach),
                             ("input_height", cfg.input_height),
                             ("input_width", cfg.input_width)):
                if meta.get(key) is not None and meta[key] != got:
                    warnings.warn(f"--use_frozen: {key}={got} is ignored; the program was "
                                  f"exported with {key}={meta[key]} (fixed inside it)")
            cfg = dataclasses.replace(
                cfg,
                camera=cfg.camera.with_focal(meta["camera_focal"]),
                disparity_multiplier=meta["disparity_multiplier"],
                depth=meta["depth"],
                approach=meta["approach"],
            )
        self.config = cfg

    def _run(self, frames, width, focal, disparity_mult):
        from types import SimpleNamespace

        from ..pipeline import resolve_frame_scalars

        focal, disparity_mult = resolve_frame_scalars(self.config, width, focal, disparity_mult)
        out = self._call(frames, focal, disparity_mult)
        if isinstance(out, (tuple, list)):  # a scalars-only program
            return SimpleNamespace(dist_rw=out[0], dist_f2f=out[1], rw_found=out[2])
        return out

    def process_frame(self, frame, focal=None, disparity_mult=None):
        return self._run(frame, frame.shape[1], focal, disparity_mult)

    def process_batch(self, frames, focal=None, disparity_mult=None):
        """A batch of the program's batch; a single-frame program serves
        batches of one (each output gains the leading batch axis)."""
        if self.batch is not None:
            return self._run(frames, frames.shape[2], focal, disparity_mult)
        if len(frames) != 1:
            raise ValueError(f"a single-frame program serves batches of one, got {len(frames)}; "
                             "export with cli.export_pipeline --batch N")
        out = self._run(frames[0], frames.shape[2], focal, disparity_mult)
        if isinstance(out, FrameOutputs):
            return FrameOutputs(**{f.name: _batch_of_one(getattr(out, f.name))
                                   for f in dataclasses.fields(out)})
        return type(out)(**{k: v[None] for k, v in vars(out).items()})


def _batch_of_one(val):
    if isinstance(val, MaskedCloud):
        return MaskedCloud(val.xyz[None], val.rgb[None], val.valid[None])
    return val[None]


def require_dense_outputs(out, flag_context: str):
    """Fail with an actionable message when outputs carry only the scalars
    (a scalars-only frozen program) on a path that writes dense artifacts."""
    if not hasattr(out, "overlay_small"):
        raise SystemExit(
            f"{flag_context} needs dense outputs; this frozen program was exported "
            "scalars-only: re-export with cli.export_pipeline --full_outputs")
    return out


def apply_encoder_override(cfg: PipelineConfig, encoder: str) -> PipelineConfig:
    """Apply a --monodepth_encoder value (vgg|resnet50, reference flag
    semantic_depth.py:721-722) to the config."""
    if encoder not in ("vgg", "resnet50"):
        raise ValueError(f"unknown monodepth encoder: {encoder!r}")
    if encoder == cfg.monodepth.encoder:
        return cfg
    return dataclasses.replace(cfg, monodepth=dataclasses.replace(cfg.monodepth, encoder=encoder))


def cli_device(args) -> str:
    """The device of the CLIs' flags: ``--device cpu``, or card
    ``--CUDA_DEVICE_NUMBER`` (default 0)."""
    return "cpu" if args.device == "cpu" else f"cuda:{int(args.CUDA_DEVICE_NUMBER)}"


def join_mesh(args):
    """``--mesh``: join the process group torchrun launched (one process per
    mesh position). Returns (this rank's device, whether this call created
    the group): its own card (``LOCAL_RANK``), or the CPU under ``--device
    cpu``. Exits with a message naming torchrun when no group was
    launched."""
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed

    created = not dist.is_initialized()
    try:
        return init_distributed("cpu" if args.device == "cpu" else None), created
    except RuntimeError as e:
        if "no process group" not in str(e):
            raise
        flag = "--mesh" if args.mesh is True else f"--mesh {args.mesh}"
        raise SystemExit(f"{flag}: {e}") from None


def is_writer() -> bool:
    """Whether this process writes the artifacts: rank 0 of a process group,
    or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def leave_mesh(created: bool) -> None:
    """Every rank at the end of a ``--mesh`` run: wait for the others (rank 0
    is still writing), and end the group if ``join_mesh`` created it."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        if created:
            dist.destroy_process_group()


def build_pipeline(
    cfg: PipelineConfig, semantic_model: str, monodepth_checkpoint: str,
    tiny: bool = False, native_s2d: bool = False, device=None,
) -> SemanticDepthPipeline:
    """tiny=True builds width-scaled networks (a test and smoke mode).
    native_s2d=True builds the input_s2d full-resolution variants and turns
    off the monodepth flip-average pass, as every native surface of the JAX
    package does. 'random' weights are torch's init under seeds 0 (FCN-8s)
    and 1 (monodepth). ``device`` None is the card."""
    if native_s2d:
        cfg = dataclasses.replace(
            cfg, monodepth=dataclasses.replace(cfg.monodepth, flip_average=False))
    # the packed vgg trunk halves 7 times (input/2 must divide by 128); the
    # resnet50 trunk halves 6 times (divide by 64)
    need = 256 if cfg.monodepth.encoder == "vgg" else 128
    if native_s2d and (cfg.input_height % need or cfg.input_width % need):
        raise ValueError(
            f"--native_s2d needs input_height/input_width multiples of {need} "
            f"(got {cfg.input_height}x{cfg.input_width}): the 2x2-packed "
            f"{cfg.monodepth.encoder} trunk requires its half-resolution grid "
            f"to divide by {need // 2}")
    dev = resolve_device(device)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    fcn_kw = dict(width_mult=0.0625, fc_channels=32) if tiny else {}
    mono_kw = dict(width_mult=0.0625) if tiny else {}
    with torch.device(dev):
        torch.manual_seed(0)
        fcn = FCN8s(num_classes=cfg.segmenter.num_classes, input_s2d=native_s2d,
                    compute_dtype=dtype, **fcn_kw)
        torch.manual_seed(1)
        mono = Monodepth(encoder=cfg.monodepth.encoder, input_s2d=native_s2d,
                         compute_dtype=dtype, **mono_kw)
    load_fcn_params(fcn, semantic_model)
    load_mono_params(mono, monodepth_checkpoint)
    return SemanticDepthPipeline(cfg, fcn, mono, device=dev)


# ---------------------------------------------------------------------------
# Outputs to the host
# ---------------------------------------------------------------------------


def fetch(out: FrameOutputs, fields: Optional[Sequence[str]] = None) -> Callable[[], FrameOutputs]:
    """Start copying ``fields`` of ``out`` (all by default; ``out`` may also
    be a scalars-only frozen program's distances) to the host and
    return a function that waits for the copies and gives FrameOutputs of
    numpy arrays (the fields not fetched are None). On the card the copies
    go into pinned memory without blocking, so the host can start the next
    frame before this one is done; an event marks their end."""
    names = [f.name for f in dataclasses.fields(FrameOutputs)] if fields is None else list(fields)
    on_card = out.dist_rw.is_cuda

    def host(t: torch.Tensor) -> torch.Tensor:
        if not on_card:
            return t
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t, non_blocking=True)

    copies = {}
    for name in names:
        val = getattr(out, name)
        if isinstance(val, MaskedCloud):
            copies[name] = MaskedCloud(host(val.xyz), host(val.rgb), host(val.valid))
        else:
            copies[name] = host(val)
    done = None
    if on_card:
        done = torch.cuda.Event()
        done.record()

    def wait() -> FrameOutputs:
        if done is not None:
            done.synchronize()
        vals = dict.fromkeys(f.name for f in dataclasses.fields(FrameOutputs))
        for name, val in copies.items():
            if isinstance(val, MaskedCloud):
                val = MaskedCloud(val.xyz.numpy(), val.rgb.numpy(), val.valid.numpy())
            else:
                val = val.numpy()
            vals[name] = val
        return FrameOutputs(**vals)

    return wait


# ---------------------------------------------------------------------------
# Artifact suite for the single-image entry (FrameProcessor save_data path,
# semantic_depth.py:129-438)
# ---------------------------------------------------------------------------


def save_frame_artifacts(
    out: FrameOutputs,
    cfg: PipelineConfig,
    output_name: str,
    original_bgr: np.ndarray,
    is_city: bool,
) -> None:
    """``out``: one frame's outputs as numpy arrays (``fetch(out)()``)."""
    oh, ow = original_bgr.shape[:2]
    overlay_full = host_resize(out.overlay_small.astype(np.float32), oh, ow)

    # only-segmentation image (semantic_depth.py:341-345)
    imwrite(f"{output_name}_only_segmentation.png", overlay_full)

    save_disparity_png(out.disparity, output_name, oh, ow)

    # gray masked sanity images (semantic_depth.py:172-177)
    colors = out.colors
    gray = colors @ np.array([0.299, 0.587, 0.114])
    save_gray_png(f"{output_name}_road_mask.png", gray * out.road_mask)
    save_gray_png(f"{output_name}_fence_mask.png", gray * out.fence_mask)

    flat_pts = out.points3d.reshape(-1, 3)
    flat_cols = colors.reshape(-1, 3)

    # raw full cloud (semantic_depth.py:163-166)
    PlyCloud(flat_pts, flat_cols, f"{output_name}_raw").save()

    # npz of masked clouds (semantic_depth.py:194-197)
    road_flat, fence_flat = out.road_mask.reshape(-1), out.fence_mask.reshape(-1)
    np.savez(
        f"{output_name}_pointCloud.npz",
        road3D=flat_pts[road_flat],
        road_colors=flat_cols[road_flat],
        fence3D=flat_pts[fence_flat],
        fence_colors=flat_cols[fence_flat],
    )

    road_valid = out.road_cloud.valid
    road_xyz = out.road_cloud.xyz[road_valid]
    road_rgb = out.road_cloud.rgb[road_valid]
    PlyCloud(road_xyz, road_rgb, f"{output_name}_ROAD").save()

    line_found = bool(out.rw_found)
    combined = PlyCloud(road_xyz, road_rgb, output_name)
    mesh, mesh_cols = art.plane_mesh(
        road_xyz, out.road_plane, cfg.road.plane.axis, cfg.road.plane.plane_color)
    combined.add(mesh, mesh_cols)
    rw_line = art.measurement_line(out.left_pt_rw, out.right_pt_rw, [250, 0, 0])
    if line_found:
        line, line_cols = rw_line
        line = line.copy()
        line[:, 2] += 0.2  # visualization shift (semantic_depth.py:265)
        combined.add(line, line_cols)

    if cfg.approach == "both":
        fl_xyz, fl_rgb = flat_pts[out.fence_left_valid], flat_cols[out.fence_left_valid]
        fr_xyz, fr_rgb = flat_pts[out.fence_right_valid], flat_cols[out.fence_right_valid]
        fence_ply = PlyCloud(fl_xyz, fl_rgb, f"{output_name}_FENCE")
        fence_ply.add(fr_xyz, fr_rgb)
        fence_ply.save()

        combined.add(fl_xyz, fl_rgb)
        combined.add(fr_xyz, fr_rgb)
        if fl_xyz.shape[0] and fr_xyz.shape[0]:
            combined.add(*art.plane_mesh(fl_xyz, out.fence_left_plane, cfg.fence.plane_left.axis,
                                         cfg.fence.plane_left.plane_color))
            combined.add(*art.plane_mesh(fr_xyz, out.fence_right_plane,
                                         cfg.fence.plane_right.axis,
                                         cfg.fence.plane_right.plane_color))
        f2f_line = art.measurement_line(out.left_pt_f2f, out.right_pt_f2f, [0, 255, 0])
        combined.add(*f2f_line)
    combined.save()

    # ALL cloud with measurement lines (semantic_depth.py:433-438)
    all_ply = PlyCloud(flat_pts, flat_cols, f"{output_name}_ALL")
    if line_found:
        all_ply.add(*rw_line)
    if cfg.approach == "both":
        all_ply.add(*f2f_line)
    all_ply.save()

    # annotated overlay (the headline output PNG)
    annotated = annotate_single(
        overlay_full, cfg.depth, is_city, cfg.approach, float(out.dist_rw),
        out.left_pt_rw, out.right_pt_rw, float(out.dist_f2f), out.left_pt_f2f, out.right_pt_f2f,
    )
    imwrite(f"{output_name}.png", annotated)
