"""Frozen serving: the fused frame program as a ``torch.export`` program
(port of ``semantic_depth_tpu/export.py``; the reference's frozen-graph path
``optimized_graph.pb`` + ``--use_frozen``, semantic_depth.py:472-513).

``export_pipeline`` traces ``SemanticDepthPipeline._process_batch_impl``,
the code path ``process_batch`` runs, with the weights inside the program,
and ``torch.export.save`` writes it (``.pt2``). The four kernels stay calls
of their dispatcher ops (``torch.ops.sd_torch.*``), so the loaded program
launches the same hand-written kernels on the card and takes their plain
versions on the CPU. ``load_pipeline`` builds no network module and reads no
weight file: the program carries both. The program is specialised to the
frame shape and dtype, and to the device it was exported on; export on the
device that serves.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple

import torch
from torch import nn

# the ops a program calls: importing the modules registers them
from .ops import exact_knn, knn_grid, mad, radius  # noqa: F401
from .ops.pcl import MaskedCloud
from .pipeline import FrameOutputs, SemanticDepthPipeline, _scalar

_SERIALIZED_NAMES = ((MaskedCloud, "semantic_depth_tpu_torch.MaskedCloud"),
                     (FrameOutputs, "semantic_depth_tpu_torch.FrameOutputs"))


def _register_outputs() -> None:
    """Register FrameOutputs and MaskedCloud as pytrees that serialize, so
    full-output programs save and load. Safe to call again."""
    from torch.utils import _pytree

    for cls, name in _SERIALIZED_NAMES:
        if cls not in _pytree.SUPPORTED_NODES:
            torch.export.register_dataclass(cls, serialized_type_name=name)


class _FrameProgram(nn.Module):
    """What ``export_pipeline`` traces: the pipeline's networks as
    submodules (their weights become the program's) and its frame program
    as ``forward(frame, focal, disparity_mult)``."""

    def __init__(self, pipe: SemanticDepthPipeline, batched: bool, scalars_only: bool):
        super().__init__()
        self.fcn, self.mono = pipe.fcn, pipe.mono
        self.pipe, self.batched, self.scalars_only = pipe, batched, scalars_only

    def forward(self, frame, focal, disparity_mult):
        frames = frame if self.batched else frame[None]
        out = self.pipe._process_batch_impl(frames, focal, disparity_mult)
        if not self.batched:
            out = out.frame(0)
        if self.scalars_only:
            return out.dist_rw, out.dist_f2f, out.rw_found
        return out


def export_pipeline(
    pipe: SemanticDepthPipeline,
    path: str,
    frame_shape: Tuple[int, ...] = (1024, 2048, 3),
    batched: bool = False,
    scalars_only: bool = True,
    frame_dtype: torch.dtype = torch.uint8,
) -> str:
    """Export the frame program for ``frame_shape`` inputs of ``frame_dtype``
    on the pipeline's device and write it to ``path``.

    scalars_only=True exports the serving surface (dist_rw, dist_f2f,
    rw_found): the stages only the dense outputs need (the overlay) drop out
    of the graph. Otherwise the program returns FrameOutputs. Focal and
    disparity multiplier are float32 inputs of the program, so one program
    serves any focal.

    A ``<path>.meta.json`` sidecar records the export-time config scalars,
    with the JAX package's keys, so serving (``cli.common.FrozenPipeline``)
    resolves its defaults from the EXPORT config."""
    want_rank = 4 if batched else 3
    if len(frame_shape) != want_rank:
        raise ValueError(
            f"batched={batched} needs a rank-{want_rank} frame_shape "
            f"({'B, ' if batched else ''}H, W, 3); got {frame_shape}"
        )
    if not scalars_only:
        _register_outputs()
    cfg = pipe.config
    example = (torch.zeros(frame_shape, dtype=frame_dtype, device=pipe.device),
               _scalar(cfg.camera.focal), _scalar(float(frame_shape[-2])))
    with torch.no_grad():
        program = torch.export.export(_FrameProgram(pipe, batched, scalars_only), example,
                                      strict=False)
    # the trace keeps every op it ran; what no output reads goes (with
    # scalars_only, the overlay and the fence chain's dense outputs)
    program.graph.eliminate_dead_code()
    program.graph_module.recompile()
    torch.export.save(program, path)
    meta = {
        "camera_focal": cfg.camera.focal,
        "disparity_multiplier": cfg.disparity_multiplier,
        "depth": cfg.depth,
        "approach": cfg.approach,
        "input_height": cfg.input_height,
        "input_width": cfg.input_width,
        "frame_shape": list(frame_shape),
        "frame_dtype": str(frame_dtype).removeprefix("torch."),
        "batched": batched,
        "scalars_only": scalars_only,
        "flip_average": cfg.monodepth.flip_average,
        "encoder": cfg.monodepth.encoder,
    }
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return path


def load_pipeline(path: str) -> Callable:
    """Load an exported program; returns call(frame, focal, disparity_mult).
    The frame is cast to the program's dtype (uint8 by default; values are
    0..255 either way) and moved to its device; a frame of another shape
    raises. ``call.frame_shape`` and ``call.device`` say what it takes."""
    _register_outputs()
    return _serve(torch.export.load(path))


def _moved(program, device: torch.device):
    """The program with its weights and constants on ``device``
    (``move_to_device_pass``; the program itself when it is there)."""
    if device == _frame_input(program).device:
        return program
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, device)


def _serve(program) -> Callable:
    frame_val = _frame_input(program)
    module = program.module()
    shape = tuple(frame_val.shape)

    def call(frame, focal, disparity_mult):
        frame = torch.as_tensor(frame)
        if tuple(frame.shape) != shape:
            raise ValueError(f"this frozen program takes frames of shape {shape} (batch "
                             f"and size are fixed at export); got {tuple(frame.shape)}")
        frame = frame.to(device=frame_val.device, dtype=frame_val.dtype)
        with torch.no_grad():
            return module(frame, _scalar(focal), _scalar(disparity_mult))

    call.frame_shape, call.device = shape, frame_val.device
    return call


def load_pipeline_sharded(path: str, mesh, axis: str = "dp") -> Callable:
    """dp-sharded serving of a BATCHED frozen program (port of the JAX
    ``load_pipeline_sharded``).

    The program holds the frame program for its export batch B; every rank
    of ``mesh`` loads it and runs it on its slice of a global batch of B x
    (the size of ``axis``), and the outputs are gathered along the batch,
    so every rank gets them all. A program exported on a card runs on this
    rank's current card, moved there (``_moved``) when it was exported on
    another; a CPU export runs on the CPU.

    Returns call(frames, focal, disparity_mult) with ``call.global_batch``
    set; frames must have leading dim exactly ``global_batch``.
    """
    from .parallel.inference import gather_outputs
    from .parallel.mesh import axis_size, shard_batch

    _register_outputs()
    program = torch.export.load(path)
    if _frame_input(program).device.type == "cuda":
        program = _moved(program, torch.device("cuda", torch.cuda.current_device()))
    single = _serve(program)
    if len(single.frame_shape) != 4:
        raise ValueError(
            "sharded frozen serving needs a BATCHED export "
            "(cli.export_pipeline --batch N); this program takes a single frame")
    blob_b = single.frame_shape[0]
    dp = axis_size(mesh, axis)
    global_b = blob_b * dp
    group = mesh.get_group(axis) if dp > 1 else None

    def call(frame, focal, disparity_mult):
        frame = torch.as_tensor(frame)
        if frame.shape[0] != global_b:
            raise ValueError(
                f"sharded frozen serving takes batch {global_b} "
                f"(= export batch {blob_b} x {axis}={dp}); got {frame.shape[0]}")
        out = single(shard_batch(mesh, frame, axis), focal, disparity_mult)
        return out if group is None else gather_outputs(out, group)

    call.global_batch, call.device = global_b, single.device
    return call


def _frame_input(program):
    """The exported program's frame input (a fake tensor: shape, dtype,
    device)."""
    name = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name == name)
    return node.meta["val"]


def load_pipeline_meta(path: str) -> Optional[dict]:
    """The export-time config sidecar of a program, if present."""
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)
