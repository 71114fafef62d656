"""Data- and spatially-parallel batched serving over a mesh (port of
``semantic_depth_tpu/parallel/inference.py``).

* 'dp' (throughput): each rank runs the whole frame program
  (``_process_batch_impl``, the code ``process_batch`` runs) on its slice
  of the batch, geometry tail and kernels included. The only collective
  is the gather of the outputs.
* 'sp' (latency, ``make_spatial_mesh``): every rank resizes the whole
  frame (two matrix products: the small frame is then the single-device
  one, bit for bit) and keeps its rows; both networks run row-sharded with
  a halo exchange before every layer that reads neighbouring rows
  (``spatial.py``); the rows of the masks and the disparity are gathered,
  and the geometry tail runs whole on every rank of the sp group (GSPMD
  cannot partition a Pallas call either, and the tail's medians and
  compaction are global).

Every rank calls with the same global batch and gets the global outputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.resize import resize_clip_u8
from ..pipeline import (FrameOutputs, SemanticDepthPipeline, _scalar, _scaled_camera,
                        resolve_frame_scalars)
from . import comm
from .mesh import axis_rank, axis_size, shard_batch
from .spatial import RowShard


def gather_outputs(out, group) -> "FrameOutputs":
    """Every rank's outputs (FrameOutputs, or a tuple of tensors) gathered
    along the batch dim over ``group``, in one collective."""
    if isinstance(out, FrameOutputs):
        return FrameOutputs.from_leaves(comm.all_gather_tensors(out.leaves(), 0, group))
    return type(out)(comm.all_gather_tensors(list(out), 0, group))


class ShardedPipeline:
    """Wraps a SemanticDepthPipeline for mesh-sharded batch processing.

    The frame batch is split over the mesh's 'dp' dim and (when the mesh has
    one, ``make_spatial_mesh``) the image rows over 'sp'. The batch must
    divide by dp and the frame height by sp. Every rank of the mesh calls
    ``process_batch`` with the same frames and gets back the global
    FrameOutputs.
    """

    def __init__(self, pipeline: SemanticDepthPipeline, mesh):
        self.pipeline = pipeline
        self.mesh = mesh
        self.config = pipeline.config
        self.device = pipeline.device
        self.dp = axis_size(mesh, "dp")
        self.sp = axis_size(mesh, "sp")
        self._dp_group = mesh.get_group("dp") if self.dp > 1 else None
        self._rows = None
        if self.sp > 1:
            cfg = pipeline.config
            self._rows = RowShard(mesh.get_group("sp"), axis_rank(mesh, "sp"), self.sp,
                                  cfg.input_height, cfg.input_width)

    @torch.inference_mode()
    def process_batch(self, frames, focal: Optional[float] = None,
                      disparity_mult: Optional[float] = None) -> FrameOutputs:
        frames = torch.as_tensor(frames)
        focal, disparity_mult = resolve_frame_scalars(
            self.config, frames.shape[2], focal, disparity_mult)
        if frames.shape[0] % self.dp != 0:
            raise ValueError(f"batch {frames.shape[0]} not divisible by dp={self.dp}")
        if frames.shape[1] % self.sp != 0:
            raise ValueError(f"frame height {frames.shape[1]} not divisible by sp={self.sp}")
        local = shard_batch(self.mesh, frames).to(self.device)
        focal, mult = _scalar(focal), _scalar(disparity_mult)
        if self._rows is None:
            out = self.pipeline._process_batch_impl(local, focal, mult)
        else:
            out = self._process_rows(local, focal, mult)
        return out if self._dp_group is None else gather_outputs(out, self._dp_group)

    def _process_rows(self, frames, focal, disparity_mult) -> FrameOutputs:
        """The frame program with the networks' rows split over 'sp'."""
        pipe, rows = self.pipeline, self._rows
        cfg = pipe.config
        h = cfg.input_height
        cam, s_w = _scaled_camera(cfg, focal)
        small = resize_clip_u8(frames.float(), (h, cfg.input_width))  # whole, every rank
        split = rows.split(h)
        mine = rows.own(small, dim=1) if split else small
        road, fence = pipe._segment(mine, rows)
        disps = pipe._batch_disparity(mine, disparity_mult * s_w, rows)
        if split:
            road, fence, disps = comm.all_gather_tensors([road, fence, disps], 1, rows.group)
        return pipe._batch_geometry(small, road, fence, disps, cam)

    def process_frame(self, frame, focal: Optional[float] = None,
                      disparity_mult: Optional[float] = None) -> FrameOutputs:
        """Single-frame latency mode: the batch-1 program with image rows
        sharded over 'sp' (``make_spatial_mesh``; a dp>1 mesh cannot split
        one frame). Returns unbatched FrameOutputs like
        ``SemanticDepthPipeline.process_frame``."""
        return self.process_batch(torch.as_tensor(frame)[None], focal, disparity_mult).frame(0)
