"""Pipeline parallelism ('pp'): GPipe-style staged serving (port of
``semantic_depth_tpu/parallel/pp.py``).

The frame program factors into sequential stages with a uniform boundary
(``_batch_segment`` -> ``_batch_disparity`` -> ``_batch_geometry``). Each
rank of a 'pp' group runs one stage, and microbatches stream through
them: at clock step t, stage s works on microbatch t - s, and after the
step every stage's boundary (small frame, road and fence masks,
disparity) moves one stage on through ``comm.handoff``. With pp=2 the
stages are resize+FCN and monodepth+geometry; pp=3 splits monodepth and
geometry apart. A (dp, pp) mesh splits each microbatch over 'dp'.

The last stage keeps each microbatch's outputs, and after the last step
broadcasts them to the other stages, so every rank returns the global
outputs in frame order. The JAX module deals finished outputs round-robin
over the stage devices to bound XLA's stacked scan output; here nothing
stacks a slot per clock step (the last stage keeps only the T real
outputs), so there is nothing to deal.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..pipeline import FrameOutputs, SemanticDepthPipeline, _scalar, _scaled_camera
from ..pipeline import resolve_frame_scalars
from . import comm
from .mesh import _mesh, _n, axis_rank, axis_size, shard_batch


def make_pp_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
                 pp: Optional[int] = None):
    """Build a (dp, pp) mesh. Defaults: pp=2 (FCN stage / monodepth+geometry
    stage), dp = n / pp. pp=3 splits monodepth and geometry apart too."""
    n = _n(n_devices)
    if pp is None:
        if dp is not None:
            pp = n // dp
        elif n % 2 == 0 and n > 1:
            pp = 2
        else:
            raise ValueError(
                f"pipeline parallelism needs an even device count to default "
                f"to pp=2 stages; got {n} device(s) — pass dp/pp explicitly "
                f"with pp in (2, 3)")
    if dp is None:
        dp = n // pp
    if dp * pp != n:
        raise ValueError(f"dp*pp = {dp}*{pp} != n_devices {n}")
    return _mesh((dp, pp), ("dp", "pp"))


class PipelinedPipeline:
    """Streams microbatches of frames through per-rank pipeline stages.

    The mesh must have a 'pp' dim of size 2 (stage 0: resize+FCN; stage 1:
    monodepth+geometry) or 3 (monodepth and geometry split), and may have a
    'dp' dim that splits each microbatch. ``process_stream`` takes (N, H0,
    W0, 3) frames, N a multiple of ``microbatch`` and ``microbatch`` a
    multiple of dp, and returns FrameOutputs with leading dim N: per
    microbatch the program of ``SemanticDepthPipeline.process_batch``,
    scheduled across ranks. Every rank calls with the same frames.

    Each call spends S - 1 of its T + S - 1 clock steps filling and draining
    (T microbatches, S stages), so stream long sequences in chunks that give
    T of 8 or more (the CLI's ``--batch``).
    """

    def __init__(self, pipeline: SemanticDepthPipeline, mesh):
        names = mesh.mesh_dim_names or ()
        if "pp" not in names:
            raise ValueError("mesh needs a 'pp' axis (make_pp_mesh)")
        self.pipeline = pipeline
        self.mesh = mesh
        self.config = pipeline.config
        self.device = pipeline.device
        self.n_stages = axis_size(mesh, "pp")
        if self.n_stages not in (2, 3):
            raise ValueError(
                f"pp={self.n_stages} unsupported: the frame program factors "
                "into 2 or 3 stages (FCN / monodepth / geometry)")
        self.dp = axis_size(mesh, "dp")
        self.stage = axis_rank(mesh, "pp")
        self._pp_group = mesh.get_group("pp")
        self._dp_group = mesh.get_group("dp") if self.dp > 1 else None

    def _run_stage(self, frames, bnd, cam, dm):
        """This rank's stage on one microbatch: (its boundary for the next
        stage, or the outputs from the last stage)."""
        pipe, s, last = self.pipeline, self.stage, self.n_stages - 1
        small, road, fence, disp = bnd
        if s == 0:
            small, road, fence = pipe._batch_segment(frames)
            return (small, road, fence, disp), None
        if s == 1:
            disp = pipe._batch_disparity(small, dm)
        if s < last:
            return (small, road, fence, disp), None
        return None, pipe._batch_geometry(small, road, fence, disp, cam)

    @torch.inference_mode()
    def process_stream(self, frames, microbatch: int, focal: Optional[float] = None,
                       disparity_mult: Optional[float] = None) -> FrameOutputs:
        frames = torch.as_tensor(frames)
        n = frames.shape[0]
        if n % microbatch != 0:
            raise ValueError(f"stream length {n} not divisible by microbatch {microbatch}")
        if microbatch % self.dp != 0:
            raise ValueError(f"microbatch {microbatch} not divisible by dp={self.dp}")
        focal, dmult = resolve_frame_scalars(self.config, frames.shape[2], focal,
                                             disparity_mult)
        cam, s_w = _scaled_camera(self.config, _scalar(focal))
        dm = _scalar(dmult) * s_w
        S, T = self.n_stages, n // microbatch
        cfg, dev = self.config, self.device
        mb = microbatch // self.dp
        h, w = cfg.input_height, cfg.input_width
        zero = (torch.zeros((mb, h, w, 3), device=dev),
                torch.zeros((mb, h, w), dtype=torch.bool, device=dev),
                torch.zeros((mb, h, w), dtype=torch.bool, device=dev),
                torch.zeros((mb, h, w), device=dev))
        bnd, outs = zero, []
        for t in range(T + S - 1):
            i = t - self.stage  # the microbatch this stage works on now
            new = zero
            if 0 <= i < T:
                chunk = None
                if self.stage == 0:
                    chunk = shard_batch(self.mesh, frames[i * microbatch:(i + 1) * microbatch])
                    chunk = chunk.to(dev)
                nxt, out = self._run_stage(chunk, bnd, cam, dm)
                if out is not None:
                    outs.append(out)
                else:
                    new = nxt
            if t < T + S - 2:  # the last step's boundaries go nowhere
                bnd = tuple(comm.handoff(new, self._pp_group))
        return self._collect(outs, T, mb)

    def _collect(self, outs, T: int, mb: int) -> FrameOutputs:
        """The last stage's outputs, on every rank, in frame order."""
        last = self.n_stages - 1
        leaves = None
        if self.stage == last:  # T microbatches of mb frames each
            leaves = [torch.cat(parts) for parts in zip(*(o.leaves() for o in outs))]
        leaves = comm.broadcast_tensors(leaves, last, self._pp_group, self.device)
        if self._dp_group is not None:
            # each dp rank holds (T, mb) of its frames: gather along dim 1,
            # then (T, mb * dp) is frame order
            leaves = comm.all_gather_tensors(
                [x.reshape((T, mb) + x.shape[1:]) for x in leaves], 1, self._dp_group)
            leaves = [x.reshape((-1,) + x.shape[2:]) for x in leaves]
        return FrameOutputs.from_leaves(leaves)

    def process_batch(self, frames, focal: Optional[float] = None,
                      disparity_mult: Optional[float] = None) -> FrameOutputs:
        """ShardedPipeline-compatible adapter (``cli.sequence --mesh pp``):
        streams the batch through the stages in the largest dp-divisible
        microbatch that still yields >= n_stages microbatches, so every
        stage is busy in steady state."""
        frames = torch.as_tensor(frames)
        n = frames.shape[0]
        dp = self.dp
        if n % dp != 0:
            raise ValueError(f"batch {n} not divisible by dp={dp}")
        mb = max(dp, (n // (self.n_stages * dp)) * dp)
        while n % mb:
            mb -= dp
        return self.process_stream(frames, mb, focal, disparity_mult)
