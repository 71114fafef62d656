"""Process groups and meshes (port of ``semantic_depth_tpu/parallel/mesh.py``).

JAX builds a mesh over the devices of one process. PyTorch runs one
process per mesh position: ``init_distributed`` joins this process to its
group (torchrun's environment, or the arguments ``launch.run_ranks``
passes), and the mesh builders return a ``DeviceMesh`` over the group's
ranks, rank r at row-major position r, as ``np.reshape`` lays out JAX's
devices. A mesh spans every rank of the group.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..runtime import resolve_device

_TORCHRUN_HINT = ("launch one process per mesh position with torchrun, e.g. "
                  "`torchrun --nproc_per_node N -m semantic_depth_tpu_torch.cli.sequence ...`")


def init_distributed(device=None, rank: Optional[int] = None, world_size: Optional[int] = None,
                     store=None, timeout_s: float = 600.0) -> torch.device:
    """Join this process to its group and return its device.

    ``device`` None is the card (raises without one, as ``resolve_device``
    does); ``"cpu"`` runs the rank on the CPU. Rank, world size and the
    local rank come from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) unless ``rank``,
    ``world_size`` and a ``store`` are given. A CUDA rank runs on
    ``cuda:LOCAL_RANK % device_count()``. The backend is NCCL when every
    rank of the host has a card of its own, and gloo when ranks share a card
    or run on the CPU. Rank 0 prints one line with the backend, the world
    size and whether ranks share a card. A process already in a group
    keeps it."""
    dev = resolve_device(device)
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    elif rank is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(f"no process group: {_TORCHRUN_HINT}")
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    shared = False
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        shared = local_world > n_cards
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    kw = dict(store=store) if store is not None else dict(init_method="env://")
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    if rank == 0:
        print(f"torch.distributed: backend {backend}, world size {world_size}, "
              f"ranks share a card: {shared}", flush=True)
    return dev


def _mesh(shape, names) -> DeviceMesh:
    """A DeviceMesh of the group's ranks in row-major order. Its device type
    follows the backend (CUDA for NCCL, CPU for gloo); the tensors' own
    devices are the ranks' (``init_distributed``)."""
    world = dist.get_world_size()
    n = shape[0] * shape[1]
    if n != world:
        raise ValueError(f"a mesh of {n} ranks over a group of {world}: run one process "
                         "per mesh position")
    device_type = "cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def _n(n_devices: Optional[int]) -> int:
    if n_devices:
        return n_devices
    if not dist.is_initialized():
        raise RuntimeError(f"no process group: {_TORCHRUN_HINT}")
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None) -> DeviceMesh:
    """Build a (dp, tp) mesh. Defaults: tp = 2 when the rank count is even
    and > 1 else 1; dp = n / tp. Dims 'dp', 'tp'."""
    n = _n(n_devices)
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != n_devices {n}")
    return _mesh((dp, tp), ("dp", "tp"))


def make_spatial_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
                      sp: Optional[int] = None) -> DeviceMesh:
    """Build a (dp, sp) mesh for latency-oriented serving: 'sp' shards the
    image ROW axis of a frame, 'dp' the frame batch. Defaults to all ranks
    spatial (dp=1), the single-frame-latency configuration."""
    n = _n(n_devices)
    if sp is None:
        sp = n if dp is None else n // dp
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != n_devices {n}")
    return _mesh((dp, sp), ("dp", "sp"))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of ``mesh``'s dim ``name``; 1 when it has none."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def axis_rank(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate along dim ``name``; 0 when it has none."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(name) if name in names else 0


def shard_batch(mesh: DeviceMesh, batch: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """This rank's slice of a batch along the leading dim, split over
    ``axis`` (replicated over the other dims). The leading dim must divide
    by the axis's size."""
    n, parts = batch.shape[0], axis_size(mesh, axis)
    if n % parts:
        raise ValueError(f"batch {n} not divisible by {axis}={parts}")
    per, i = n // parts, axis_rank(mesh, axis)
    return batch[i * per:(i + 1) * per]
