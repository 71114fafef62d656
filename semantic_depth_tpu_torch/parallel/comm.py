"""Every collective the parallel layer uses; nothing else in the port calls
``torch.distributed`` to move data.

The JAX package needs no such module: GSPMD places its collectives from
sharding annotations, and ``lax.ppermute`` moves the pp boundary. Here
each mesh position is a process, and the data moves through these
functions, written with collectives only (all_gather and broadcast, never
send / recv), so that they run on every backend that carries two ranks on
one card. A sum over a group (``all_reduce_sum``) is an all_gather too: every
rank adds the gathered blocks in group-rank order, so every rank holds the
same bits, and replicated parameters updated from such a sum stay
bit-identical on every rank.

Tensors travel as raw bytes (``view(torch.uint8)``): the bits arrive as
they left, -0.0 and nan included, and the backend never has to support
the dtype (gloo does not gather bool, nor bfloat16 on every version). One
call packs all of its tensors into one buffer, so a FrameOutputs gather
is one collective. Under gloo a CUDA tensor goes through host memory (a
copy out, the collective on the CPU, a copy back): exact, and independent
of which collectives a gloo build takes on CUDA tensors. NCCL moves CUDA
tensors where they are.

``traffic`` counts, by kind, the calls, the bytes this rank contributed
and the seconds on the host clock around each call (staging copies
included; under NCCL the host clock sees only the enqueue).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

KINDS = ("gather", "halo", "handoff", "broadcast", "reduce")


class Traffic:
    """Calls, bytes sent and host seconds of this process's collectives, by
    kind (``KINDS``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = dict.fromkeys(KINDS, 0)
        self.bytes = dict.fromkeys(KINDS, 0)
        self.seconds = dict.fromkeys(KINDS, 0.0)

    def add(self, kind: str, n_bytes: int, seconds: float) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += n_bytes
        self.seconds[kind] += seconds

    def as_dict(self) -> dict:
        return {k: dict(calls=self.calls[k], bytes=self.bytes[k], ms=1e3 * self.seconds[k])
                for k in KINDS}


traffic = Traffic()


def _staged(group) -> bool:
    """True when CUDA tensors go through host memory for this group."""
    return dist.get_backend(group) != dist.Backend.NCCL


def _nbytes(t: torch.Tensor) -> int:
    """Bytes ``t`` takes in a packed buffer: its own, rounded up to 8 so
    that every tensor starts aligned for any dtype's view."""
    return -(-t.numel() * t.element_size() // 8) * 8


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, end to end (each padded to ``_nbytes``), as one
    flat uint8 tensor."""
    if not tensors:
        return torch.empty(0, dtype=torch.uint8)
    parts = []
    for t in tensors:
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        pad = _nbytes(t) - raw.numel()
        parts.append(torch.nn.functional.pad(raw, (0, pad)) if pad else raw)
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Inverse of ``_pack`` for tensors of the shapes and dtypes of ``like``."""
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[at:at + n].view(t.dtype).reshape(t.shape))
        at += _nbytes(t)
    return out


def _exchange(buf: torch.Tensor, group, kind: str) -> List[torch.Tensor]:
    """all_gather of equal-sized uint8 buffers: one buffer per group rank,
    in group-rank order, on ``buf``'s device."""
    t0 = time.perf_counter()
    size = dist.get_world_size(group)
    dev = buf.device
    wire = buf.cpu() if dev.type == "cuda" and _staged(group) else buf
    got = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(got, wire, group=group)
    got = [g.to(dev) for g in got]
    traffic.add(kind, buf.numel(), time.perf_counter() - t0)
    return got


def all_gather_tensors(tensors: Sequence[torch.Tensor], dim: int, group) -> List[torch.Tensor]:
    """Each tensor's rank blocks concatenated along ``dim`` in group-rank
    order; every rank passes tensors of the same shapes and dtypes."""
    bufs = _exchange(_pack(tensors), group, "gather")
    per_rank = [_unpack(b, tensors) for b in bufs]
    return [torch.cat([blocks[i] for blocks in per_rank], dim=dim)
            for i in range(len(tensors))]


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The rank blocks of ``x`` concatenated along ``dim``."""
    return all_gather_tensors([x], dim, group)[0]


def halo_rows(x: torch.Tensor, top: int, bottom: int, group, dim: int = -2) -> torch.Tensor:
    """``x`` with the last ``top`` rows (along ``dim``) of the rank above
    prepended and the first ``bottom`` rows of the rank below appended;
    zero rows stand beyond the frame's edges (rank 0's top, the last
    rank's bottom). Each rank's block must hold at least ``max(top,
    bottom)`` rows."""
    dim = dim % x.ndim
    n = x.shape[dim]
    if top > n or bottom > n:
        raise ValueError(f"halo of {top} / {bottom} rows over blocks of {n} rows")
    if top == 0 and bottom == 0:
        return x
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    # what the neighbours need of this block: its first rows (the rank
    # above's bottom halo) and its last rows (the rank below's top halo)
    first, last = x.narrow(dim, 0, bottom), x.narrow(dim, n - top, top)
    blocks = [_unpack(b, (first, last)) for b in _exchange(_pack((first, last)), group, "halo")]
    above = blocks[rank - 1][1] if rank > 0 else torch.zeros_like(last)
    below = blocks[rank + 1][0] if rank < size - 1 else torch.zeros_like(first)
    return torch.cat([above, x, below], dim=dim)


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor summed over the ranks of ``group``, the same bits on every
    rank: one all_gather of the packed tensors, then the ranks' blocks added
    in group-rank order (integers without rounding). Every rank passes
    tensors of the same shapes and dtypes. A group of one rank returns the
    tensors as they are. The gather moves world-size times the bytes, where
    a ring all_reduce moves about twice them."""
    if dist.get_world_size(group) == 1:
        return list(tensors)
    per_rank = [_unpack(b, tensors) for b in _exchange(_pack(tensors), group, "reduce")]
    sums = [t.clone() for t in per_rank[0]]
    for blocks in per_rank[1:]:
        for acc, t in zip(sums, blocks):
            acc += t
    return sums


def broadcast_tensors(tensors: Optional[Sequence[torch.Tensor]], src: int, group,
                      device=None) -> List[torch.Tensor]:
    """The tensors of group rank ``src``, on every rank of the group: the
    source passes them, the others pass None (and the ``device`` to put
    them on). Shapes and dtypes travel first, as a small object. A group of
    None is the default group."""
    t0 = time.perf_counter()
    rank = dist.get_rank(group)
    src_global = src if group is None else dist.get_global_rank(group, src)
    meta = [[(tuple(t.shape), t.dtype) for t in tensors] if rank == src else None]
    dist.broadcast_object_list(meta, src=src_global, group=group)
    like = [torch.empty(shape, dtype=dtype, device="meta") for shape, dtype in meta[0]]
    n = sum(_nbytes(t) for t in like)
    if rank == src:
        buf = _pack(tensors)
        device = buf.device
    else:
        buf = torch.empty(n, dtype=torch.uint8, device=device)
    wire = buf.cpu() if buf.device.type == "cuda" and _staged(group) else buf
    dist.broadcast(wire, src=src_global, group=group)
    buf = wire.to(device)
    traffic.add("broadcast", n if rank == src else 0, time.perf_counter() - t0)
    return _unpack(buf, like)


def broadcast(x: Optional[torch.Tensor], src: int, group, device=None) -> torch.Tensor:
    """Group rank ``src``'s tensor on every rank of the group (the others
    pass None)."""
    return broadcast_tensors(None if x is None else [x], src, group, device)[0]


def handoff(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The pp stage hand-off: every rank of the group passes tensors of the
    same shapes and gets back those of the group rank before it (rank 0
    gets zeros). One all_gather of the packed boundaries: each stage moves
    its boundary one stage on."""
    rank = dist.get_rank(group)
    bufs = _exchange(_pack(tensors), group, "handoff")
    if rank == 0:
        return [torch.zeros_like(t) for t in tensors]
    return _unpack(bufs[rank - 1], tensors)
