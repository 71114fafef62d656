"""``RowShard``: the rows of one forward split over the sp mesh axis, the
layout of each level, and the collectives that move rows between the
levels' layouts (the networks' layers that use it are in
``models/spatial.py``).

Layout rule. Every activation of one level (one height) has the same
layout, a function of the level's global height G alone
(``RowShard.split``): split when G divides by 2 * sp and a rank's block
holds at least ``MIN_ROWS`` rows (more than any halo here, 3 rows, and an
even count, so 2x2 pools and stride-2 convolutions start on their grid),
else whole on every rank. So a skip addition or concatenation always meets
its partner in the same layout. A coarse level that cannot be split runs
whole on every rank (GSPMD partitions such levels unevenly); its input is
gathered first, and the next finer level that can be split takes its own
rows back by a local slice, which needs no communication.

The global height of an NCHW activation is read from its width, which is
never sharded: every layer scales height and width alike, so G = W *
height / width of the network's input.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.spatial import like
from . import comm

MIN_ROWS = 4


@dataclasses.dataclass(frozen=True)
class RowShard:
    """Rows of one forward split over ``group`` (``size`` ranks, this one
    ``rank``); ``height`` x ``width`` is the network input's global size."""

    group: object
    rank: int
    size: int
    height: int
    width: int

    def split(self, g: int) -> bool:
        """Whether a level of global height ``g`` is split over the ranks."""
        return g % (2 * self.size) == 0 and g // self.size >= MIN_ROWS

    def rows_of(self, x: torch.Tensor, dim: int = -2, width_dim: int = -1) -> int:
        """Global height of ``x`` (rows along ``dim``, width along
        ``width_dim``)."""
        g = x.shape[width_dim] * self.height // self.width
        if x.shape[dim] not in (g, g // self.size):
            raise ValueError(f"a block of {x.shape[dim]} rows is neither the whole level "
                             f"({g} rows) nor a 1/{self.size} share of it")
        return g

    def is_split(self, x: torch.Tensor, dim: int = -2, width_dim: int = -1) -> bool:
        return x.shape[dim] != self.rows_of(x, dim, width_dim)

    def own(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """This rank's rows of a whole tensor."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def whole(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """The whole of a split tensor, on every rank, in ``x``'s layout."""
        return like(comm.all_gather_dim(x, dim, self.group), x)

    def halo(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        """This rank's block of a split NCHW level with ``top`` rows of the
        rank above and ``bottom`` of the rank below (zeros at the frame's
        edges), in ``x``'s layout."""
        return like(comm.halo_rows(x, top, bottom, self.group), x)

    def settle(self, x: torch.Tensor, dim: int = -2, width_dim: int = -1) -> torch.Tensor:
        """``x`` in the layout of its level."""
        g = self.rows_of(x, dim, width_dim)
        split = x.shape[dim] != g
        if split and not self.split(g):
            return self.whole(x, dim)
        if not split and self.split(g):
            return self.own(x, dim)
        return x
