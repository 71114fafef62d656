"""Stand-in networks that return rendered scenes' true outputs.

Frozen copies of ``SceneFCN`` / ``SceneMono`` from the port's chip smoke
run, passed to the port through its public ``SemanticDepthPipeline(config,
fcn, mono)``. They take the place of FCN-8s and monodepth, so the
geometry tail runs on real road and fence geometry at a real occupancy.
"""

from __future__ import annotations

import torch

from .scenes import FENCE, ROAD


def _take(scenes: torch.Tensor, b: int) -> torch.Tensor:
    """The first ``b`` scenes, or the one scene ``b`` times."""
    return scenes.expand(b, *scenes.shape[1:]) if scenes.shape[0] == 1 else scenes[:b]


class SceneFCN(torch.nn.Module):
    """The scenes' class logits: +8 on the true class of road, fence and
    background; frame i of a batch gets scene i."""

    def __init__(self, labels: torch.Tensor):
        super().__init__()
        onehot = torch.stack([labels == ROAD, labels == FENCE,
                              (labels != ROAD) & (labels != FENCE)], -1)
        self.register_buffer("logits", onehot.float() * 8.0)

    def forward(self, images, rows=None):
        if rows is not None:
            raise ValueError("the stand-in networks have no row-sharded form")
        return _take(self.logits, images.shape[0])


class SceneMono(torch.nn.Module):
    """The scenes' normalised disparity; on the flip batch (the B frames,
    then their mirrors) the second half is the mirror, so the flip blend
    gives the scene's disparity back."""

    def __init__(self, disp_norm: torch.Tensor, flip: bool):
        super().__init__()
        self.register_buffer("disp", disp_norm.float())
        self.flip = flip

    def disp_left(self, images, rows=None):
        if rows is not None:
            raise ValueError("the stand-in networks have no row-sharded form")
        if not self.flip:
            return _take(self.disp, images.shape[0])
        d = _take(self.disp, images.shape[0] // 2)
        return torch.cat([d, d.flip(-1)])
