"""Monodepth self-supervised stereo training (Godard et al., CVPR'17; port of
``semantic_depth_tpu/train/monodepth_trainer.py``).

* image pyramids (4 scales, 2x area downsampling);
* appearance matching: alpha * SSIM + (1 - alpha) * L1 between each image
  and its warp from the other view;
* edge-aware disparity smoothness, scaled by 1 / 2^i at scale i;
* left-right disparity consistency.

Upstream defaults: alpha 0.85, smoothness 0.1, left-right 1.0; Adam lr 1e-4.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models import Monodepth
from ..ops.sampler import bilinear_sample_x, clip
from ..parallel import comm
from .trainer import AdamTrainer


@dataclass(frozen=True)
class MonodepthTrainConfig:
    learning_rate: float = 1e-4
    alpha_image_loss: float = 0.85
    disp_gradient_loss_weight: float = 0.1
    lr_loss_weight: float = 1.0
    num_scales: int = 4


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x area downsample of NHWC (upstream uses tf.image.resize_area)."""
    b, h, w, c = img.shape
    return img.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def image_pyramid(img: torch.Tensor, num_scales: int) -> List[torch.Tensor]:
    out = [img]
    for _ in range(num_scales - 1):
        out.append(_downsample2(out[-1]))
    return out


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Simplified SSIM with 3x3 VALID average pooling (window sum / 9), as in
    upstream monodepth. NHWC in and out."""
    c1, c2 = 0.01**2, 0.03**2

    def pool(v):
        return F.avg_pool2d(v.permute(0, 3, 1, 2), 3, stride=1).permute(0, 2, 3, 1)

    mu_x, mu_y = pool(x), pool(y)
    sigma_x = pool(x * x) - mu_x**2
    sigma_y = pool(y * y) - mu_y**2
    sigma_xy = pool(x * y) - mu_x * mu_y
    ssim_n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    ssim_d = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    # torch.div: JAX divides here; the clip splits a tie's gradient as JAX's does
    return clip((1 - torch.div(ssim_n, ssim_d)) / 2, 0.0, 1.0)


def _gradient_x(img):
    return img[:, :, :-1, :] - img[:, :, 1:, :]


def _gradient_y(img):
    return img[:, :-1, :, :] - img[:, 1:, :, :]


def disparity_smoothness(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness: |d disp| * exp(-|d I|)."""
    disp = disp[..., None]
    dx = _gradient_x(disp)
    dy = _gradient_y(disp)
    wx = torch.exp(-torch.mean(torch.abs(_gradient_x(img)), dim=3, keepdim=True))
    wy = torch.exp(-torch.mean(torch.abs(_gradient_y(img)), dim=3, keepdim=True))
    return torch.mean(torch.abs(dx * wx)) + torch.mean(torch.abs(dy * wy))


def monodepth_loss(
    disps: List[torch.Tensor],
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: MonodepthTrainConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss over the 4-scale pyramid. disps[i]: (B, H/2^i, W/2^i, 2)."""
    left_pyr = image_pyramid(left, cfg.num_scales)
    right_pyr = image_pyramid(right, cfg.num_scales)
    total_im, total_sm, total_lr = 0.0, 0.0, 0.0
    for i in range(cfg.num_scales):
        dl = disps[i][..., 0]
        dr = disps[i][..., 1]
        l_img, r_img = left_pyr[i], right_pyr[i]

        # reconstructions
        left_est = bilinear_sample_x(r_img, -dl)
        right_est = bilinear_sample_x(l_img, dr)

        # appearance matching
        l1_l = torch.mean(torch.abs(left_est - l_img))
        l1_r = torch.mean(torch.abs(right_est - r_img))
        ssim_l = torch.mean(ssim(left_est, l_img))
        ssim_r = torch.mean(ssim(right_est, r_img))
        a = cfg.alpha_image_loss
        total_im = total_im + a * (ssim_l + ssim_r) + (1 - a) * (l1_l + l1_r)

        # smoothness (upstream scales by 1/2^i)
        total_sm = total_sm + (
            disparity_smoothness(dl, l_img) + disparity_smoothness(dr, r_img)
        ) / (2**i)

        # left-right consistency: project the other view's disparity
        right_to_left_disp = bilinear_sample_x(dr[..., None], -dl)[..., 0]
        left_to_right_disp = bilinear_sample_x(dl[..., None], dr)[..., 0]
        total_lr = total_lr + torch.mean(torch.abs(right_to_left_disp - dl)) + torch.mean(
            torch.abs(left_to_right_disp - dr)
        )

    loss = (
        total_im
        + cfg.disp_gradient_loss_weight * total_sm
        + cfg.lr_loss_weight * total_lr
    )
    aux = {"image_loss": total_im, "smooth_loss": total_sm, "lr_loss": total_lr}
    return loss, aux


class MonodepthTrainer(AdamTrainer):
    """Stereo-pair trainer for the Monodepth model. ``seed`` draws the init
    when neither ``model`` nor ``init_params`` is given.

    ``mesh``: a ``DeviceMesh`` over every rank of the group, one process per
    mesh position. Each stereo batch is split over all of its ranks, in
    rank order (row-major over the mesh's dims), and the parameters and
    Adam state are replicated: the gradients are averaged over the group
    (``AdamTrainer._update``, the same bits on every rank), as the
    JAX trainer's GSPMD all-reduce does. The batch must divide by the
    mesh's rank count."""

    def __init__(
        self,
        config: MonodepthTrainConfig = MonodepthTrainConfig(),
        model: Optional[Monodepth] = None,
        init_params: Optional[Mapping[str, Any]] = None,
        seed: int = 0,
        device=None,
        mesh=None,
    ):
        self.config = config
        if model is None:
            model = Monodepth(generator=torch.Generator().manual_seed(seed))
        super().__init__(model, config.learning_rate, init_params, device, mesh)

    def train_batch(self, left, right) -> Dict[str, float]:
        left, right = self._tensor(left), self._tensor(right)
        if self.mesh is not None:  # this rank's rows of the batch
            n, r = self.mesh.size(), dist.get_rank()
            if left.shape[0] % n:
                raise ValueError(f"batch size {left.shape[0]} must be a multiple of the mesh's "
                                 f"device count {n}")
            per = left.shape[0] // n
            left, right = left[r * per:(r + 1) * per], right[r * per:(r + 1) * per]
        loss, aux = monodepth_loss(self.model(left), left, right, self.config)
        self._update(loss)
        values = [loss.detach(), *(v.detach() for v in aux.values())]
        if self.mesh is not None:  # the group's mean of each: the whole batch's
            values = [torch.div(t, t.new_tensor(float(n)))
                      for t in comm.all_reduce_sum(values, None)]
        return dict(zip(("loss", *aux), (v.item() for v in values)))
