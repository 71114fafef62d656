"""The SemanticDepth frame program in plain PyTorch: the networks' stage
(resize, FCN-8s masks, monodepth with the flip blend, the disparity scale),
the geometry tail, and the measuring depth's calibration.

It reads the benchmark's own inputs (frames, weights or rendered scenes,
the configuration's dict) and, to judge the program's geometry tail, the
program's masks and disparities. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import geometry, nets
from .precision import FLOAT32, Precision, full_float32


class NoRoad(RuntimeError):
    """The reference finds no road to measure on these frames: the seed's
    frames and weights leave no denoised road point, or none in the width's
    slab."""


def camera(cfg: dict, focal: float):
    return geometry.scaled_camera(cfg["camera"], focal, cfg["input_height"], cfg["input_width"])


def disparity_scale(cfg: dict, mult: float) -> torch.Tensor:
    """The multiplier at the working width, float32 as the program scales it."""
    return torch.tensor(float(mult), dtype=torch.float32) * (cfg["input_width"] / geometry.REF_W)


def references(cfg: dict):
    """(fcn, mono): the reference networks of the encoders that the
    configuration names (``nets.network``)."""
    net = cfg["networks"]
    return (nets.network("fcn", net["fcn8s"]["encoder"]),
            nets.network("mono", net["monodepth"]["encoder"]))


def networks(frames: torch.Tensor, cfg: dict, mult: float, weights: Optional[Dict] = None,
             scenes: Optional[Dict] = None, prec: Precision = FLOAT32, chunk: int = 2) -> Dict:
    """(B, H0, W0, 3) uint8 frames -> small frames, FCN-8s class logits,
    (road, fence) masks and the scaled disparity, ``chunk`` frames at a time. ``weights`` (fcn,
    mono) for the networks, or ``scenes`` (``labels``, ``disp_norm`` of the
    frames' scenes) for the stand-ins' true outputs."""
    h, w = cfg["input_height"], cfg["input_width"]
    net = cfg["networks"]
    thr = cfg["segmenter"]["threshold"]
    scale = disparity_scale(cfg, mult).to(frames.device)
    fcn, mono = references(cfg)
    fcn_arg = nets.forward_arg(fcn, net["fcn8s"])
    mono_arg = nets.forward_arg(mono, net["monodepth"])
    parts = []
    with full_float32():
        for f0 in range(0, frames.shape[0], chunk):
            small = geometry.resize_u8(frames[f0:f0 + chunk], (h, w), prec)
            if scenes is None:
                logits = fcn.logits(weights["fcn"], small, fcn_arg, prec)
                norm = small / small.new_tensor(255.0)
                disp = mono.disparity(weights["mono"], norm, mono_arg, prec)
                if net["monodepth"]["flip_average"]:
                    flipped = mono.disparity(weights["mono"], norm.flip(2), mono_arg, prec)
                    disp = nets.flip_blend(disp, flipped)
            else:
                labels = scenes["labels"][f0:f0 + chunk]
                logits = torch.stack([labels == 7, labels == 13,
                                      (labels != 7) & (labels != 13)], -1).float() * 8.0
                disp = scenes["disp_norm"][f0:f0 + chunk].float()
                if net["monodepth"]["flip_average"]:
                    disp = nets.flip_blend(disp, disp.flip(-1))
            probs = torch.softmax(logits, -1)
            parts.append(dict(small=small, logits=logits.float(), road_mask=probs[..., 0] > thr,
                              fence_mask=probs[..., 1] > thr, disparity=disp * scale))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def overlay(small, road_mask, fence_mask, cfg) -> torch.Tensor:
    seg = cfg["segmenter"]
    return geometry.overlay(small, road_mask, fence_mask, seg["road_rgba"], seg["fence_rgba"])


def tail(disparity, road_mask, fence_mask, cfg: dict, focal: float, depth: float,
         prec: Precision = FLOAT32) -> Dict:
    """The geometry tail on given (B, H, W) disparities and masks, the batch
    at once as the program runs it (a reduction's order can depend on the
    tensor's shape)."""
    with full_float32():
        return geometry.tail(disparity, (road_mask, fence_mask), camera(cfg, focal), cfg, depth,
                             prec)


def program(frames: torch.Tensor, cfg: dict, focal: float, mult: float, depth: float,
            weights=None, scenes=None, prec: Precision = FLOAT32) -> Dict:
    """The whole frame program: what the port's ``process_batch`` returns
    that the benchmark compares (the control runs this at ``CONTROL``)."""
    net = networks(frames, cfg, mult, weights, scenes, prec)
    out = tail(net["disparity"], net["road_mask"], net["fence_mask"], cfg, focal, depth, prec)
    out.update(net)
    out["overlay"] = overlay(net["small"], net["road_mask"], net["fence_mask"], cfg)
    return out


def calibrated_depth(frames: torch.Tensor, cfg: dict, focal: float, mult: float,
                     weights=None, scenes=None) -> float:
    """The measuring depth at which the denoised road cloud's median point
    lies: the road chain at the configuration's depth on ``frames``, then
    minus the median z of every kept point, plus the road-width offset."""
    out = program(frames, cfg, focal, mult, cfg["depth"], weights, scenes)
    z = out["packed_xyz"][..., 2][out["keep"]]
    if z.numel() == 0:
        raise NoRoad("the calibration batch leaves no denoised road point")
    return -float(z.median()) + cfg["rw_depth_offset"]
