"""Image resize as two separable interpolation matrix products.

Port of ``semantic_depth_tpu/ops/resize.py``. A fixed (src -> dst) resize is
a linear map: the host builds W_rows (dst_h, src_h) and W_cols (dst_w,
src_w) once per shape pair (OpenCV INTER_CUBIC, A = -0.75, half-pixel
mapping, replicated border) and the device evaluates

    out[b, i, j, c] = sum_{k, l} W_rows[i, k] * img[b, k, l, c] * W_cols[j, l]

as two float32 ``torch.matmul`` calls (full float32: ``runtime.set_full_fp32``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_CUBIC_A = -0.75  # OpenCV INTER_CUBIC coefficient


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """Cubic convolution kernel value at |t| (vectorized), A = -0.75."""
    a = _CUBIC_A
    t = np.abs(t)
    return np.where(
        t <= 1.0,
        (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0,
        np.where(t < 2.0, a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a, 0.0),
    )


@lru_cache(maxsize=64)
def _interp_matrix(src: int, dst: int, method: str) -> np.ndarray:
    """Dense (dst, src) interpolation matrix for one axis."""
    scale = src / dst
    x = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    base = np.floor(x).astype(np.int64)
    frac = x - base
    mat = np.zeros((dst, src), dtype=np.float32)
    if method == "cubic":
        taps = range(-1, 3)
        weights = [_cubic_weights(frac - t) for t in taps]
    elif method == "linear":
        taps = range(0, 2)
        weights = [1.0 - frac, frac]
    elif method == "nearest":
        # OpenCV INTER_NEAREST uses floor(dst * scale) without the half-pixel
        # shift; reproduce that.
        idx = np.clip(np.floor(np.arange(dst) * scale).astype(np.int64), 0, src - 1)
        mat[np.arange(dst), idx] = 1.0
        return mat
    else:
        raise ValueError(f"unknown resize method: {method}")
    for t, w in zip(taps, weights):
        idx = np.clip(base + t, 0, src - 1)  # BORDER_REPLICATE
        np.add.at(mat, (np.arange(dst), idx), w.astype(np.float32))
    return mat


def resize(img: torch.Tensor, out_hw, method: str = "cubic") -> torch.Tensor:
    """Resize (..., H, W, C) images to ``out_hw`` = (H', W') in float32.

    Leading dimensions are a batch. The caller clips and casts."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    src_h, src_w, c = img.shape[-3:]
    lead = img.shape[:-3]
    x = img.float()
    if (out_h, out_w) == (src_h, src_w) and method in ("cubic", "linear"):
        # Scale 1 under the half-pixel mapping lands exactly on source
        # pixels: the matrices are identity, so skip the products.
        return x
    wr = torch.from_numpy(_interp_matrix(src_h, out_h, method)).to(x.device)
    wc = torch.from_numpy(_interp_matrix(src_w, out_w, method)).to(x.device)
    x = x.reshape((-1, src_h, src_w * c))
    # rows: (out_h, src_h) @ (src_h, src_w * C)
    x = torch.matmul(wr, x)
    # cols: (out_h * C, src_w) @ (src_w, out_w)
    x = x.reshape(-1, out_h, src_w, c).transpose(2, 3).reshape(-1, out_h * c, src_w)
    x = torch.matmul(x, wc.T)
    x = x.reshape(-1, out_h, c, out_w).transpose(2, 3)
    return x.reshape(lead + (out_h, out_w, c))


def resize_clip_u8(img: torch.Tensor, out_hw, method: str = "cubic") -> torch.Tensor:
    """Resize and round/clip back to the uint8 range (kept as float32),
    matching what cv2.resize does to uint8 frames. ``torch.round`` rounds
    half to even, like ``jnp.round``."""
    return torch.clamp(torch.round(resize(img, out_hw, method)), 0.0, 255.0)
