"""The MAD keep mask: hand-written CUDA kernel (``csrc/mad.cu``) and its plain
PyTorch version.

Replaces ``semantic_depth_tpu/ops/pallas_mad.py::mad_keep_mask_pallas``
(``_mad_kernel``). For each row of an (R, N) value plane:

    med  = numpy median of the valid values
    mad  = numpy median of |x - med| over the valid values
    keep = valid & (0.6745 * |x - med| / mad < threshold[row])

The medians are exact order statistics in the IEEE total order of the
ordered-uint32 map (+-inf and nan included, nan above +inf), so kernel and
plain version give bit-equal masks. An empty row keeps nothing.
"""

from __future__ import annotations

import torch

from . import _cuda

_MAD_SCALE = 0.6745  # pcl.py:63
_SIGN = 0x80000000
_INVALID_KEY = 1 << 32  # sorts after every ordered-uint32 key


def _ordered_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32): integer order == IEEE total order."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits >= _SIGN, bits ^ 0xFFFFFFFF, bits | _SIGN)


def _from_key(u: torch.Tensor) -> torch.Tensor:
    bits = torch.where(u < _SIGN, u ^ 0xFFFFFFFF, u & 0x7FFFFFFF)
    bits = torch.where(bits >= _SIGN, bits - (1 << 32), bits)  # two's complement
    return bits.to(torch.int32).view(torch.float32)


def _median_rows(values: torch.Tensor, valid: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(R, N) -> (R,) exact median (mean of the order statistics (n-1)//2
    and n//2 in the ordered-uint32 order), nan where n == 0."""
    keys = torch.where(valid, _ordered_key(values), _INVALID_KEY)
    srt = torch.sort(keys, dim=-1).values
    cap = values.shape[-1] - 1
    k1 = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, cap)
    k2 = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, cap)
    lo = _from_key(srt.gather(-1, k1[:, None])[:, 0])
    hi = _from_key(srt.gather(-1, k2[:, None])[:, 0])
    return torch.where(n > 0, 0.5 * (lo + hi), float("nan"))


def mad_keep_mask_plain(
    values: torch.Tensor, valid: torch.Tensor, thresholds: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: sorts where the kernel selects by radix."""
    n = valid.sum(-1, dtype=torch.int64)
    med = _median_rows(values, valid, n)
    diffs = (values - med[:, None]).abs()
    mad = _median_rows(diffs, valid, n)
    scale = torch.tensor(_MAD_SCALE, dtype=torch.float32, device=values.device)
    penalty = scale * diffs / mad[:, None]
    # nan/inf penalties compare False, matching np.where(penalty < thr)
    return valid & (penalty < thresholds[:, None])


def mad_keep_mask(
    values: torch.Tensor, valid: torch.Tensor, thresholds: torch.Tensor
) -> torch.Tensor:
    """values (R, N) float32, valid (R, N) bool, thresholds (R,) float32 ->
    (R, N) bool keep mask. CPU tensors take the plain version; CUDA tensors
    launch the kernel (one block per row) or raise."""
    if values.device.type == "cpu":
        return mad_keep_mask_plain(values, valid, thresholds)
    if values.ndim != 2:
        raise ValueError(f"values must be (R, N), got {tuple(values.shape)}")
    r, n = values.shape
    if n % 4:
        raise ValueError(f"N={n} must be a multiple of 4 (vector loads)")
    _cuda.require(values, "values", torch.float32)
    _cuda.require(valid, "valid", torch.bool, (r, n))
    _cuda.require(thresholds, "thresholds", torch.float32, (r,))
    if values.device != valid.device or values.device != thresholds.device:
        raise ValueError("values, valid and thresholds must be on one device")
    if values.data_ptr() % 16 or valid.data_ptr() % 4:
        raise ValueError("values must be 16-byte and valid 4-byte aligned (vector loads)")
    out = torch.empty((r, n), dtype=torch.bool, device=values.device)
    if out.numel() == 0:
        return out
    lib = _cuda.library()
    err = lib.sd_mad_keep(
        values.data_ptr(), valid.data_ptr(), thresholds.data_ptr(), out.data_ptr(),
        r, n, _cuda.stream_ptr(values),
    )
    _cuda.check(err, "mad_keep_mask")
    mad_keep_mask.launches += 1
    return out


mad_keep_mask.launches = 0
