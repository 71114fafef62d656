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

On the card one thread-block cluster of ``CLUSTER`` CTAs owns a row; its
radix select takes the digits of ``DIGIT_BITS``, most significant first
(both fixed in the kernel). Rows whose slices fit in shared memory
(``RESIDENT_SLICE`` values a CTA) stay resident there; the kernel streams
longer rows' slices from global memory.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..runtime import annotate
from . import _cuda

_MAD_SCALE = 0.6745  # pcl.py:63
_SIGN = 0x80000000
_INVALID_KEY = 1 << 32  # sorts after every ordered-uint32 key

# csrc/mad.cu's constants: the radix schedule, the CTAs of a row's cluster
# and the longest slice a CTA keeps in shared memory
DIGIT_BITS = (11, 11, 10)
CLUSTER = 8
RESIDENT_SLICE = 32768
GROUP = 32  # bins per group of the two-level digit search
VECTOR = 4  # values a vector load; the kernel's row length is a multiple
MAX_ROWS = 65535  # rows a launch (the grid's y extent)


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
    """Plain PyTorch version: sorts where the kernel selects by radix.
    ``thresholds`` is an (R,) float32 tensor."""
    n = valid.sum(-1, dtype=torch.int64)
    med = _median_rows(values, valid, n)
    diffs = (values - med[:, None]).abs()
    mad = _median_rows(diffs, valid, n)
    scale = torch.tensor(_MAD_SCALE, dtype=torch.float32, device=values.device)
    penalty = scale * diffs / mad[:, None]
    # nan/inf penalties compare False, matching np.where(penalty < thr)
    return valid & (penalty < thresholds[:, None])


def threshold_rows(thresholds, rows: int, device) -> torch.Tensor:
    """The (R,) float32 thresholds that ``mad_keep_mask`` applies: a tensor
    as it is; one float for every row; a pair (a, b) for the first and the
    second half of the rows."""
    if isinstance(thresholds, torch.Tensor):
        return thresholds
    t0, t1, split = _by_value(thresholds, rows)
    return torch.tensor([t0] * split + [t1] * (rows - split), dtype=torch.float32, device=device)


def _by_value(thresholds, rows: int):
    """(t0, t1, split): t0 on the rows before ``split``, t1 on the rest."""
    if isinstance(thresholds, (tuple, list)):
        if len(thresholds) != 2 or rows % 2:
            raise ValueError("a threshold pair needs an even row count (two equal halves), "
                             f"got {len(thresholds)} thresholds for {rows} rows")
        return float(thresholds[0]), float(thresholds[1]), rows // 2
    t = float(thresholds)
    return t, t, rows


def _op_args(thresholds, rows: int):
    """``mad_keep_mask``'s thresholds as the op's (tensor or None, t0, t1,
    split)."""
    if isinstance(thresholds, torch.Tensor):
        return thresholds, 0.0, 0.0, rows
    return (None, *_by_value(thresholds, rows))


def _kernel(values, valid, thresholds, t0, t1, split, out) -> None:
    """The kernel on checked values and valid: the (R,) ``thresholds``, or
    None and the floats by value."""
    r, n = values.shape
    ptr = None
    if thresholds is not None:
        _cuda.require(thresholds, "thresholds", torch.float32, (r,))
        if thresholds.device != values.device:
            raise ValueError("values and thresholds must be on one device")
        ptr = thresholds.data_ptr()
    err = _cuda.library().sd_mad_keep(
        values.data_ptr(), valid.data_ptr(), ptr, t0, t1, split, out.data_ptr(), r, n,
        _cuda.stream_ptr(values),
    )
    _cuda.check(err, "mad_keep_mask")


def _launch(values, valid, thresholds, out) -> None:
    """The kernel on checked tensors, ``thresholds`` as ``mad_keep_mask``
    takes them (no count: the measurement tools' direct launch)."""
    _kernel(values, valid, *_op_args(thresholds, values.shape[0]), out)


@torch.library.custom_op(f"{_cuda.NAMESPACE}::mad_keep", mutates_args=(), device_types="cpu")
def _mad_op(values: torch.Tensor, valid: torch.Tensor, thresholds: Optional[torch.Tensor],
            t0: float, t1: float, split: int) -> torch.Tensor:
    """The dispatcher op: ``thresholds`` (R,), or None and ``t0`` on the rows
    before ``split``, ``t1`` on the rest. On the CPU, the plain version."""
    if thresholds is None:
        r = values.shape[0]
        thresholds = torch.tensor([t0] * split + [t1] * (r - split), dtype=torch.float32)
    return mad_keep_mask_plain(values, valid, thresholds)


@_mad_op.register_fake
def _(values, valid, thresholds, t0, t1, split):
    return values.new_empty(values.shape, dtype=torch.bool)


def kernel_layout(values: torch.Tensor, valid: torch.Tensor):
    """(values, valid) as the kernel takes them: rows whose length is a
    multiple of ``VECTOR`` (at least one vector), contiguous, values 16-byte
    and valid 4-byte aligned for the vector loads. The inputs themselves
    where they already are (no copy: the road chain's planes); else fresh
    copies whose padded entries are invalid. An invalid entry enters no
    median and is never kept, so the first N columns' mask is that of the
    unpadded rows."""
    r, n = values.shape
    npad = max(VECTOR, -(-n // VECTOR) * VECTOR)
    if (npad == n and values.is_contiguous() and valid.is_contiguous()
            and values.data_ptr() % 16 == 0 and valid.data_ptr() % 4 == 0):
        return values, valid
    values_k = values.new_zeros((r, npad))
    valid_k = valid.new_zeros((r, npad))
    values_k[:, :n] = values
    valid_k[:, :n] = valid
    return values_k, valid_k


@_mad_op.register_kernel("cuda")
def _(values, valid, thresholds, t0, t1, split):
    """The kernel (one cluster per row), or raise. Rows off the kernel's
    layout are padded (see ``kernel_layout``) and the mask sliced back; the
    rows go in chunks of at most ``MAX_ROWS``, one launch each (rows are
    independent, so a chunk's mask is the same)."""
    if values.ndim != 2:
        raise ValueError(f"values must be (R, N), got {tuple(values.shape)}")
    r, n = values.shape
    if tuple(valid.shape) != (r, n):
        raise ValueError(f"valid must have shape {(r, n)}, got {tuple(valid.shape)}")
    if values.device != valid.device:
        raise ValueError("values and valid must be on one device")
    values_k, valid_k = kernel_layout(values, valid)
    _cuda.require(values_k, "values", torch.float32)
    _cuda.require(valid_k, "valid", torch.bool)
    out = torch.empty(values_k.shape, dtype=torch.bool, device=values.device)
    if r * n == 0:
        return out[:, :n]
    for r0, _ in _cuda.launch_chunks(r, MAX_ROWS, "mad"):
        rows = slice(r0, r0 + MAX_ROWS)  # past the end: a tensor of thresholds too long fails
        thr = None if thresholds is None else thresholds[rows]
        _kernel(values_k[rows], valid_k[rows], thr, t0, t1,
                min(max(split - r0, 0), MAX_ROWS), out[rows])
    return out if out.shape[1] == n else out[:, :n].contiguous()


def mad_keep_mask(values: torch.Tensor, valid: torch.Tensor, thresholds) -> torch.Tensor:
    """values (R, N) float32, valid (R, N) bool -> (R, N) bool keep mask,
    through the op ``sd_torch::mad_keep``. ``thresholds``: one float for
    every row, a pair (a, b) for the first and the second half of the rows
    (the fence pair), or an (R,) float32 tensor; the floats go to the kernel
    by value, with no copy to the card. CPU tensors take the plain version;
    CUDA tensors launch the kernel (one cluster per row; one launch per
    ``MAX_ROWS`` rows, counted in ``_cuda.launches``) at any R and N, or
    raise on a wrong rank or dtype or a threshold pair over odd halves."""
    with annotate("sd.k2", values.is_cuda):
        return _mad_op(values, valid, *_op_args(thresholds, values.shape[0]))
