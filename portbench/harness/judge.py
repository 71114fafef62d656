"""``correct``: the program's outputs of the window's kept calls held against
the plain reference.

Six numbers, each over every kept call's frames; a cell compares those
that ``limits/<cell>.json`` gives a limit (a number that no control moves
in a cell has none there, such as the overlay where no resize runs):

* ``disp_gap``: the largest relative gap of the disparity from the
  reference networks' on the same frames (monodepth and the flip blend);
* ``fcn_gap``: FCN-8s's own class logits, as the timed path's network
  returned them, against the reference network's on the same frames: per
  frame and class the norm of the gap over the norm of the reference's
  logits, the largest of them, over the fence and background classes. The
  road class carries the calibration's +2, at which bfloat16 keeps steps
  of 1/64, as wide as the road logits' spread over a frame: its gap is the
  output's rounding. Every layer but the last one's road filters is shared
  by all three classes;
* ``overlay_diff``: the percentage of overlay values that differ from the
  reference's overlay (its resize, its networks' masks, its paste);
* ``tail_gap``: the geometry tail judged on the program's own masks and
  disparity, which the reference tail reads to judge it, by measures that
  are continuous in the points: per frame the largest gap of a plane
  coefficient (road, and the fences') over the coefficient's size or 1,
  whichever is larger, and the relative gap of ``dist_f2f`` where the
  fence chain runs on real points;
* ``keep_gap``: the denoised road cloud judged the same way, as a set, so
  that a point at a threshold that goes the other way (as it may where a
  sound program sums in another order) moves it by one point in the
  cloud's size: per frame the larger of the relative gap of the number of
  kept points and the gap of their centroid over their spread about it;
* ``rw_gap``: ``dist_rw`` against the road width that the reference
  measures on the program's own denoised cloud (its packed points and
  keep bits): the same arithmetic, so an exact comparison. The cloud that
  it starts from is judged by ``keep_gap``.

nan against nan is no gap; nan against a number is an infinite one.

Where the stand-in networks serve rendered scenes, ``rw_truth_m`` and
``f2f_truth_m`` (the largest gap from the analytic widths) are reported
beside them; no control moves them, so they set no limit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from ..reference import frame as ref_frame
from ..reference import geometry

NUMBERS = ("disp_gap", "fcn_gap", "overlay_diff", "tail_gap", "keep_gap", "rw_gap")


def outputs(out, logits: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The compared fields of a port ``FrameOutputs``, with a batch axis, and
    the FCN-8s logits of the same call where the network's output was kept."""
    fields = dict(disparity=out.disparity, road_mask=out.road_mask, fence_mask=out.fence_mask,
                  overlay=out.overlay_small, keep=out.road_cloud.valid,
                  packed_xyz=out.road_cloud.xyz, road_plane=out.road_plane,
                  dist_rw=out.dist_rw, dist_f2f=out.dist_f2f,
                  fence_left_plane=out.fence_left_plane, fence_right_plane=out.fence_right_plane)
    if out.dist_rw.dim() == 0:
        fields = {k: v[None] for k, v in fields.items()}
    if logits is not None:
        fields["logits"] = logits
    return fields


def gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| with nan-nan 0 and nan-number inf."""
    na, nb = torch.isnan(a), torch.isnan(b)
    d = (a.double() - b.double()).abs()
    return torch.where(na & nb, 0.0, torch.where(na | nb, math.inf, d))


def _rel(a, b, floor=1e-12):
    return gap(a, b) / b.double().abs().clamp(min=floor)


def logit_gaps(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) logits -> (B, C - 1): |prog - ref| / |ref| over the
    pixels, of every class but the calibrated road class (channel 0)."""
    p, r = prog[..., 1:].double().flatten(1, 2), ref[..., 1:].double().flatten(1, 2)
    return (p - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)


def _cloud(xyz, keep):
    """Per frame: the number of kept points, their centroid and their RMS
    distance from it."""
    k = keep.double()
    n = k.sum(-1)
    c = (xyz.double() * k[..., None]).sum(1) / n.clamp(min=1)[:, None]
    spread = (((xyz.double() - c[:, None]) ** 2).sum(-1) * k).sum(-1) / n.clamp(min=1)
    return n, c, spread.sqrt()


def tail_gaps(prog: Dict, ref: Dict, fences: bool) -> torch.Tensor:
    """Per frame: the planes' and ``dist_f2f``'s largest gap."""
    parts = [_rel(prog["road_plane"], ref["road_plane"], 1.0).amax(-1)]
    if fences:
        parts += [_rel(prog["dist_f2f"], ref["dist_f2f"]),
                  _rel(prog["fence_left_plane"], ref["fence_left_plane"], 1.0).amax(-1),
                  _rel(prog["fence_right_plane"], ref["fence_right_plane"], 1.0).amax(-1)]
    return torch.stack(parts, -1).amax(-1)


def keep_gaps(prog: Dict, ref: Dict) -> torch.Tensor:
    """Per frame: the kept cloud's count and centroid gaps, the larger."""
    n_p, c_p, _ = _cloud(prog["packed_xyz"], prog["keep"])
    n_r, c_r, s_r = _cloud(ref["packed_xyz"], ref["keep"])
    return torch.maximum((n_p - n_r).abs() / n_r.clamp(min=1),
                         (c_p - c_r).norm(dim=-1) / s_r.clamp(min=1e-12))


def rw_gaps(prog: Dict, cfg: Dict, depth: float) -> torch.Tensor:
    """Per frame: the relative gap of the program's ``dist_rw`` from the
    width of its own denoised cloud."""
    _, _, _, width = geometry.road_width(prog["packed_xyz"].float(), prog["keep"], depth, cfg)
    return _rel(prog["dist_rw"], width)


def compare(bench, samples: List) -> Dict[str, float]:
    """The numbers over ``samples`` [(call index, compared fields)]."""
    c = bench.cell.config
    fences = bench.scenes is not None and c["approach"] == "both"
    disp, fcn, diff_n, total_n, tail, keep, rw = 0.0, None, 0, 0, 0.0, 0.0, 0.0
    rw_truth = f2f_truth = 0.0
    for i, prog in samples:
        sl = bench.positions(i)
        net = ref_frame.networks(bench.frames_dev[sl], c, bench.mult, bench.weights,
                                 bench.scenes_of(sl))
        disp = max(disp, float(_rel(prog["disparity"], net["disparity"]).max()))
        if "logits" in prog:
            fcn = max(fcn or 0.0, float(logit_gaps(prog["logits"], net["logits"]).max()))
        ov = ref_frame.overlay(net["small"], net["road_mask"], net["fence_mask"], c)
        diff_n += int((prog["overlay"] != ov).sum())
        total_n += ov.numel()
        del net, ov
        ref = ref_frame.tail(prog["disparity"], prog["road_mask"], prog["fence_mask"], c,
                             bench.focal, bench.depth)
        tail = max(tail, float(tail_gaps(prog, ref, fences).max()))
        keep = max(keep, float(keep_gaps(prog, ref).max()))
        rw = max(rw, float(rw_gaps(prog, c, bench.depth).max()))
        if bench.scenes is not None:
            idx = range(sl.start, sl.stop)
            rw_true = torch.tensor([bench.scenes["rw"][j] for j in idx], dtype=torch.float64)
            f2f_true = torch.tensor([bench.scenes["f2f"][j] for j in idx], dtype=torch.float64)
            rw_truth = max(rw_truth, float(gap(prog["dist_rw"].cpu(), rw_true).max()))
            if fences:
                f2f_truth = max(f2f_truth, float(gap(prog["dist_f2f"].cpu(), f2f_true).max()))
    out = dict(disp_gap=disp, overlay_diff=100.0 * diff_n / max(total_n, 1), tail_gap=tail,
               keep_gap=keep, rw_gap=rw)
    if fcn is not None:
        out["fcn_gap"] = fcn
    if bench.scenes is not None:
        out.update(rw_truth_m=rw_truth, f2f_truth_m=f2f_truth)
    return out


def control_samples(bench, calls: List[int], prec) -> List:
    """The reference at ``prec`` in the program's place, on the inputs of
    ``calls``."""
    c = bench.cell.config
    out = []
    for i in calls:
        sl = bench.positions(i)
        r = ref_frame.program(bench.frames_dev[sl], c, bench.focal, bench.mult, bench.depth,
                              bench.weights, bench.scenes_of(sl), prec)
        fields = dict(disparity=r["disparity"], road_mask=r["road_mask"],
                      fence_mask=r["fence_mask"], overlay=r["overlay"], keep=r["keep"],
                      packed_xyz=r["packed_xyz"], road_plane=r["road_plane"],
                      dist_rw=r["dist_rw"], dist_f2f=r.get("dist_f2f"),
                      fence_left_plane=r.get("fence_left_plane"),
                      fence_right_plane=r.get("fence_right_plane"))
        if bench.weights is not None:
            fields["logits"] = r["logits"]
        out.append((i, fields))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) over the numbers the cell's limits
    name (a number that no control moves in a cell has no limit there); a
    cell without limits is never correct, nor one missing a limited number."""
    rows = [(n, numbers.get(n, math.nan), limits[n]) for n in NUMBERS if n in limits]
    ok = bool(rows) and all(v <= lim for _, v, lim in rows)  # a nan value compares False
    return ok, rows


# --- planted faults (the readings tool and the tests) -----------------------
# Each breaks the timed path of a set-up bench underneath.

def _through(bench, fault) -> None:
    """Every ``process_batch`` answer (``process_frame`` calls it too) goes
    through ``fault``."""
    timed = bench.pipe.process_batch
    bench.pipe.process_batch = lambda *a, **k: fault(timed(*a, **k))


def half_batch(bench) -> None:
    """The second half of the batch carries the first half's answers."""
    def fault(out):
        h = out.dist_rw.shape[0] // 2
        return out.map(lambda v: torch.cat([v[:h], v[:h], v[2 * h:]]))
    _through(bench, fault)


def altered(bench) -> None:
    """The first frame's road width altered by 1% where it is produced."""
    def fault(out):
        scale = torch.ones_like(out.dist_rw)
        scale[0] = 1.01
        return out.replace(dist_rw=out.dist_rw * scale)
    _through(bench, fault)


def dropped_layer(bench) -> None:
    """FCN-8s's ``conv3_3`` dropped from the program's network: its filters
    made the identity, so the block passes ``conv3_2``'s output on."""
    conv = bench.pipe.fcn.conv3_3
    with torch.no_grad():
        conv.weight.zero_()
        conv.bias.zero_()
        k = conv.weight.shape[-1] // 2
        conv.weight[:, :, k, k] = torch.eye(conv.weight.shape[0], dtype=conv.weight.dtype)


FAULTS = {"half_batch": half_batch, "altered": altered, "dropped_layer": dropped_layer}


def fault_applies(name: str, traffic: Dict) -> bool:
    """Whether a cell of this traffic can have the fault: no half of a
    one-frame call, no FCN-8s behind the stand-in networks."""
    if name == "half_batch":
        return int(traffic["batch"]) >= 2
    if name == "dropped_layer":
        return traffic["networks"] == "seeded"
    return True
