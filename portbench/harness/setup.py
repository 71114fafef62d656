"""A cell's set-up: the kernels, the weights and the frame pool from the
seed, the port's pipeline, the calibration and the warm-up.

Each step's seconds go into ``Bench.setup_parts``; the calibration is the
reference's work, and ``setup_s`` leaves it out. The weights and the
frames are made on the device from ``torch.Generator(device)`` seeded with
the run's seed; the frames then go to the host once, as the numpy arrays
that a camera loop hands the program, or stay on the device where the
traffic's ``frames`` says so.

A draw of frames and weights can leave nothing to measure: seeded weights
can give a road of nearly one depth, and the program's bfloat16 disparity
then puts it on a few depth levels, none of which may lie in the width's
slab (native, about one seed in sixteen). Where the reference, on the
program's own masks and disparity, finds no road width either, set-up
draws the frames and weights again from the same generator, so the seed
still fixes the inputs, and a seed whose first draw serves keeps it, as
before. Where the reference finds one, the program is at fault and set-up
fails.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import frame as ref_frame
from ..reference import nets
from . import judge
from . import scenes as scene_lib
from . import weights as weight_lib
from .cell import Cell, port_config
from .standins import SceneFCN, SceneMono


@dataclasses.dataclass
class Bench:
    cell: Cell
    device: torch.device
    pipe: object  # the port's SemanticDepthPipeline
    batches: List  # the pool cut into the calls' inputs (numpy, or device tensors)
    frames_dev: torch.Tensor  # the same pool on the device (the reference's input)
    focal: float
    mult: float
    depth: float
    weights: Optional[Dict]  # {"fcn", "mono"}: what both sides were given
    scenes: Optional[Dict]  # {"labels", "disp_norm", "rw", "f2f"} of the stand-ins
    setup_parts: Dict[str, float]
    fcn_out: Optional[torch.Tensor] = None  # the last call's FCN-8s logits (seeded networks)

    @property
    def batch(self) -> int:
        return int(self.cell.traffic["batch"])

    def positions(self, i: int) -> slice:
        """The pool frames of call ``i``."""
        k = i % len(self.batches)
        return slice(k * self.batch, (k + 1) * self.batch)

    def call(self, arr):
        """The traffic's entry point on one call's input."""
        if self.cell.traffic["entry"] == "process_frame":
            return self.pipe.process_frame(arr[0], self.focal, self.mult)
        return self.pipe.process_batch(arr, self.focal, self.mult)

    def scenes_of(self, sl: slice) -> Optional[Dict]:
        if self.scenes is None:
            return None
        return {k: self.scenes[k][sl] for k in ("labels", "disp_norm")}


def _timed(parts, key, fn):
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    parts[key] = time.perf_counter() - t0
    return out


PORT = "semantic_depth_tpu_torch"


def port_class(path: str):
    """The class ``"<module>:<Class>"`` that a configuration's
    ``networks.<slot>.port.class`` names. It has to lie inside the port's
    package: the harness builds and imports no program but the port (not the
    JAX package, whose name the port's begins with, so the first dotted name
    is compared whole), and the reference imports nothing of either."""
    module, _, name = path.partition(":")
    if module.split(".")[0] != PORT or not name:
        raise ValueError(f"port class {path!r}: not '<module>:<Class>' inside {PORT}")
    return getattr(importlib.import_module(module), name)


def _port_networks(c: Dict, weights: Dict, device):
    """The port's FCN-8s and Monodepth, built without an init on the meta
    device and given copies of the benchmark's weights through a strict
    ``load_state_dict`` (the copies become the parameters). A slot that
    names its ``port`` class is built as that class, with
    ``compute_dtype`` and the class's ``kwargs``."""
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth

    dtype = torch.bfloat16 if c["compute_dtype"] == "bfloat16" else torch.float32
    net = c["networks"]

    def named(slot):
        port = net[slot]["port"]
        return port_class(port["class"])(compute_dtype=dtype, **port.get("kwargs", {}))

    with torch.device("meta"):  # no init: the weights are the benchmark's
        if "port" in net["fcn8s"]:
            fcn = named("fcn8s")
        else:
            fcn = FCN8s(num_classes=net["fcn8s"]["num_classes"], compute_dtype=dtype,
                        fc_channels=net["fcn8s"]["fc_channels"],
                        input_s2d=net["fcn8s"]["input_s2d"],
                        width_mult=net.get("width_mult", 1.0))
        if "port" in net["monodepth"]:
            mono = named("monodepth")
        else:
            mono = Monodepth(encoder=net["monodepth"]["encoder"], compute_dtype=dtype,
                             input_s2d=net["monodepth"]["input_s2d"],
                             width_mult=net.get("width_mult", 1.0))
    for module, w in ((fcn, weights["fcn"]), (mono, weights["mono"])):
        module.load_state_dict({k: v.clone() for k, v in w.items()}, assign=True)
    return fcn, mono


def make_weights(c: Dict, gen: torch.Generator) -> Dict:
    """Both networks' weights from ``gen``, with the calibration's road
    logit bias on every pixel phase of ``upscore8``."""
    dtype = torch.bfloat16 if c["compute_dtype"] == "bfloat16" else torch.float32
    net = c["networks"]
    width = net.get("width_mult", 1.0)  # 1 but in the tests' tiny networks
    fcn_ref, mono_ref = ref_frame.references(c)
    f, m = net["fcn8s"], net["monodepth"]

    def draw(ref, slot, *layer_args):  # FCN-8s first, then monodepth, from one generator
        if nets.lists_params(ref):
            return weight_lib.make_params(ref.params(slot), gen, dtype)
        return weight_lib.make(ref.layers(slot["input_s2d"], width, *layer_args), gen, dtype)

    fcn = draw(fcn_ref, f, f["num_classes"], f["fc_channels"])
    mono = draw(mono_ref, m)
    nc = f["num_classes"]
    fcn["upscore8.bias"][0::nc] += c["calibration"]["road_logit_bias"]  # channel (phase * C + c)
    return dict(fcn=fcn, mono=mono)


DRAWS = 4  # draws of a seed's frames and weights before set-up gives up


def build(cell: Cell, seed: int, device) -> Bench:
    from semantic_depth_tpu_torch.ops import _cuda

    device = torch.device(device)
    parts: Dict[str, float] = {}
    t = cell.traffic
    if device.type == "cuda":
        _timed(parts, "context", lambda: torch.empty(1, device=device))
        _timed(parts, "kernels", _cuda.library)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    if int(t["pool"]) % int(t["batch"]):
        raise ValueError(f"pool {t['pool']} is not a whole number of batches of {t['batch']}")
    for draw in range(1, DRAWS + 1):
        try:
            return _draw(cell, gen, device, parts)
        except ref_frame.NoRoad:
            if draw == DRAWS:
                raise
            parts["redraws"] = float(draw)


def _draw(cell: Cell, gen: torch.Generator, device, parts: Dict[str, float]) -> Bench:
    """One draw of the pool and the weights from ``gen``, the port's
    pipeline on them, the calibration and the warm-up."""
    from semantic_depth_tpu_torch.pipeline import SemanticDepthPipeline

    c, t = cell.config, cell.traffic
    n_pool, b = int(t["pool"]), int(t["batch"])

    def pool():
        params = scene_lib.pool_params(n_pool, gen)
        imgs, _, _, rw, f2f = scene_lib.render_pool(params, t["frame_height"], t["frame_width"],
                                                    c["camera"], gen)
        stand = None
        if t["networks"] == "scenes":
            _, labels, disp, _, _ = scene_lib.render_pool(
                params, c["input_height"], c["input_width"], c["camera"], gen, image=False,
                disparity_mult=t["scene_disparity_multiplier"])
            stand = dict(labels=labels, disp_norm=disp, rw=rw, f2f=f2f)
        return imgs, stand

    frames_dev, stand = _timed(parts, "pool", pool)
    if t["frames"] == "device":  # frames that a decoder left on the card: no upload
        batches = [frames_dev[i:i + b] for i in range(0, n_pool, b)]
    else:
        host = frames_dev.cpu().numpy()
        batches = [np.ascontiguousarray(host[i:i + b]) for i in range(0, n_pool, b)]
    cfg = port_config(c)
    weights = None
    if t["networks"] == "scenes":
        fcn = SceneFCN(stand["labels"][:b])
        mono = SceneMono(stand["disp_norm"][:b], c["networks"]["monodepth"]["flip_average"])
        mult = float(t["scene_disparity_multiplier"])
        parts["weights"] = 0.0
    else:
        weights = _timed(parts, "weights", lambda: make_weights(c, gen))
        fcn, mono = _timed(parts, "port_load", lambda: _port_networks(c, weights, device))
        mult = float(c["calibration"]["disparity_multiplier"])
    pipe = SemanticDepthPipeline(cfg, fcn, mono, device=device)
    focal = float(c["camera"]["focal"])
    depth = float(c["depth"])
    if weights is not None:  # the measuring depth where the reference's road cloud lies
        depth = _timed(parts, "calibration", lambda: ref_frame.calibrated_depth(
            frames_dev[:b], c, focal, mult, weights=weights))
        pipe.config = dataclasses.replace(pipe.config, depth=depth)
    bench = Bench(cell, device, pipe, batches, frames_dev, focal, mult, depth, weights, stand,
                  parts)
    if weights is not None:  # each call's FCN-8s output, held for the comparison
        pipe.fcn.register_forward_hook(lambda m, a, out: setattr(bench, "fcn_out", out))
    _timed(parts, "warmup", lambda: warm_up(bench))
    return bench


def _no_road(bench: Bench, out, j: int, what: str, f2f: bool = False) -> None:
    """Raise for frame ``j`` of the warm-up call ``out``, which leaves no
    road point or no finite width (``f2f``: no finite fence distance):
    ``NoRoad`` where the reference's tail on the program's own masks and
    disparity gives none either, a ``RuntimeError`` naming the reference's
    where it gives one."""
    o = judge.outputs(out)
    ref = ref_frame.tail(o["disparity"], o["road_mask"], o["fence_mask"], bench.cell.config,
                         bench.focal, bench.depth)
    if f2f:
        ref_f2f = float(ref["dist_f2f"].reshape(-1)[j])
        if math.isfinite(ref_f2f):
            raise RuntimeError(f"{what}; the reference's tail gives {ref_f2f}")
    else:
        ref_rw = float(ref["dist_rw"].reshape(-1)[j])
        ref_kept = int(ref["keep"].reshape(-1, ref["keep"].shape[-1])[j].sum())
        if ref_kept and math.isfinite(ref_rw):
            raise RuntimeError(f"{what}; the reference's tail keeps {ref_kept}, dist_rw {ref_rw}")
    raise ref_frame.NoRoad(f"{what}, as does the reference's tail on the same masks and disparity")


def warm_up(bench: Bench) -> None:
    """Each call input once, then ``warmup_calls`` more; fails naming the
    frame that leaves no road point or no finite distance (``_no_road``)."""
    n = len(bench.batches) + int(bench.cell.traffic["warmup_calls"])
    both = bench.cell.config["approach"] == "both" and bench.scenes is not None
    for i in range(n):
        t0 = time.perf_counter()
        out = bench.call(bench.batches[i % len(bench.batches)])
        if i == 0:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            bench.setup_parts["first_call"] = time.perf_counter() - t0
        if i >= len(bench.batches):
            continue
        kept = out.road_cloud.valid.reshape(-1, out.road_cloud.valid.shape[-1]).sum(-1)
        rw = out.dist_rw.reshape(-1)
        f2f = out.dist_f2f.reshape(-1)
        for j in range(rw.shape[0]):
            frame = i * bench.batch + j
            if int(kept[j]) == 0 or not bool(torch.isfinite(rw[j])):
                _no_road(bench, out, j, f"warm-up: pool frame {frame} keeps {int(kept[j])} road"
                                        f" points, dist_rw {float(rw[j])}")
            if both and not bool(torch.isfinite(f2f[j])):
                _no_road(bench, out, j, f"warm-up: pool frame {frame} gives dist_f2f "
                                        f"{float(f2f[j])}", f2f=True)
