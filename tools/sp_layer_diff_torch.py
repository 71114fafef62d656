#!/usr/bin/env python3
"""Where the row-sharded (sp) frame program's bfloat16 disparity departs
from the unsharded one: every convolution of the native networks, layer by
layer, with the rows beside the shard boundary (the halo rows) and the
interior rows apart, beside the unsharded bfloat16 network's own departure
from float32 on the same frame.

    python3 tools/sp_layer_diff_torch.py [--json PATH] [--device cpu --tiny]

Two ranks share the card (``parallel.launch.run_ranks``, gloo), as in
``chip_smoke.py`` phase 11 (c). Both run the native networks
(``build_pipeline(native_s2d=True)``, random weights) on one 1024x2048
scene frame three times: unsharded in bfloat16, unsharded in float32 (same
weights), and sp=2 in bfloat16. Each convolution's output is compared, for
each layer:

- ``sp``: the sp=2 output (gathered) against the unsharded bfloat16 one,
  the largest and the mean absolute difference over the halo rows (the
  ``HALO`` output rows on each side of the shard boundary) and over the
  interior rows; these carry what earlier layers passed on;
- ``alone``: the sp=2 layer against the unsharded layer on the SAME input
  (the sp run's input gathered), the same two bands: what this layer adds
  by itself (a halo exchange fault shows here, at the halo rows);
- ``bf16_vs_f32``: the unsharded bfloat16 output against the float32 one,
  largest and mean absolute difference: bfloat16's own rounding;
- ``scale``: the largest absolute value of the unsharded bfloat16 output.

Then the frame program's disparity and road mask: sp=2 against unsharded
bfloat16, each of them against float32. Prints a table and one
JSON line; ``--json`` writes the whole record. ``--device cpu --tiny``
rehearses on the CPU at 256x512 with width-scaled networks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HALO = 4  # output rows on each side of the shard boundary counted as halo rows


def _bands(d, g):
    """(halo max, halo mean, interior max, interior mean) of an NCHW
    difference ``d`` of a level of ``g`` rows (sp=2: the boundary at g / 2;
    a level of at most 2 * HALO rows is all halo, its interior nan)."""
    top, mean = d.float().abs().amax(dim=(0, 1, 3)), d.float().abs().mean(dim=(0, 1, 3))
    halo = torch.zeros(g, dtype=torch.bool, device=d.device)
    halo[max(0, g // 2 - HALO):g // 2 + HALO] = True
    inner = ~halo
    nan = float("nan")
    return (float(top[halo].max()), float(mean[halo].mean()),
            float(top[inner].max()) if inner.any() else nan,
            float(mean[inner].mean()) if inner.any() else nan)


def _rank(frame_np, tiny, device):
    from semantic_depth_tpu_torch import config
    from semantic_depth_tpu_torch.cli.common import build_pipeline
    from semantic_depth_tpu_torch.models import spatial
    from semantic_depth_tpu_torch.parallel import ShardedPipeline, make_spatial_mesh
    from semantic_depth_tpu_torch.runtime import set_full_fp32

    dev = torch.device(device) if device == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    set_full_fp32()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    h, w = (256, 512) if tiny else (1024, 2048)
    frame = torch.from_numpy(frame_np).to(dev)

    def pipe_of(dtype_name):
        cfg = config.munich_pipeline_config(input_height=h, input_width=w,
                                            compute_dtype=dtype_name)
        return build_pipeline(cfg, "random", "random", tiny=tiny, native_s2d=True, device=dev)

    pipes = {"bf16": pipe_of("bfloat16"), "f32": pipe_of("float32")}
    names = {}
    for net in ("fcn", "mono"):
        for key, p in pipes.items():
            for name, mod in getattr(p, net).named_modules():
                names[id(mod)] = f"{net}.{name}"
    orig_conv, orig_convt = spatial.conv, spatial.conv_transpose
    stored, layers = {}, {}
    mode = {"now": None, "rows": None}

    def record(fn, layer, x, rows):
        y = fn(layer, x, rows)
        name = names[id(layer)]
        if mode["now"] == "bf16":
            stored[name] = y.detach().clone()
            layers[name] = dict(scale=float(y.float().abs().max()))
        elif mode["now"] == "f32":
            d = y.float() - stored[name].float()
            layers[name]["bf16_vs_f32"] = (float(d.abs().max()), float(d.abs().mean()))
        else:
            rs = mode["rows"]
            whole = rs.whole(y) if rs.is_split(y) else y
            g = whole.shape[-2]
            layers[name]["split"] = bool(rs.is_split(y))
            layers[name]["sp"] = _bands(whole - stored[name], g)
            if rs.is_split(y):
                xw = rs.whole(x) if rs.is_split(x) else x
                layers[name]["alone"] = _bands(rs.whole(y - rs.own(layer(xw))), g)
        return y

    spatial.conv = lambda layer, x, rows: record(orig_conv, layer, x, rows)
    spatial.conv_transpose = lambda layer, x, rows: record(orig_convt, layer, x, rows)
    try:
        with torch.no_grad():
            mode["now"] = "bf16"
            out16 = pipes["bf16"].process_frame(frame)
            mode["now"] = "f32"
            out32 = pipes["f32"].process_frame(frame)
            sp = ShardedPipeline(pipes["bf16"], make_spatial_mesh(2))
            mode["now"] = "sp"
            mode["rows"] = sp._rows
            out_sp = sp.process_frame(frame)
    finally:
        spatial.conv, spatial.conv_transpose = orig_conv, orig_convt

    def agree(a, b):
        return float((a == b).float().mean())

    frame_rec = dict(
        disparity_max=float(out16.disparity.abs().max()),
        sp_disparity_max_diff=float((out_sp.disparity - out16.disparity).abs().max()),
        bf16_vs_f32_disparity_max_diff=float((out16.disparity - out32.disparity).abs().max()),
        sp_vs_f32_disparity_max_diff=float((out_sp.disparity - out32.disparity).abs().max()),
        sp_road_mask_agreement=agree(out_sp.road_mask, out16.road_mask),
        bf16_vs_f32_road_mask_agreement=agree(out16.road_mask, out32.road_mask),
    )
    order = [n for n in stored]  # the forward's order
    return dict(frame=frame_rec, layers=[dict(name=n, **layers[n]) for n in order],
                device=torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                hw=[h, w], halo_rows=HALO)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", default=None, help="write the whole record here")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--tiny", action="store_true", help="256x512, width-scaled networks")
    args = p.parse_args(argv)

    from semantic_depth_tpu_torch.parallel.launch import run_ranks
    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU rehearsal")
    h, w = (256, 512) if args.tiny else (1024, 2048)
    frame = scene_pool(1, h, w, seed=3)[0][0]
    ranks = run_ranks(_rank, 2, frame, args.tiny, args.device, timeout_s=900,
                      device="cpu" if args.device == "cpu" else None)
    rec = ranks[0]
    print(f"{'layer':28s} {'split':>5s} {'scale':>9s} {'bf16-f32 max':>12s} "
          f"{'sp halo max':>11s} {'sp inner max':>12s} {'alone halo':>10s} {'alone inner':>11s}")
    for row in rec["layers"]:
        sp = row["sp"]
        alone = row.get("alone", (float("nan"),) * 4)
        print(f"{row['name']:28s} {str(row['split']):>5s} {row['scale']:9.4g} "
              f"{row['bf16_vs_f32'][0]:12.4g} {sp[0]:11.4g} {sp[2]:12.4g} {alone[0]:10.4g} "
              f"{alone[2]:11.4g}")
    print(json.dumps(dict(device=rec["device"], hw=rec["hw"], **rec["frame"])))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
