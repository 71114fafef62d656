#!/usr/bin/env python3
"""The scale and shift of seeded DPT-Large's disparity (the configuration
``munich-dpt-large-bf16``), from the seeded networks' outputs on the
benchmark's own frames and weights. Needs a card.

    python3 tools/dpt_scale_shift.py --seeds 1,2,3 [--json out.json]

For each seed, drawn as portbench's set-up draws them (``harness/setup``:
the frame pool, then the weights, from one generator on the card): the
plain reference's DPT-Large inverse depth ``inv`` (scale 1, shift 0) and
seeded monodepth-vgg's disparity (``munich-bf16``), each flip-blended and
before the multiplier, in float32 on the pool's frames at 256x512. Prints
their quantiles over every pixel, inv's share of zeros (the head's ReLU)
and of the positive pixels' median, and the pair that puts the median of
``scale * inv + shift`` at vgg's median with the shift half the median of
``scale * inv``: ``scale * median(inv) = 2/3`` and ``shift = 1/3`` of vgg's
median (medians over the seeds). The multiplier and the geometry tail's
thresholds in metres then see a cloud at vgg's depth.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
Q = (0.05, 0.25, 0.5, 0.75, 0.95)


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def seeded_outputs(c, seed, device="cuda"):
    """The flip-blended network output before the multiplier, (16, h, w)
    float32, of the configuration ``c`` at ``seed``'s draw."""
    import torch

    from portbench.harness import scenes as scene_lib
    from portbench.harness import setup
    from portbench.reference import frame as ref_frame

    t = json.loads((ROOT / "portbench" / "traffic" / "batch8.json").read_text())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = scene_lib.pool_params(int(t["pool"]), gen)
    frames = scene_lib.render_pool(params, t["frame_height"], t["frame_width"], c["camera"],
                                   gen)[0]
    weights = setup.make_weights(c, gen)
    out = ref_frame.networks(frames, c, 1.0, weights)["disparity"]
    return out / ref_frame.disparity_scale(c, 1.0).to(out.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=_seeds, default=[1, 2, 3])
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    configs = ROOT / "portbench" / "configs"
    dpt = json.loads((configs / "munich-dpt-large-bf16.json").read_text())
    dpt["networks"]["monodepth"].update(scale=1.0, shift=0.0)
    vgg_config = json.loads((configs / "munich-bf16.json").read_text())
    rows = []
    for seed in args.seeds:
        inv, vgg = seeded_outputs(dpt, seed), seeded_outputs(vgg_config, seed)
        q = torch.tensor(Q, device=inv.device)
        row = dict(seed=seed, inv=torch.quantile(inv.flatten(), q).tolist(),
                   inv_zero_share=float((inv == 0).float().mean()),
                   inv_positive_median=float(inv[inv > 0].median()),
                   vgg=torch.quantile(vgg.flatten(), q).tolist())
        rows.append(row)
        print(json.dumps(row), flush=True)
    level = statistics.median(r["vgg"][2] for r in rows)
    inv_median = statistics.median(r["inv"][2] for r in rows)
    scale = 2.0 / 3.0 * level / inv_median if inv_median > 0 else float("nan")
    shift = level / 3.0
    out = dict(quantiles=Q, seeds=rows, scale=scale, shift=shift,
               card=torch.cuda.get_device_name(0))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out) + "\n")
    print(json.dumps(dict(scale=scale, shift=shift)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
