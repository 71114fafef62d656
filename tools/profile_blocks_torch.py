#!/usr/bin/env python3
"""Where the networks' milliseconds go, block by block, in the PyTorch port
at the native resolution (port of ``tools/profile_blocks.py``).

    python3 tools/profile_blocks_torch.py [--h 1024 --w 2048 --batch 4]
        [--iters 5] [--net fcn|mono|both] [--kernels]
        [--json out.json] [--device cpu] [--tiny]

FCN-8s/VGG16 and monodepth-vgg as the native frame program builds them
(``input_s2d``), full width (``--tiny``: width-scaled, for smoke runs) with
seeded random weights, on ``--batch`` random images of ``--h x --w``, each forward
in float32 (TF32 off) and in bfloat16. Every child layer of the network
(``nn.Module.named_children``) is timed by a forward pre-hook and a forward
hook: CUDA events on the card, the host clock on the CPU. The layers are
summed into blocks (FCN-8s: block1-5, fc6, fc7, the score and upsampling
head; monodepth: enc1-7, and dec0-7 with each level's upconv, iconv and
disparity layer); "between layers" is the forward's time outside them
(activations, pools, the s2d packing, concatenations). Each block's time is
the median over ``--iters`` forwards after a warm-up one. ``--kernels`` adds
one ``torch.profiler`` pass per network and dtype with each layer inside a
``record_function`` range, and names each block's longest device kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BETWEEN = "between layers"


def block_of(net: str, layer: str) -> str:
    """The block a child layer belongs to."""
    if net == "fcn":
        m = re.fullmatch(r"conv(\d)_\d", layer)
        if m:
            return f"block{m.group(1)}"
        return layer if layer in ("fc6", "fc7") else "head (scores, upscore)"
    m = re.fullmatch(r"enc(\d)[ab]", layer)
    if m:
        return f"enc{m.group(1)}"
    m = re.fullmatch(r"(?:upconv|iconv|disp)(\d)", layer)
    if m:
        return f"dec{m.group(1)}"
    return layer  # resnet50 layers keep their names


class _Clock:
    """Marks on the card's stream (CUDA events) or the host clock."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()


def time_blocks(torch, net_name, net, x, iters, clock):
    """Median ms of each block and of the whole forward over ``iters``, and
    of each layer."""
    marks = []

    def pre(name):
        return lambda mod, args: marks.append((name, "start", clock.mark()))

    def post(name):
        return lambda mod, args, out: marks.append((name, "end", clock.mark()))

    handles = []
    for name, child in net.named_children():
        handles.append(child.register_forward_pre_hook(pre(name)))
        handles.append(child.register_forward_hook(post(name)))
    per_iter = []
    try:
        with torch.inference_mode():
            net(x)  # warm-up: cuDNN's algorithm choice, allocations
            clock.sync()
            for _ in range(iters):
                marks.clear()
                t0 = clock.mark()
                net(x)
                t1 = clock.mark()
                clock.sync()
                blocks, layers = defaultdict(float), defaultdict(float)
                opened = {}
                for name, kind, m in marks:
                    if kind == "start":
                        opened[name] = m
                    else:
                        layers[name] += clock.ms(opened.pop(name), m)
                for name, ms in layers.items():
                    blocks[block_of(net_name, name)] += ms
                total = clock.ms(t0, t1)
                blocks[BETWEEN] = total - sum(blocks.values())
                blocks["forward"] = total
                per_iter.append((blocks, layers))
    finally:
        for h in handles:
            h.remove()

    def median(i):
        return {k: statistics.median(it[i][k] for it in per_iter) for k in per_iter[0][i]}

    return median(0), median(1)


def kernels_by_block(torch, net_name, net, x, top=3):
    """One profiled forward with each layer in a ``record_function`` range:
    per block, its ``top`` longest device kernels (name, ms)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    ranges = []
    handles = []
    for name, child in net.named_children():
        def pre(mod, args, name=name):
            rf = record_function(f"layer:{name}")
            rf.__enter__()
            ranges.append(rf)

        def post(mod, args, out):
            ranges.pop().__exit__(None, None, None)

        handles.append(child.register_forward_pre_hook(pre))
        handles.append(child.register_forward_hook(post))
    try:
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                         ProfilerActivity.CUDA]) as prof:
            net(x)
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    found = defaultdict(lambda: defaultdict(float))

    def walk(evt, block):
        for k in getattr(evt, "kernels", []):
            found[block][k.name] += k.duration / 1e3
        for child in evt.cpu_children:
            walk(child, block)

    for evt in prof.events():
        if evt.name.startswith("layer:"):
            walk(evt, block_of(net_name, evt.name[len("layer:"):]))
    return {b: sorted(ks.items(), key=lambda kv: -kv[1])[:top] for b, ks in found.items()}


def build(torch, net_name, dtype, args, device):
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth

    kw = dict(input_s2d=True, compute_dtype=dtype)
    # --tiny: the widths of cli.common.build_pipeline(tiny=True)
    fcn_kw = dict(width_mult=0.0625, fc_channels=32) if args.tiny else {}
    mono_kw = dict(width_mult=0.0625) if args.tiny else {}
    torch.manual_seed(0 if net_name == "fcn" else 1)
    with torch.device(device):
        if net_name == "fcn":
            net = FCN8s(num_classes=3, **fcn_kw, **kw)
        else:
            net = Monodepth(encoder="vgg", **mono_kw, **kw)
    return net.eval()


def run(args, log=print):
    import numpy as np
    import torch

    from semantic_depth_tpu_torch.runtime import resolve_device, set_full_fp32

    device = resolve_device("cpu" if args.device == "cpu" else None)
    set_full_fp32()
    clock = _Clock(torch, device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (args.batch, args.h, args.w, 3)).astype(
        np.float32)).to(device)
    nets = ("fcn", "mono") if args.net == "both" else (args.net,)
    res = dict(h=args.h, w=args.w, batch=args.batch, iters=args.iters,
               device=str(device), nets={})
    if device.type == "cuda":
        res["card"] = torch.cuda.get_device_name(device)
    for net_name in nets:
        rows, layers, kernels = {}, {}, {}
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            net = build(torch, net_name, dtype, args, device)
            rows[dname], layers[dname] = time_blocks(torch, net_name, net, x, args.iters, clock)
            if args.kernels and device.type == "cuda":
                kernels[dname] = kernels_by_block(torch, net_name, net, x)
            del net
            if device.type == "cuda":
                torch.cuda.empty_cache()
        f32, bf16 = rows["float32"], rows["bfloat16"]
        names = sorted((k for k in f32 if k != "forward"), key=lambda k: -f32[k])
        log(f"--- {net_name} (input_s2d), batch "
            f"{args.batch} x {args.h}x{args.w}: forward {f32['forward']:.3f} ms float32, "
            f"{bf16['forward']:.3f} ms bfloat16 ---")
        log(f"{'block':28s} {'float32 ms':>12s} {'share':>7s} {'bfloat16 ms':>12s} "
            f"{'f32/bf16':>9s}")
        for k in names:
            ratio = f32[k] / bf16[k] if bf16.get(k) else float("nan")
            log(f"{k:28s} {f32[k]:12.3f} {f32[k] / f32['forward']:7.3f} "
                f"{bf16.get(k, 0.0):12.3f} {ratio:9.2f}")
        top = names[0] if names[0] != BETWEEN else names[1]
        for dname in rows:
            mine = sorted((k for k in layers[dname] if block_of(net_name, k) == top),
                          key=lambda k: -layers[dname][k])
            log(f"  {dname} {top}: " + ", ".join(f"{k} {layers[dname][k]:.3f} ms" for k in mine))
        for dname, blocks in kernels.items():
            for k in names[:5]:
                for kname, ms in blocks.get(k, []):
                    log(f"  {dname} {k}: {ms:.3f} ms {kname[:110]}")
        res["nets"][net_name] = dict(float32=f32, bfloat16=bf16, layers=layers,
                                     kernels=kernels)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


def parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--h", type=int, default=1024)
    p.add_argument("--w", type=int, default=2048)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--net", choices=["fcn", "mono", "both"], default="both")
    p.add_argument("--kernels", action="store_true",
                   help="name each block's longest device kernels (torch.profiler, card only)")
    p.add_argument("--tiny", action="store_true", help="width-scaled networks (smoke runs)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--json", default=None)
    return p


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
