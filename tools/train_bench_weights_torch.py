#!/usr/bin/env python3
"""Train (or reuse cached) full-size networks of the PyTorch port on the
analytic bench scenes, so that a benchmark of the port measures a program
that computes right road widths, not only a fast one (port of
``tools/train_bench_weights.py``, with the same phases, flags and files).

    python3 tools/train_bench_weights_torch.py [--out_dir .bench_weights]
        [--seed 0] [--force] [--full_res] [--native] [--evaluate]

* scenes: ``utils.bench_scenes`` renders a 3D corridor through the
  pipeline's own pinhole model: every pixel has an analytic class label
  and disparity, and each scene an exact road width;
* FCN-8s: supervised 3-class cross entropy (no dropout, no L2);
* monodepth: supervised multi-scale L1 against the analytic normalised
  disparity, 2x average-pooled per scale and weighted 1 + 4 on road
  pixels;
* the headline set trains at 256x512; the full-res set starts from it and
  fine-tunes at 1024x2048; the native (``input_s2d``) set starts from the
  full-res one, every leaf of the same path and shape copied (``_graft``);
* Adam with optax's ``cosine_decay_schedule(lr, total_steps)`` over all
  phases of a run (the first update uses ``lr`` itself), float32 with TF32
  off;
* sets are cached as msgpack under ``--out_dir`` (the JAX package reads
  them too); a run cut by its deadline is parked at ``*.partial`` and
  raises, so that it is never taken for a trained set.

Each phase's scene pool goes to the device once, and batches are gathered
there by index. Runs on the card unless ``device="cpu"`` (the tests).
``--evaluate`` serves each set it ensured through ``build_pipeline`` in
bfloat16 on 32 bench scenes at 1024x2048, as the JAX bench's accuracy leg
does, and prints its rw MAE.
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAIN_HW = (256, 512)  # the reference networks' working resolution
FULL_HW = (1024, 2048)  # the native full-res pipeline's input

# (hw, n_scenes, batch, steps) per phase; later phases go on with the same
# parameters and optimizer
FCN_PHASES = [(TRAIN_HW, 64, 8, 2400)]
MONO_PHASES = [(TRAIN_HW, 64, 8, 8000)]
FCN_FR_PHASES = [(FULL_HW, 24, 2, 800)]
MONO_FR_PHASES = [(FULL_HW, 24, 2, 800)]
FCN_NATIVE_PHASES = [(FULL_HW, 24, 4, 2200)]
MONO_NATIVE_PHASES = [(FULL_HW, 24, 4, 3200)]

# Wall-clock estimates (s) of a (FCN-8s, monodepth) training by set suffix,
# for the budget check of ``ensure_bench_weights``, each the recipe's steps
# times a measured median step, rounded up, on an NVIDIA H100 80GB HBM3 at
# 700.00 W. Headline: one run's loops (2400 x 101.7 ms and 8000 x 46.8 ms, the
# set ready in 645 s). Full-res and native: the larger of two runs of
# ``chip_smoke.py`` phase 13's 4 steps at 1024x2048 (800 x 435.9 ms and 800 x
# 180.0 ms at batch 2; 2200 x 214.5 ms and 3200 x 1005.4 ms at batch 4, the
# last 804.5 ms in the other run, most of it monodepth's float32 FFT
# convolutions in dec4); rendering the scene pools and writing the sets come
# on top.
_EST_TRAIN_S = {"": (260, 390), "_fullres": (350, 150), "_native": (480, 3220)}


def _graft(template, src):
    """``template`` (a flax-layout tree) with every leaf of ``src`` whose
    path and shape match copied in; the template's fresh init elsewhere.
    Warm-starts the input_s2d variants: only conv1_1 / enc1a (12-channel
    input), upscore8 (the four phases' outputs) and monodepth's new
    level-0 layers differ."""
    if isinstance(template, dict):
        return {k: _graft(v, src.get(k) if isinstance(src, dict) else None)
                for k, v in template.items()}
    if src is not None and np.shape(src) == np.shape(template):
        return src
    return template


def _onehot_labels(labels: np.ndarray) -> np.ndarray:
    """(N, H, W) uint8 label ids -> (N, H, W, 3) float32 one-hot (road 7,
    fence 13, background: ``train.data.prepare_ground_truth``'s encoding)."""
    out = np.zeros(labels.shape + (3,), np.float32)
    out[..., 0] = labels == 7
    out[..., 1] = labels == 13
    out[..., 2] = ~((labels == 7) | (labels == 13))
    return out


def _pools(phases, seed):
    """One scene pool per distinct resolution in ``phases``."""
    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

    pools = {}
    for hw, n, _, _ in phases:
        if hw not in pools:
            pools[hw] = scene_pool(n, *hw, seed=seed + 100 + hw[0])
    return pools


def cosine_lr(lr: float, total_steps: int, count: int) -> float:
    """optax's ``cosine_decay_schedule(lr, total_steps)`` at ``count``
    updates done, in float32 as optax computes it."""
    f32 = np.float32
    t = f32(min(count, total_steps))
    decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(total_steps)))
    return float(f32(lr) * decay)


def _adam(module, lr):
    import torch

    return torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _flip(x, flip):
    """Rows of ``x`` (B, H, W, ...) mirrored left-right where ``flip``."""
    import torch

    return torch.where(flip.view(-1, *[1] * (x.dim() - 1)), x.flip(2), x)


def fcn_loss(net, x, y):
    """Supervised cross entropy (``train.trainer.softmax_xent``)."""
    from semantic_depth_tpu_torch.train.trainer import softmax_xent

    return softmax_xent(net(x), y)


def mono_loss(mono, x, d, wm):
    """Road-weighted L1 of each scale's left disparity against the target
    pooled 2x a scale, each scale's mean halved a scale (finest first)."""
    disps = mono(x)
    loss = 0.0
    for i, dp in enumerate(disps):
        err = (dp[..., 0] - d).abs() * wm
        loss = loss + err.sum() / wm.sum() / (2.0 ** i)
        if i + 1 < len(disps):
            d, wm = _pool2(d), _pool2(wm)
    return loss


def _pool2(x):
    """(B, H, W) -> (B, H/2, W/2) average pool."""
    b, h, w = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def _run(name, net, phases, tensors, step_fn, lr, seed_rng, log, hook, hook_every, deadline,
         log_every, digits, step_times=None):
    """The training loop both networks share: ``tensors(hw, n)`` puts a
    phase's pool on the device, ``step_fn(pool, idx, flip)`` returns the
    loss of one batch; the index and flip draws come from
    ``default_rng(seed_rng)``, the loss is logged every ``log_every`` steps
    with ``digits`` decimals. ``step_times`` (a list): each step's seconds
    are appended, the device synchronised after each step (a hook's time
    left out). Returns (flax-layout params, truncated)."""
    import torch

    from semantic_depth_tpu_torch.models.from_flax import flax_from_module

    total = sum(s for *_, s in phases)
    opt = _adam(net, lr)
    rng = np.random.default_rng(seed_rng)
    dev = next(net.parameters()).device
    done = 0
    for pi, (hw, n, batch, steps) in enumerate(phases):
        pool = tensors(hw, n)
        t0 = time.time()
        for i in range(steps):
            t_step = time.perf_counter()
            idx = torch.as_tensor(rng.integers(0, n, size=batch), device=dev)
            flip = torch.as_tensor(rng.integers(0, 2, size=batch).astype(bool), device=dev)
            for group in opt.param_groups:
                group["lr"] = cosine_lr(lr, total, done)
            loss = step_fn(pool, idx, flip)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            done += 1
            if step_times is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                step_times.append(time.perf_counter() - t_step)
            if i % log_every == 0 or i == steps - 1:
                log(f"  {name} ph{pi} {hw} step {i}: loss {loss.item():.{digits}f} "
                    f"({time.time() - t0:.0f}s)")
            if hook_every and ((i + 1) % hook_every == 0 or i == steps - 1):
                hook(flax_from_module(net), i + 1)
            if deadline is not None and time.time() > deadline:
                log(f"  {name} ph{pi} deadline hit at step {i}; stopping early")
                return flax_from_module(net), True
    return flax_from_module(net), False


def train_fcn(phases=FCN_PHASES, *, width_mult=1.0, fc_channels=4096, lr=1e-4, seed=0,
              init_params=None, input_s2d=False, log=print, hook=None, hook_every=0,
              deadline=None, device=None, step_times=None):
    """Supervised FCN-8s training over ``phases``, warm-started from
    ``init_params`` where given (grafted for ``input_s2d``).
    ``hook(params, step)`` fires every ``hook_every`` steps and at a phase's
    end; ``deadline`` (a ``time.time()`` value) stops early; ``step_times``
    (a list) receives each step's seconds. Returns (flax-layout params,
    truncated): truncated parameters are under-trained and must not be
    cached as a finished set."""
    import torch

    from semantic_depth_tpu_torch.models import FCN8s
    from semantic_depth_tpu_torch.models.from_flax import flax_from_module, load_flax
    from semantic_depth_tpu_torch.runtime import resolve_device, set_full_fp32

    dev = resolve_device(device)
    set_full_fp32()
    net = FCN8s(num_classes=3, width_mult=width_mult, fc_channels=fc_channels,
                input_s2d=input_s2d, generator=torch.Generator().manual_seed(seed))
    if init_params is not None:
        load_flax(net, _graft(flax_from_module(net), init_params) if input_s2d else init_params)
    net.to(dev)
    pools = _pools(phases, seed)

    def tensors(hw, n):
        imgs, labels = pools[hw][0][:n], pools[hw][1][:n]
        return (torch.from_numpy(imgs).to(dev),
                torch.from_numpy(_onehot_labels(labels).astype(np.uint8)).to(dev))

    def step(pool, idx, flip):
        imgs, gts = pool
        x = _flip(imgs[idx].float(), flip)
        y = _flip(gts[idx].float(), flip)
        return fcn_loss(net, x, y)

    return _run("fcn", net, phases, tensors, step, lr, seed, log, hook, hook_every, deadline,
                100, 4, step_times)


def train_mono(phases=MONO_PHASES, *, encoder="vgg", width_mult=1.0, lr=1e-4, seed=0,
               road_weight=4.0, init_params=None, input_s2d=False, log=print, hook=None,
               hook_every=0, deadline=None, device=None, step_times=None):
    """Supervised monodepth over ``phases`` (see the module's docstring);
    arguments and result as ``train_fcn``'s."""
    import torch

    from semantic_depth_tpu_torch.models import Monodepth
    from semantic_depth_tpu_torch.models.from_flax import flax_from_module, load_flax
    from semantic_depth_tpu_torch.runtime import resolve_device, set_full_fp32

    dev = resolve_device(device)
    set_full_fp32()
    mono = Monodepth(encoder=encoder, width_mult=width_mult, input_s2d=input_s2d,
                     generator=torch.Generator().manual_seed(seed + 1))
    if init_params is not None:
        load_flax(mono, _graft(flax_from_module(mono), init_params) if input_s2d
                  else init_params)
    mono.to(dev)
    pools = _pools(phases, seed + 1000)

    def tensors(hw, n):
        imgs, labels, disps = pools[hw][0][:n], pools[hw][1][:n], pools[hw][2][:n]
        return (torch.from_numpy(imgs).to(dev), torch.from_numpy(disps).to(dev),
                torch.from_numpy(labels == 7).to(dev))

    def step(pool, idx, flip):
        imgs, disps, road = pool
        x = imgs[idx].float()
        x = _flip(x / x.new_tensor(255.0), flip)  # a true division, as JAX's
        wm = 1.0 + torch.tensor(road_weight, dtype=torch.float32, device=dev) * road[idx].float()
        return mono_loss(mono, x, _flip(disps[idx], flip), _flip(wm, flip))

    return _run("mono", mono, phases, tensors, step, lr, seed + 2, log, hook, hook_every,
                deadline, 250, 6, step_times)


def bench_weight_paths(out_dir=".bench_weights", full_res=False, native=False):
    """The (fcn_msgpack, mono_msgpack) cache paths of a weight set, without
    training anything."""
    suffix = "_native" if native else ("_fullres" if full_res else "")
    return (os.path.join(out_dir, f"fcn8s{suffix}.msgpack"),
            os.path.join(out_dir, f"monodepth{suffix}.msgpack"))


def ensure_bench_weights(out_dir=".bench_weights", seed=0, width_mult=1.0, fc_channels=4096,
                         fcn_phases=None, mono_phases=None, full_res=False, native=False,
                         force=False, log=print, deadline=None, device=None, step_times=None):
    """Return (fcn_msgpack, mono_msgpack) paths, training and caching a set
    that is absent.

    full_res=False: the 256x512 headline set (fcn8s / monodepth.msgpack);
    full_res=True: the dense 1024x2048 set (*_fullres.msgpack), fine-tuned
    from the headline set (ensured first); native=True: the input_s2d set
    (*_native.msgpack), trained at 1024x2048 with every matching leaf
    grafted from the full-res set.

    deadline (a ``time.time()`` value): raise TimeoutError rather than start
    a training estimated not to finish by then (``_EST_TRAIN_S``); a running
    training stops at the deadline, is parked at ``*.partial`` and raises.
    ``step_times`` (a dict): each training this call runs appends its steps'
    seconds under ``"fcn<suffix>"`` / ``"monodepth<suffix>"``."""
    from semantic_depth_tpu_torch.models import weights as weights_lib

    os.makedirs(out_dir, exist_ok=True)
    if native:
        full_res = True  # native implies the full-res protocol
        suffix = "_native"
    else:
        suffix = "_fullres" if full_res else ""
    fcn_path, mono_path = bench_weight_paths(out_dir, full_res=full_res, native=native)
    if not force and os.path.exists(fcn_path) and os.path.exists(mono_path):
        return fcn_path, mono_path

    fcn_est, mono_est = _EST_TRAIN_S[suffix]

    def check_budget(est, what):
        if deadline is not None and time.time() + est > deadline:
            raise TimeoutError(f"{what} training (~{est}s) does not fit the remaining "
                               f"{deadline - time.time():.0f}s budget")

    fcn_init = mono_init = None
    if full_res:
        # the native set warm-starts from the dense full-res set, which
        # itself starts from the headline set
        base_fcn, base_mono = ensure_bench_weights(
            out_dir, seed=seed, width_mult=width_mult, fc_channels=fc_channels,
            full_res=native, log=log, deadline=deadline, device=device, step_times=step_times)
        fcn_init = weights_lib.load_params(base_fcn)
        mono_init = weights_lib.load_params(base_mono)
        if native:
            fcn_ph, mono_ph = fcn_phases or FCN_NATIVE_PHASES, mono_phases or MONO_NATIVE_PHASES
        else:
            fcn_ph, mono_ph = fcn_phases or FCN_FR_PHASES, mono_phases or MONO_FR_PHASES
    else:
        fcn_ph, mono_ph = fcn_phases or FCN_PHASES, mono_phases or MONO_PHASES
    # grafted warm starts reset parts of the nets: a higher lr than the dense
    # fine-tune, still cosine-decayed
    lr = 1e-4 if native else (5e-5 if full_res else 1e-4)

    def save_or_reject(result, path, what):
        params, truncated = result
        if truncated:
            partial = path + ".partial"
            weights_lib.save_params(params, partial)
            raise TimeoutError(f"{what} training hit the deadline mid-run; under-trained "
                               f"params parked at {partial}, cache not populated (rerun with "
                               "budget to train fully)")
        weights_lib.save_params(params, path)
        log(f"saved {path}")

    if force or not os.path.exists(fcn_path):
        check_budget(fcn_est, f"FCN-8s{suffix}")
        log(f"training FCN-8s{suffix} ...")
        save_or_reject(train_fcn(fcn_ph, width_mult=width_mult, fc_channels=fc_channels,
                                 seed=seed, init_params=fcn_init, input_s2d=native, lr=lr,
                                 log=log, deadline=deadline, device=device,
                                 step_times=_times(step_times, f"fcn{suffix}")),
                       fcn_path, f"FCN-8s{suffix}")
    fcn_init = None
    _release(device)
    if force or not os.path.exists(mono_path):
        check_budget(mono_est, f"monodepth{suffix}")
        log(f"training monodepth{suffix} ...")
        save_or_reject(train_mono(mono_ph, width_mult=width_mult, seed=seed,
                                  init_params=mono_init, input_s2d=native, lr=lr, log=log,
                                  deadline=deadline, device=device,
                                  step_times=_times(step_times, f"monodepth{suffix}")),
                       mono_path, f"monodepth{suffix}")
    _release(device)
    return fcn_path, mono_path


def _times(step_times, key):
    """The list under ``key`` of a ``step_times`` dict, or None."""
    return None if step_times is None else step_times.setdefault(key, [])


def _release(device):
    """Drop the last training's device memory before the next one."""
    import gc

    import torch

    gc.collect()
    if device != "cpu" and torch.cuda.is_available():
        torch.cuda.empty_cache()


def serve_rw_mae(fcn_path, mono_path, native=False, n_frames=32, batch=8, device=None):
    """A weight set served as the JAX bench's accuracy leg serves it:
    ``build_pipeline`` in bfloat16 (``native``: the input_s2d networks at
    1024x2048, batch 4), ``process_batch`` over ``n_frames`` bench scenes of
    1024x2048 (seed 0); returns (rw MAE over the finite widths in m, their
    share, the kernels' launches over the run)."""
    import torch

    from semantic_depth_tpu_torch.cli.common import build_pipeline
    from semantic_depth_tpu_torch.config import munich_pipeline_config
    from semantic_depth_tpu_torch.ops import _cuda
    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

    size = dict(input_height=FULL_HW[0], input_width=FULL_HW[1]) if native else {}
    cfg = munich_pipeline_config(compute_dtype="bfloat16", **size)
    if native:
        batch = 4
    pipe = build_pipeline(cfg, fcn_path, mono_path, native_s2d=native, device=device)
    imgs, _, _, rw_true, _ = scene_pool(n_frames, *FULL_HW, seed=0)
    _cuda.launches.clear()
    widths = []
    with torch.inference_mode():
        for i in range(0, n_frames, batch):
            frames = torch.from_numpy(imgs[i:i + batch]).to(pipe.device)
            widths.append(pipe.process_batch(frames).dist_rw.float().cpu().numpy())
    widths = np.concatenate(widths)
    finite = np.isfinite(widths)
    mae = float(np.abs(widths[finite] - rw_true[finite]).mean()) if finite.any() else None
    launches = {op: _cuda.launches[op] for op in ("knn_grid", "mad", "radius", "exact_knn")}
    return mae, float(finite.mean()), launches


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_dir", default=".bench_weights")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--force", action="store_true")
    p.add_argument("--full_res", action="store_true",
                   help="also train the dense full-res (1024x2048) weight set")
    p.add_argument("--native", action="store_true",
                   help="also train the input_s2d native full-res weight set")
    p.add_argument("--evaluate", action="store_true",
                   help="serve each set through the frame program and print its rw MAE")
    args = p.parse_args(argv)

    def logf(*a):
        print(*a, flush=True)

    sets = [dict()] + [dict(full_res=True)] * args.full_res + [dict(native=True)] * args.native
    for kw in sets:
        t0 = time.time()
        paths = ensure_bench_weights(args.out_dir, seed=args.seed, force=args.force, log=logf,
                                     **kw)
        logf(f"set {kw or 'headline'}: {paths} ready in {time.time() - t0:.1f} s")
        if args.evaluate:
            mae, finite, launches = serve_rw_mae(*paths, native=kw.get("native", False))
            logf(f"set {kw or 'headline'}: bfloat16 process_batch rw MAE {mae} m over the "
                 f"finite {finite:.3f} of 32 bench scenes; launches {launches}")


if __name__ == "__main__":
    main()
