#!/usr/bin/env python3
"""A deep native fine-tune with a recorded accuracy-against-steps curve, on
the PyTorch port (port of ``tools/native_mae_curve.py``, built on
``tools/train_bench_weights_torch.py``). Offline: never inside a bench's
timing.

    python3 tools/native_mae_curve_torch.py [--out_dir .bench_weights]
        [--mono_steps 9600] [--fcn_steps 2200] [--eval_every 800] [--batch 4]
        [--eval_scenes 32] [--lr 1e-4] [--select_seed 1] [--report_seed0]
        [--headline] [--curve PATH] [--device cpu] [--tiny]
        [--hw 1024 2048] [--train_scenes N] [--warm_steps N]

Native mode (the default):
1. ensures the dense full-res sets (the native warm start; they start from
   the headline set, ensured first);
2. trains the native (``input_s2d``) FCN-8s set at its fixed budget;
3. trains the native monodepth set, pausing every ``--eval_every`` steps
   to serve the real frame program (native networks, bfloat16,
   ``flip_average=False``, ``rw_estimator="plane_edge"``: the JAX bench's
   native leg) over a held-out pool of ``--eval_scenes`` seed-
   ``--select_seed`` bench scenes and record rw / f2f MAE and the finite
   share; each eval point also tries the uniform average (SWA) of the last
   3 eval points' parameters;
4. keeps the best candidate as ``monodepth_native.msgpack`` only when it
   beats the cached set (the curve's step 0), and writes the curve to
   ``docs/NATIVE_MAE_CURVE_TORCH.json`` (``--curve``) and a copy beside the
   weights.

``--headline`` curves the 256x512 headline monodepth instead: it retrains
it with the headline recipe (``MONO_PHASES``, from its seeded init), serves
the dense bfloat16 program with the default estimator over full-res
held-out scenes at every eval point, keeps the best only if it beats the
cached set, and writes ``docs/HEADLINE_MAE_CURVE_TORCH.json``.

Each training's median seconds a step (the card synchronised after each
step) goes into the curve file under ``step_s``. ``--tiny`` (width-scaled
networks), ``--hw`` (the native set's resolution), ``--train_scenes`` and
``--warm_steps`` (the warm-start sets at that many steps each instead of
their recipes) make short runs; the defaults are the recipe's. Runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import train_bench_weights_torch as tbw  # noqa: E402

_DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs")
CURVE_DOC = os.path.join(_DOCS, "NATIVE_MAE_CURVE_TORCH.json")
HEADLINE_CURVE_DOC = os.path.join(_DOCS, "HEADLINE_MAE_CURVE_TORCH.json")
SWA_K = 3  # the SWA window: the uniform average of the last K eval points' parameters


def _fcn_kw(args):
    """The networks' widths: full, or ``--tiny``'s (FCN-8s fc 32)."""
    return dict(width_mult=0.0625, fc_channels=32) if args.tiny else {}


def _mono_kw(args):
    return dict(width_mult=0.0625) if args.tiny else {}


def _tree_mean(trees):
    """The leafwise float32 mean of flax-layout trees of numpy arrays."""
    if isinstance(trees[0], dict):
        return {k: _tree_mean([t[k] for t in trees]) for k in trees[0]}
    return (sum(np.asarray(t, np.float32) for t in trees) / np.float32(len(trees))).astype(
        np.float32)


def _batches(n, hw, seed, batch, device):
    """``n`` bench scenes of ``hw`` on the device in batches, and their true
    rw / f2f widths."""
    import torch

    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

    pool, _, _, rw_true, f2f_true = scene_pool(n, *hw, seed=seed)
    return ([torch.from_numpy(pool[i:i + batch]).to(device) for i in range(0, n, batch)],
            rw_true, f2f_true)


def evaluate(pipe, batches, rw_true, f2f_true):
    """(finite share of rw, rw MAE m, f2f MAE m) of ``process_batch`` over
    the batches against the analytic widths (None where nothing is finite)."""
    import torch

    outs = []
    with torch.inference_mode():
        for b in batches:
            o = pipe.process_batch(b)
            outs.append((o.dist_rw.float().cpu().numpy(), o.dist_f2f.float().cpu().numpy()))
    rw = np.concatenate([o[0] for o in outs])
    f2f = np.concatenate([o[1] for o in outs])
    fin, ff = np.isfinite(rw), np.isfinite(f2f)
    mae = float(np.abs(rw[fin] - rw_true[:rw.size][fin]).mean()) if fin.any() else None
    fmae = float(np.abs(f2f[ff] - f2f_true[:f2f.size][ff]).mean()) if ff.any() else None
    return float(fin.mean()), mae, fmae


def _r(x):
    return x if x is None else round(x, 4)


def _step_s(step_times):
    """Median seconds a step of each training (its first step left out where
    there are more)."""
    return {k: statistics.median(v[1:] if len(v) > 1 else v) for k, v in step_times.items() if v}


def _ensure_warm(args, log, step_times, device):
    """The headline and (native mode) full-res sets: their recipes, or
    ``--warm_steps`` steps each at batch 2 on ``--train_scenes`` scenes."""
    kw = dict(seed=args.seed, log=log, device=device, step_times=step_times, **_fcn_kw(args))
    if args.warm_steps:
        head = [(tbw.TRAIN_HW, args.train_scenes or 8, 2, args.warm_steps)]
        paths = tbw.ensure_bench_weights(args.out_dir, fcn_phases=head, mono_phases=head, **kw)
        if args.headline:
            return paths
        full = [(tuple(args.hw), args.train_scenes or 8, 2, args.warm_steps)]
        return tbw.ensure_bench_weights(args.out_dir, full_res=True, fcn_phases=full,
                                        mono_phases=full, **kw)
    return tbw.ensure_bench_weights(args.out_dir, full_res=not args.headline, **kw)


def run_headline(args, log):
    """The headline monodepth set's curve (see the module's docstring)."""
    from semantic_depth_tpu_torch.cli.common import build_pipeline
    from semantic_depth_tpu_torch.config import munich_pipeline_config
    from semantic_depth_tpu_torch.models import weights as weights_lib
    from semantic_depth_tpu_torch.models.from_flax import load_flax

    t_start = time.time()
    device = "cpu" if args.device == "cpu" else None
    step_times = {}
    fcn_path, mono_path = _ensure_warm(args, log, step_times, device)
    cfg = munich_pipeline_config(compute_dtype="bfloat16")
    pipe = build_pipeline(cfg, fcn_path, mono_path, tiny=args.tiny, device=device)

    log("rendering held-out eval pool ...")
    batches, rw_true, f2f_true = _batches(args.eval_scenes, tuple(args.hw), args.select_seed, 8,
                                          pipe.device)
    curve = []
    fin0, mae0, fmae0 = evaluate(pipe, batches, rw_true, f2f_true)
    log(f"  [curve] step 0 (cached set): rw_mae {_r(mae0)} m, f2f_mae {_r(fmae0)} m, "
        f"finite {fin0:.3f}")
    curve.append({"step": 0, "rw_mae_m": mae0, "f2f_mae_m": fmae0, "finite_frac": fin0,
                  "note": "cached headline set"})
    best = {"mae": mae0 if mae0 is not None else float("inf"), "step": 0}

    def hook(params, step):
        load_flax(pipe.mono, params)
        try:
            fin, mae, fmae = evaluate(pipe, batches, rw_true, f2f_true)
        except Exception as e:  # an eval must never end the training run
            log(f"  eval at step {step} failed: {type(e).__name__}: {e}")
            return
        log(f"  [curve] step {step}: rw_mae {_r(mae)} m, f2f_mae {_r(fmae)} m, finite {fin:.3f}")
        curve.append({"step": step, "rw_mae_m": mae, "f2f_mae_m": fmae, "finite_frac": fin})
        if mae is not None and mae < best["mae"]:
            best.update(mae=mae, step=step)
            weights_lib.save_params(params, mono_path)
            log(f"  new best at step {step}; saved {mono_path}")

    hw, n_scenes, t_batch, _ = tbw.MONO_PHASES[0]
    n_scenes = args.train_scenes or n_scenes
    log(f"training headline monodepth ({args.mono_steps} steps at {hw[0]}x{hw[1]} b{t_batch}, "
        f"eval every {args.eval_every}) ...")
    tbw.train_mono([(hw, n_scenes, t_batch, args.mono_steps)], seed=args.seed, lr=args.lr,
                   log=log, hook=hook, hook_every=args.eval_every, device=device,
                   step_times=step_times.setdefault("monodepth_headline_curve", []),
                   **_mono_kw(args))
    out = {
        "protocol": "the port's headline frame program (dense 256x512 networks, bfloat16, "
                    f"default estimator) over {args.eval_scenes} held-out "
                    f"seed-{args.select_seed} scenes at {args.hw[0]}x{args.hw[1]}; rw/f2f MAE "
                    "against the analytic widths (reference protocol: "
                    "semantic_depth.py:903-937). Step 0 = the cached headline set; the best "
                    "checkpoint replaces monodepth.msgpack only when it beats it. The "
                    "selection pool is disjoint from the bench's seed-0 report pool.",
        "select_seed": args.select_seed,
        "mono_steps": args.mono_steps,
        "batch": t_batch,
        "lr": args.lr,
        "best_step": best["step"],
        "best_rw_mae_m": None if best["mae"] == float("inf") else best["mae"],
        "wall_s": round(time.time() - t_start, 1),
        "curve": curve,
        "step_s": _step_s(step_times),
    }
    return _write(out, args.curve or HEADLINE_CURVE_DOC, None, log)


def run_native(args, log):
    """The native monodepth set's curve (see the module's docstring)."""
    from semantic_depth_tpu_torch.cli.common import build_pipeline
    from semantic_depth_tpu_torch.config import munich_pipeline_config
    from semantic_depth_tpu_torch.models import weights as weights_lib
    from semantic_depth_tpu_torch.models.from_flax import load_flax

    t_start = time.time()
    device = "cpu" if args.device == "cpu" else None
    hw = tuple(args.hw)
    n_train = args.train_scenes or 24
    step_times = {}
    # 1. the dense full-res warm starts
    fr_fcn_path, fr_mono_path = _ensure_warm(args, log, step_times, device)
    fcn_path, mono_path = tbw.bench_weight_paths(args.out_dir, native=True)

    # 2. the native FCN set
    if not os.path.exists(fcn_path):
        log(f"training native FCN-8s ({args.fcn_steps} steps) ...")
        params, _ = tbw.train_fcn(
            [(hw, n_train, args.batch, args.fcn_steps)], seed=args.seed,
            init_params=weights_lib.load_params(fr_fcn_path), input_s2d=True, lr=args.lr,
            log=log, device=device, step_times=step_times.setdefault("fcn_native", []),
            **_fcn_kw(args))
        weights_lib.save_params(params, fcn_path)
        log(f"saved {fcn_path}")
        del params
        tbw._release(device)

    # 3. the native monodepth set with the accuracy curve
    cfg = munich_pipeline_config(compute_dtype="bfloat16", input_height=hw[0],
                                 input_width=hw[1])
    # the estimator the JAX bench's native leg reports: selection optimises
    # the metric the record carries
    cfg = dataclasses.replace(cfg, rw_estimator="plane_edge")
    pipe = build_pipeline(cfg, fcn_path, "random", tiny=args.tiny, native_s2d=True,
                          device=device)
    log("rendering held-out eval pool ...")
    batches, rw_true, f2f_true = _batches(args.eval_scenes, hw, args.select_seed, args.batch,
                                          pipe.device)
    curve = []
    best = {"mae": float("inf")}
    # step 0: the cached native set must not regress; a retrain whose every
    # candidate evaluates worse leaves the cache as it is
    if os.path.exists(mono_path):
        load_flax(pipe.mono, weights_lib.load_params(mono_path))
        fin0, mae0, fmae0 = evaluate(pipe, batches, rw_true, f2f_true)
        log(f"  [curve] step 0 (cached set): rw_mae {_r(mae0)} m, finite {fin0:.3f}")
        curve.append({"step": 0, "rw_mae_m": mae0, "f2f_mae_m": fmae0, "finite_frac": fin0,
                      "note": "cached native set"})
        if mae0 is not None:
            best.update(mae=mae0, step=0, kind="cached")

    # a single eval point is chosen at its selection-pool noise minimum, so its
    # number is optimistic; the uniform average of the last SWA_K eval points'
    # parameters smooths that, and whichever candidate wins on the held-out
    # selection pool is kept
    swa_window = []

    def try_candidate(cand, step, kind, fields):
        load_flax(pipe.mono, cand)
        fin, mae, fmae = evaluate(pipe, batches, rw_true, f2f_true)
        tag = "" if kind == "raw" else f" [{kind}]"
        log(f"  [curve] step {step}{tag}: rw_mae {_r(mae)} m, f2f_mae {_r(fmae)} m, "
            f"finite {fin:.3f}")
        prefix = "" if kind == "raw" else "swa_"
        fields[f"{prefix}rw_mae_m"] = mae
        fields[f"{prefix}f2f_mae_m"] = fmae
        fields[f"{prefix}finite_frac"] = fin
        if mae is not None and mae < best["mae"]:
            best.update(mae=mae, step=step, kind=kind)
            weights_lib.save_params(cand, mono_path)
            log(f"  new best ({kind}) at step {step}; saved {mono_path}")

    def hook(params, step):
        fields = {"step": step}
        try:
            try_candidate(params, step, "raw", fields)
            swa_window.append(params)
            if len(swa_window) > SWA_K:
                swa_window.pop(0)
            if len(swa_window) >= 2:
                try_candidate(_tree_mean(swa_window), step, f"swa{len(swa_window)}", fields)
        except Exception as e:  # an eval must never end the training run
            log(f"  eval at step {step} failed: {type(e).__name__}: {e}")
        curve.append(fields)

    log(f"training native monodepth ({args.mono_steps} steps, eval every {args.eval_every}) ...")
    tbw.train_mono([(hw, n_train, args.batch, args.mono_steps)], seed=args.seed,
                   init_params=weights_lib.load_params(fr_mono_path), input_s2d=True,
                   lr=args.lr, log=log, hook=hook, hook_every=args.eval_every, device=device,
                   step_times=step_times.setdefault("monodepth_native", []),
                   **_mono_kw(args))

    out = {
        "protocol": "the port's native frame program (input_s2d networks, bfloat16, "
                    "flip_average=False, plane_edge) over "
                    f"{args.eval_scenes} held-out seed-{args.select_seed} scenes at "
                    f"{hw[0]}x{hw[1]}; rw/f2f MAE against the analytic widths (reference "
                    "protocol: semantic_depth.py:903-937, the Munich MAE sweep). The "
                    "selection pool is disjoint from the bench's seed-0 report pool.",
        "select_seed": args.select_seed,
        "mono_steps": args.mono_steps,
        "fcn_steps": args.fcn_steps,
        "batch": args.batch,
        "lr": args.lr,
        "best_step": best.get("step"),
        "best_kind": best.get("kind"),
        "best_rw_mae_m": None if best["mae"] == float("inf") else best["mae"],
        "wall_s": round(time.time() - t_start, 1),
        "curve": curve,
        "step_s": _step_s(step_times),
    }
    # report only, after the selection closed: the cached set on the bench's
    # seed-0 pool
    if args.report_seed0 and os.path.exists(mono_path):
        b0, rw0, f2f0 = _batches(32, hw, 0, args.batch, pipe.device)
        load_flax(pipe.mono, weights_lib.load_params(mono_path))
        fin_r, mae_r, _ = evaluate(pipe, b0, rw0, f2f0)
        log(f"  [report] seed-0 bench pool: rw_mae {_r(mae_r)} m, finite {fin_r:.3f}")
        out["seed0_report_rw_mae_m"] = mae_r
    return _write(out, args.curve or CURVE_DOC,
                  os.path.join(args.out_dir, "native_mae_curve_torch.json"), log)


def _write(out, path, copy, log):
    for p in filter(None, (path, copy)):
        os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)
        with open(p, "w") as f:
            json.dump(out, f, indent=1)
    log(f"curve written to {path}; best rw MAE {out['best_rw_mae_m']} m at step "
        f"{out['best_step']}; seconds a step {out['step_s']}")
    return out


def parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_dir", default=".bench_weights")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mono_steps", type=int, default=9600)
    p.add_argument("--fcn_steps", type=int, default=tbw.FCN_NATIVE_PHASES[0][3])
    p.add_argument("--eval_every", type=int, default=800)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--eval_scenes", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    # selection never happens on the pool the bench reports on (seed 0)
    p.add_argument("--select_seed", type=int, default=1)
    p.add_argument("--report_seed0", action="store_true",
                   help="after training, evaluate the cached native set on the bench's "
                        "seed-0 pool (report only)")
    p.add_argument("--headline", action="store_true",
                   help="curve the headline 256x512 monodepth set instead of the native one")
    p.add_argument("--curve", default=None,
                   help="where the curve goes (default: docs/*_MAE_CURVE_TORCH.json)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--tiny", action="store_true", help="width-scaled networks (short runs)")
    p.add_argument("--hw", type=int, nargs=2, default=list(tbw.FULL_HW),
                   help="the native set's resolution, and the held-out scenes'")
    p.add_argument("--train_scenes", type=int, default=0,
                   help="scenes a training pool (default: the recipe's)")
    p.add_argument("--warm_steps", type=int, default=0,
                   help="train absent warm-start sets at this many steps each (default: "
                        "their recipes)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)

    def log(*a):
        print(*a, flush=True)

    if args.headline:
        if args.mono_steps == 9600:  # the native default; the headline recipe's is 8000
            args.mono_steps = tbw.MONO_PHASES[0][3]
        return run_headline(args, log)
    return run_native(args, log)


if __name__ == "__main__":
    main()
