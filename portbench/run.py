#!/usr/bin/env python3
"""The benchmark of semantic_depth_tpu_torch on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout: loads the cell named in BENCHMARK.json
(its configuration, traffic mix and limits, each a file under portbench/),
sets up (kernels, seeded weights and frames, the pipeline, the
reference's calibration, warm-up: ``setup_s``, less the calibration), runs the traffic for ``--seconds``, compares the
outputs of a seeded sample of the window's calls with the plain reference
(``correct``) and prints one JSON line last on standard output. With
``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` a profiled window gives its per-layer metrics.

Exits non-zero and prints no result without the cards the cell asks for,
when a check of set-up fails, or when jax, jaxlib, flax or
semantic_depth_tpu is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import Counter, defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "semantic_depth_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels", "CUDA_CACHE_PATH": "cuda"}


def use_checkout_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench-cache" / sub)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def _kernel_ms(kernel_s):
    from portbench.harness import bounds

    out = defaultdict(float)
    for name, s in kernel_s.items():
        key = bounds.kernel_of(name)
        if key is not None:
            out[key] += s * 1e3
    return dict(out)


def _work(bench, held, calls):
    """The traced window's kernel bounds (ms, summed over its calls) and the
    step's work a frame, from the reference tail on each input's outputs."""
    from portbench.harness import bounds
    from portbench.reference import frame as ref_frame

    c, t = bench.cell.config, bench.cell.traffic
    bound, ops = {}, {}
    for pos, prog in held.items():
        ref = ref_frame.tail(prog["disparity"], prog["road_mask"], prog["fence_mask"], c,
                             bench.focal, bench.depth)
        work = bounds.kernel_work(ref, c)
        bound[pos] = sum(bounds.bound_ms(*w)[0] for w in work.values())
        ops[pos] = sum(w[1] for w in work.values())
    n_in = len(bench.batches)
    per_pos = Counter(i % n_in for i in range(calls))
    net = sum(c["network_gflop_per_frame"].values()) * 1e9 if t["networks"] == "seeded" else 0.0
    return (sum(bound[p] * n for p, n in per_pos.items()),
            dict(network_flop=net,
                 resize_flop=bounds.resize_flop((t["frame_height"], t["frame_width"]),
                                                (c["input_height"], c["input_width"])),
                 tail_ops=sum(ops.values()) / (len(ops) * bench.batch)))


def measure(cell, seed: int, seconds: float, trace: bool, device="cuda", t0=None,
            broken=None, log=print):
    """One run: (result dict, check rows). ``broken(bench)``, where given,
    breaks the timed path after set-up (the tests' planted faults)."""
    import torch

    from portbench.harness import judge, loop, setup
    from portbench.harness import trace as trace_lib
    from portbench.harness.cell import reader

    t0 = time.perf_counter() if t0 is None else t0
    bench = setup.build(cell, seed, device)
    if broken is not None:
        broken(bench)
    setup_s = time.perf_counter() - t0 - bench.setup_parts.get("calibration", 0.0)
    log("setup " + " ".join(f"{k} {v:.3f}" for k, v in bench.setup_parts.items())
        + f" setup_s {setup_s:.3f} s (calibration left out)")
    on_card = bench.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    result, metrics = {}, {}
    if not trace:
        win = loop.run(bench, seconds, seed)
        samples, attempted, failed = win["kept"], win["frames"], win["failed"]
        e2e = loop.end_to_end(win, bench.batch)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = dict(value=e2e[m["name"]], unit=m["unit"])
    else:
        keep = loop.Reservoir(int(cell.traffic["check_batches"]), seed)
        held = {}

        def on_call(i, out):
            keep.offer(i, out, bench.fcn_out)
            held[i % len(bench.batches)] = judge.outputs(out)

        prof = trace_lib.profiled_window(
            bench, min(seconds, float(cell.traffic["trace_seconds"])), on_call)
        stages = trace_lib.stage_spans(bench)
        tail_kernels = trace_lib.tail_kernels(bench)
        samples, attempted, failed = keep.samples(), prof["frames"], prof["failed"]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"card {power_limit() if on_card else 'none'}; memory peak {peak} bytes")
    bench.pipe = None  # the program's state goes before the reference runs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = judge.compare(bench, samples)
    correct, rows = judge.verdict(numbers, cell.limits)
    for name in ("rw_truth_m", "f2f_truth_m"):
        if name in numbers:
            log(f"info {name} {numbers[name]!r} (no limit)")
    if trace:
        bound_total, work = _work(bench, held, prof["calls"])
        t = dict(profile=prof, stages=stages, tail_kernels=tail_kernels, work=work,
                 bound_ms=bound_total, kernel_ms=_kernel_ms(prof["kernel_s"]),
                 networks=cell.traffic["networks"])
        for m in cell.per_layer:
            value = reader(m["name"])(t)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        top = sorted(prof["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = dict(device_ops=[[n[:160], s] for n, s in top],
                                   idle_gaps=prof["idle_gaps"])
    device = dict(platform="gpu" if on_card else "cpu", kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                  count=1, memory_peak_bytes=int(peak))
    if trace:
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    out = dict(correct=bool(correct), attempted=int(attempted), failed=int(failed),
               metrics=metrics, device=device)
    out.update(result)
    out["check"] = {n: dict(value=v, limit=lim) for n, v, lim in rows}
    return out, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import cell as cell_lib

    cell = cell_lib.load(args.workload)
    import semantic_depth_tpu_torch  # noqa: F401  (no program, no run)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"imports {time.perf_counter() - T_START:.3f} s")
    result, rows = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                           log=log)
    bad = forbidden_modules()
    if bad:
        log(f"loaded after the window: {', '.join(bad)}")
        return 3
    for name, value, limit in rows:
        log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
