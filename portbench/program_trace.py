#!/usr/bin/env python3
"""The port's own spans on one cell, on the card.

    python3 portbench/program_trace.py --workload <cell> --seed <n> \\
        [--seconds 2] [--json out.json]

Sets up as ``run.py`` does, runs the traced run's profiled window
(``trace.profiled_window``) and the harness's stage spans
(``trace.stage_spans``), then the second window with the program's tracing
on (``harness.program.window``), and prints one JSON line: each metric of
``program_metrics.json`` listed for the cell, read by its reader in
``metrics/``; both windows' frames per second (what tracing costs when on);
the idle seconds and the syncs by innermost span; the syncs of one call
beside the line of Python that made each (``program.sync_sites``); the
frames per second of unprofiled windows with tracing off and on, in turns;
and the ns of one ``runtime.annotate`` with tracing off, over 10^6 of them.

``run.py --trace 1`` reads none of this: the metrics here wait for the one
call in ``run.py`` that would put the second window in its trace
(``PERF.md``, open questions). Needs the cell's card.
"""

import argparse
import json
import statistics
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
METRICS = Path(__file__).resolve().parent / "program_metrics.json"


def off_cost_ns(n: int = 10 ** 6) -> float:
    """ns of ``with runtime.annotate(name, True): pass`` with tracing off,
    less the bare loop's ns."""
    from semantic_depth_tpu_torch import runtime

    t0 = time.perf_counter_ns()
    for _ in range(n):
        with runtime.annotate("sd.k2", True):
            pass
    t1 = time.perf_counter_ns()
    for _ in range(n):
        pass
    t2 = time.perf_counter_ns()
    return ((t1 - t0) - (t2 - t1)) / n


def on_off_frames_per_s(bench, seconds: float, rounds: int = 3):
    """Median frames per second of ``rounds`` unprofiled closed-loop windows
    with tracing off and as many with it on, in turns (off, on, on, off,
    ...)."""
    from portbench.harness import loop
    from semantic_depth_tpu_torch import runtime

    rates = {False: [], True: []}
    for r in range(rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            with runtime.tracing(on):
                win = loop.run(bench, seconds, 0)
            runtime.stats()
            rates[on].append(win["frames"] / win["seconds"])
    return {"off": statistics.median(rates[False]), "on": statistics.median(rates[True])}


def program_trace(cell, seed: int, seconds: float, device="cuda", log=print):
    import torch

    from portbench import run as bench_run
    from portbench.harness import cell as cell_lib
    from portbench.harness import program, setup
    from portbench.harness import trace as trace_lib

    bench = setup.build(cell, seed, device)
    first = trace_lib.profiled_window(bench, seconds)
    stages = trace_lib.stage_spans(bench)
    p = program.window(bench, seconds)
    out = dict(workload=cell.name, seed=seed, card=bench_run.power_limit(),
               torch=torch.__version__,
               first_frames_per_s=first["frames"] / first["window_s"],
               first_idle_share=100.0 * (1.0 - first["busy_s"] / first["window_s"]),
               harness_stages=stages, annotate_off_ns=off_cost_ns())
    if p is None:
        log("the program has no runtime.tracing: nothing to read")
        return out
    out["unprofiled_frames_per_s"] = on_off_frames_per_s(bench, seconds)
    t = dict(program=p)
    metrics = {m["name"]: cell_lib.reader(m["name"])(t)
               for m in json.loads(METRICS.read_text()) if cell.name in m["workloads"]}
    n = p["frames"]
    sites = program.sync_sites(lambda: bench.call(bench.batches[0]))
    paired = (Counter(zip(sites["spans"], sites["sites"])).most_common()
              if len(sites["spans"]) == len(sites["sites"]) else None)
    out.update(
        metrics=metrics, second_frames_per_s=n / p["window_s"],
        second_idle_share=100.0 * p["idle_window_s"] / p["window_s"],
        idle_share_sum=sum(100.0 * v / p["window_s"] for v in p["idle_s"].values()),
        idle_ms_by_span={k: v * 1e3 / n for k, v in sorted(p["idle_by_span"].items())},
        syncs_by_span={k: v / n for k, v in sorted(p["syncs_by_span"].items())},
        span_ms={k: dict(calls=v["calls"] / n, device_ms=None if v["device_ms"] is None
                         else v["device_ms"] / n, host_ms=v["host_ms"] / n)
                 for k, v in sorted(p["spans"].items())},
        kernel_ms={k: v / n for k, v in p["kernel_ms"].items()},
        one_call_syncs=dict(profiler=len(sites["spans"]), sync_debug=len(sites["sites"]),
                            paired=paired, spans=None if paired else sites["spans"],
                            sites=None if paired else sites["sites"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run as bench_run

    bench_run.use_checkout_caches()
    import torch

    from portbench.harness import cell as cell_lib

    if not torch.cuda.is_available():
        print("program_trace needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    cell = cell_lib.load(args.workload)
    out = program_trace(cell, args.seed, args.seconds,
                        log=lambda m: print(m, file=sys.stderr, flush=True))
    text = json.dumps(out)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
