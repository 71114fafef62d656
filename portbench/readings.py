#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... \\
        [--witness 11,12,13] [--control 21,22,23] [--faults 31,32,33] [--seconds 2] \\
        [--json out.json]

In one process, for each seed: the cell's set-up and a short window of its
traffic, then the numbers ``correct`` compares (``harness.judge``):

* ``--seeds``: the program, as a run computes them (the lower readings);
* ``--witness``: the reference summing in the libraries' order
  (``reference.precision.REORDERED``) in the program's place, a sound
  program in another order (lower readings too);
* ``--control``: the reference one precision step down (``reference.
  precision.CONTROL``) in the program's place, on as many calls as a run
  compares (the upper readings);
* ``--faults``: the program with each planted fault of ``judge.FAULTS``
  that the cell can have, its timed path broken underneath.

The benchmark's own runs never run this. Needs the cell's card.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def readings(cell, args, device="cuda", log=print):
    import torch

    from portbench.harness import judge, loop, setup
    from portbench.reference.precision import CONTROL, REORDERED

    out = dict(workload=cell.name, program=[], witness=[], control=[], faults={})

    def free():
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    runs = [("program", seed, None) for seed in args.seeds]
    runs += [("witness", seed, None) for seed in args.witness]
    runs += [("control", seed, None) for seed in args.control]
    runs += [("faults", seed, name) for seed in args.faults for name in judge.FAULTS
             if judge.fault_applies(name, cell.traffic)]
    for kind, seed, fault in runs:
        t0 = time.perf_counter()
        bench = setup.build(cell, seed, device)
        if kind in ("control", "witness"):
            bench.pipe = None
            free()
            k = int(cell.traffic["check_batches"])
            prec = CONTROL if kind == "control" else REORDERED
            samples = judge.control_samples(bench, list(range(k)), prec)
            out[kind].append(dict(seed=seed, **judge.compare(bench, samples)))
        else:
            if fault is not None:
                judge.FAULTS[fault](bench)
            win = loop.run(bench, args.seconds, seed)
            bench.pipe = None
            free()
            row = dict(seed=seed, calls=win["calls"], **judge.compare(bench, win["kept"]))
            if fault is None:
                out["program"].append(row)
            else:
                out["faults"].setdefault(fault, []).append(row)
        del bench
        free()
        log(f"{kind} {fault or ''} seed {seed}: {time.perf_counter() - t0:.1f} s")
    summary = {}
    for n in judge.NUMBERS:
        row = dict(lower=max((r[n] for r in out["program"] + out["witness"] if n in r),
                             default=None),
                   control=min((r[n] for r in out["control"] if n in r), default=None))
        for name, rows in out["faults"].items():
            row[name] = min((r[n] for r in rows if n in r), default=None)
        summary[n] = row
    out["summary"] = summary
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--witness", type=_seeds, default=[])
    ap.add_argument("--control", type=_seeds, default=[])
    ap.add_argument("--faults", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run as bench_run

    bench_run.use_checkout_caches()
    import torch

    from portbench.harness import cell as cell_lib

    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    cell = cell_lib.load(args.workload)
    out = readings(cell, args, log=lambda m: print(m, file=sys.stderr, flush=True))
    text = json.dumps(out)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(text + "\n")
    print(json.dumps(out["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
