"""The measured window: a closed loop of the traffic's entry point.

Call i takes the pool's i-th input (cycled); the window stops after the
call that completes at or past ``seconds``. Each call's ``dist_rw``,
``dist_f2f`` and ``rw_found`` are read to the host, and the call's latency
runs from the call until they are there. A seeded reservoir keeps the
outputs of ``check_batches`` calls, drawn uniformly from all calls of the
window, for the comparison after it, with the FCN-8s logits that the
call's network returned: holding them costs no copy.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

import numpy as np
import torch


def read_back(out) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return (out.dist_rw.cpu().numpy(), out.dist_f2f.cpu().numpy(), out.rw_found.cpu().numpy())


def failed_frames(host, need_f2f: bool) -> int:
    rw, f2f, found = (np.atleast_1d(x) for x in host)
    bad = ~np.isfinite(rw) | ~found.astype(bool)
    if need_f2f:
        bad |= ~np.isfinite(f2f)
    return int(bad.sum())


class Reservoir:
    """``k`` calls' outputs drawn uniformly from a stream of unknown length
    (seeded), each as ``judge.outputs`` gives it."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept = k, random.Random(int(seed)), []

    def offer(self, i: int, out, logits=None) -> None:
        from .judge import outputs

        if len(self.kept) < self.k:
            self.kept.append((i, outputs(out, logits)))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.kept[j] = (i, outputs(out, logits))

    def samples(self):
        return sorted(self.kept, key=lambda s: s[0])


def run(bench, seconds: float, seed: int) -> Dict:
    """The window. Returns frames, seconds, per-call latencies, failures and
    the kept samples [(call index, compared fields)]."""
    keep = Reservoir(int(bench.cell.traffic["check_batches"]), seed)
    need_f2f = bench.scenes is not None and bench.cell.config["approach"] == "both"
    lat: List[float] = []
    failed = frames = i = 0
    n_in = len(bench.batches)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        ts = time.perf_counter()
        out = bench.call(bench.batches[i % n_in])
        host = read_back(out)
        te = time.perf_counter()
        lat.append(te - ts)
        frames += bench.batch
        failed += failed_frames(host, need_f2f)
        keep.offer(i, out, bench.fcn_out)
        del out
        i += 1
        if te >= deadline:
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return dict(frames=frames, calls=i, seconds=te - t0, latencies=lat, failed=failed,
                kept=keep.samples())


def end_to_end(win: Dict, batch: int) -> Dict[str, float]:
    """Every end-to-end statistic a window gives; the manifest picks the
    cell's own. A frame's latency is its call's: in a call of several
    frames every frame waits for the whole call."""
    per_call = np.asarray(win["latencies"]) * 1e3
    return {
        "frames_per_s": win["frames"] / win["seconds"],
        "frame_ms_p50": float(np.percentile(np.repeat(per_call, batch), 50)),
        "frame_ms_p95": float(np.percentile(np.repeat(per_call, batch), 95)),
    }
