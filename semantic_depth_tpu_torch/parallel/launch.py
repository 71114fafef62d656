"""Start a group of local ranks and collect what each returns.

``run_ranks(fn, world, *args)`` starts ``world`` processes with the
``spawn`` start method (CUDA cannot be forked), joins them into one process
group through a ``FileStore`` in a temporary directory (no port to find),
calls ``fn(*args)`` in each and returns the ranks' results in rank order.
The tests and ``chip_smoke.py`` use it; the CLIs run under ``torchrun``.

``fn`` must be importable by name (a module-level function) and return
something picklable: numpy arrays, numbers, CPU tensors. If a rank raises,
the call raises with that rank's traceback; if the deadline passes, every
child is killed and the call raises ``TimeoutError``.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback

_POLL_S = 0.2


def _child(rank, world, store_path, device, timeout_s, fn, args, results):
    try:
        import torch.distributed as dist

        from .mesh import init_distributed

        store = dist.FileStore(store_path, world)
        os.environ["LOCAL_RANK"] = str(rank)
        os.environ["LOCAL_WORLD_SIZE"] = str(world)
        init_distributed(device, rank=rank, world_size=world, store=store, timeout_s=timeout_s)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # the parent re-raises it with this rank's traceback
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, timeout_s: float = 300.0, device=None):
    """Run ``fn(*args)`` on ``world`` ranks of one process group; returns
    the ranks' results in rank order.

    ``device`` None puts the ranks on the card (``init_distributed``: NCCL
    when each rank has a card of its own, gloo when they share one);
    ``"cpu"`` runs them on the CPU over gloo. For the card, the kernels are
    built here once, before any rank starts. ``timeout_s`` bounds the whole
    call and each collective inside it."""
    if device is None or str(device).startswith("cuda"):
        from ..ops import _cuda

        _cuda.build()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="sd_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, args=(r, world, store, device, timeout_s, fn,
                                                  args, results), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        try:
            while len(got) < world:
                try:
                    rank, ok, val = results.get(timeout=_POLL_S)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"run_ranks: {world - len(got)} of {world} ranks still running "
                            f"after {timeout_s:.0f} s") from None
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive() and p.exitcode != 0]
                    if dead and results.empty():
                        raise RuntimeError(f"run_ranks: rank {dead[0]} died with exit code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n{val}")
                got[rank] = val
        finally:
            for p in procs:
                if p.is_alive() and len(got) < world:
                    p.kill()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
    return [got[r] for r in range(world)]
