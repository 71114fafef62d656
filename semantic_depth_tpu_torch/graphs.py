"""CUDA graphs of the geometry tail (``SemanticDepthPipeline._batch_geometry``).

The tail is some 360 small kernels a call whose shapes the batch and the
config fix, so on the card the host's launches, one op at a time, are its
cost. A captured graph launches them all in one call. ``Cache`` keeps one
graph a key, least recently used first out: the first sight of a key runs
the tail eagerly (the warm-up a capture needs: K1's cached offset table, the
allocator's blocks), the second captures it and replays, every later one
replays. ``Captured`` is one graph with its static inputs and outputs.

A replay launches what the capture recorded, so the kernel wrappers'
counters (``launches``, ``general_launches``, ``large_k_launches``) rise at
each replay by what the capture counted, and not at the capture, which runs
nothing. The program's spans inside the tail record no CUDA events while
captured and open none at a replay (``runtime.annotate``).
"""

from __future__ import annotations

from collections import OrderedDict

import torch

SIZE = 4  # graphs a cache keeps, and keys seen once


def _counters():
    """(module, wrapper, counter) of each kernel wrapper's launch counter."""
    from .ops import exact_knn, knn_grid, mad, radius

    return [(mod, name, counter) for mod, name, counters in (
        (knn_grid, "knn_mean_distances_grid", ("launches", "general_launches")),
        (mad, "mad_keep_mask", ("launches",)),
        (radius, "radius_counts", ("launches",)),
        (exact_knn, "knn_mean_distances_exact", ("launches", "large_k_launches")),
    ) for counter in counters]


def _add(counters, deltas) -> None:
    # through the module's name: a probe may have put a recorder in its place
    for (mod, name, counter), d in zip(counters, deltas):
        fn = getattr(mod, name)
        setattr(fn, counter, getattr(fn, counter) + d)


def _read(counters):
    return [getattr(getattr(mod, name), counter) for mod, name, counter in counters]


def graphable(tensors) -> bool:
    """Whether a call on ``tensors`` can be captured: each a plain CUDA
    tensor (not fake, meta or a subclass), and no torch.export or
    torch.compile trace running."""
    return not torch.compiler.is_compiling() and all(
        type(t) is torch.Tensor and t.is_cuda for t in tensors)


class Captured:
    """``fn(*inputs, *args)`` captured as one CUDA graph on the inputs'
    device, into a private memory pool. ``fn`` returns an object with
    ``map`` (``FrameOutputs``). A call copies its inputs into the graph's
    static ones, replays, and returns the outputs cloned out of the pool,
    except an output that is a static input: that is the caller's own
    tensor, as given."""

    def __init__(self, fn, inputs, *args):
        device = inputs[0].device
        with torch.inference_mode(False):  # written by calls in and out of inference mode
            self.inputs = [torch.empty_like(t) for t in inputs]
        self.counters = _counters()
        before = _read(self.counters)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.no_grad(), torch.cuda.graph(
                self.graph, stream=torch.cuda.Stream(device), capture_error_mode="thread_local"):
            self.outputs = fn(*self.inputs, *args)
        self.launches = [a - b for a, b in zip(_read(self.counters), before)]
        _add(self.counters, [-d for d in self.launches])  # the capture launched nothing

    def __call__(self, inputs):
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        self.graph.replay()
        _add(self.counters, self.launches)
        own = {id(static): t for static, t in zip(self.inputs, inputs)}
        return self.outputs.map(lambda v: own[id(v)] if id(v) in own else v.clone())


class Cache:
    """Captured graphs by key and the keys seen once, at most ``size`` of
    each, least recently used first out."""

    def __init__(self, size: int = SIZE):
        self.size = size
        self.graphs: OrderedDict = OrderedDict()
        self.seen: OrderedDict = OrderedDict()

    def get(self, key):
        """The graph of ``key`` (now the most recently used), or None."""
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
        return graph

    def seen_before(self, key) -> bool:
        """Whether ``key`` was seen once before; marks it seen if not."""
        if key in self.seen:
            del self.seen[key]
            return True
        self.seen[key] = None
        if len(self.seen) > self.size:
            self.seen.popitem(last=False)
        return False

    def put(self, key, graph) -> None:
        self.graphs[key] = graph
        if len(self.graphs) > self.size:
            self.graphs.popitem(last=False)
