"""CUDA graphs for the port's fixed-shape steps: the counterpart of the
reference's ``lax.scan`` decode segment and its jitted ragged serve step.

A step is a function of no arguments that reads static input tensors
(whose addresses never change) and returns its outputs. ``capture`` runs it
once eagerly on a side stream, which is the caller's first real step (its
effects and outputs count), and which also loads the kernel library and
every kernel and cuBLAS handle the step uses, so that nothing loads inside
the capture; then it captures the step once into a graph whose memory
comes from a pool that the caller's graphs share. ``StepGraph.replay``
runs it again: the same launches on the same addresses, with the inputs
rewritten in place between replays. A capture that fails raises; there is
no eager fallback.

Launch bookkeeping. The kernels' wrappers count a launch (``LAUNCHES``,
``decode_attention.LAUNCH_FORMS`` by form and ``rmsnorm.LAUNCH_SHAPES`` by
shape) when they are called, and inside a
capture they are called once and launch nothing. So a capture records the
counts' change (``launch_delta``), restores them, and each replay adds
that change once (``add_launches``): the counts keep meaning the launches
that the card ran.
"""

from __future__ import annotations

import time

import torch

from repro_torch.kernels import build, cfg_combine, decode_attention, flash_attention, \
    paged_decode_attention, rmsnorm

# every counter of kernel launches, in a fixed order
COUNTERS = (cfg_combine.LAUNCHES, decode_attention.LAUNCHES, decode_attention.LAUNCH_FORMS,
            flash_attention.LAUNCHES, paged_decode_attention.LAUNCHES,
            paged_decode_attention.SHARD_LAUNCHES, rmsnorm.LAUNCHES, rmsnorm.LAUNCH_SHAPES)


def snapshot(counters=COUNTERS) -> tuple[dict, ...]:
    """A copy of each counter."""
    return tuple(dict(c) for c in counters)


def launch_delta(before, after) -> tuple[dict, ...]:
    """Each counter's change from ``before`` to ``after`` (both
    ``snapshot``s), its zero entries dropped."""
    out = []
    for b, a in zip(before, after):
        out.append({k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)})
    return tuple(out)


def add_launches(counters, delta, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counters, in place."""
    for c, d in zip(counters, delta):
        for k, n in d.items():
            c[k] = c.get(k, 0) + n * times


def restore(counters, saved) -> None:
    """Set each counter back to its ``snapshot``."""
    for c, s in zip(counters, saved):
        c.clear()
        c.update(s)


def pool():
    """A handle of a new private memory pool, for the graphs of one loop."""
    return torch.cuda.graph_pool_handle()


class StepGraph:
    """A captured step: ``outputs`` are its static output tensors (rewritten
    by every replay), ``launches`` the kernel launches of one replay,
    ``capture_s`` the wall seconds of the warm-up and the capture (after
    the work queued before them has finished), and
    ``pool_bytes`` the device memory the capture reserved."""

    def __init__(self, graph, outputs, launches, capture_s: float, pool_bytes: int):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes

    def replay(self):
        """Run the step again. -> its static outputs."""
        self.graph.replay()
        add_launches(COUNTERS, self.launches)
        return self.outputs


def capture(step, mempool=None) -> tuple[StepGraph, object]:
    """Run ``step`` once eagerly on a side stream, then capture it into a
    graph drawing on ``mempool`` (a ``pool()`` handle; None: a pool of its
    own). -> (the graph, the eager run's outputs)."""
    build.load()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    before = snapshot()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=mempool):
            outputs = step()
    finally:
        after = snapshot()
        restore(COUNTERS, before)
    torch.cuda.synchronize()
    g = StepGraph(graph, outputs, launch_delta(before, after), time.perf_counter() - t0,
                  torch.cuda.memory_reserved() - reserved)
    return g, first
