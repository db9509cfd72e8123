"""Per-tick phase timing: where does an engine tick spend its wall time?

Each engine tick is split into four segments — ``admit`` (expiry +
autotune + admission/prefill), ``schedule`` (pass packing + lazy page
provisioning), ``step`` (the device decode step), ``finalize`` (commit,
token bookkeeping, reclaim) — timed with ``time.perf_counter`` and
recorded as a :class:`TickTiming`. The Chrome-trace export renders these
as nested spans inside each tick, and their sum accounts for the tick's
wall time within bookkeeping overhead (asserted by the ``obs`` suite).

With ``REPRO_PROFILE=1`` the same structure is mirrored into the PyTorch
profiler: the tick and each segment become ``torch.profiler.record_function``
ranges (``serve_tick``, ``serve.<segment>``), so a ``torch.profiler`` trace
lines host-side phases up against device activity. The env var is read at
call time (not import time) and the default path stays annotation-free.
Copy of ``repro/serve/obs/timing.py`` with the JAX profiler annotations
replaced.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass

#: Canonical segment order within one engine tick.
TICK_SEGMENTS = ("admit", "schedule", "step", "finalize")


def profiling_enabled() -> bool:
    return os.environ.get("REPRO_PROFILE") == "1"


@dataclass(frozen=True)
class TickTiming:
    """Wall-clock breakdown of one engine tick.

    ``segments`` is a tuple of ``(name, start, end)`` perf_counter
    triples in execution order; ``t0``/``t1`` bracket the whole tick.
    """

    tick: int
    t0: float
    t1: float
    segments: tuple

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def segment_s(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, start, end in self.segments:
            out[name] = out.get(name, 0.0) + (end - start)
        return out

    @property
    def overhead_s(self) -> float:
        """Tick time not attributed to any segment (bookkeeping between
        phases) — small by construction, bounded by the obs tests."""
        return self.duration_s - sum(end - start
                                     for _, start, end in self.segments)


class TickTimer:
    """Accumulates one tick's :class:`TickTiming`.

    Usage::

        timer = TickTimer(tick)
        with timer.phase("admit"):
            ...
        with timer.phase("step"):
            ...
        metrics.on_tick_timing(timer.finish())
    """

    def __init__(self, tick: int):
        self.tick = tick
        self._segments: list[tuple[str, float, float]] = []
        self._step_ann = None
        if profiling_enabled():  # pragma: no cover - needs profiler run
            from torch.profiler import record_function
            self._step_ann = record_function(f"serve_tick {tick}")
            self._step_ann.__enter__()
        self.t0 = time.perf_counter()

    @contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            if profiling_enabled():  # pragma: no cover - needs profiler
                from torch.profiler import record_function
                with record_function(f"serve.{name}"):
                    yield
            else:
                yield
        finally:
            self._segments.append((name, start, time.perf_counter()))

    def finish(self) -> TickTiming:
        t1 = time.perf_counter()
        if self._step_ann is not None:  # pragma: no cover - profiler run
            self._step_ann.__exit__(None, None, None)
            self._step_ann = None
        return TickTiming(self.tick, self.t0, t1, tuple(self._segments))
