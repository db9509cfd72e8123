"""Structured serve-stack observability: the typed event stream
(:mod:`.trace`), log2 histograms (:mod:`.hist`) and per-tick phase timing
(:mod:`.timing`). Copies of ``repro/serve/obs``; the Chrome-trace export
(``obs/chrome.py``) is not ported yet (ROADMAP A11)."""

from repro_torch.serve.obs.hist import Log2Histogram, default_histograms
from repro_torch.serve.obs.timing import (TICK_SEGMENTS, TickTimer, TickTiming,
                                          profiling_enabled)
from repro_torch.serve.obs.trace import (EVENT_KINDS, FOLDED_COUNTERS, Event,
                                         EventTrace, fold_counters)

__all__ = [
    "EVENT_KINDS", "FOLDED_COUNTERS", "Event", "EventTrace",
    "fold_counters", "Log2Histogram", "default_histograms",
    "TICK_SEGMENTS", "TickTimer", "TickTiming", "profiling_enabled",
]
