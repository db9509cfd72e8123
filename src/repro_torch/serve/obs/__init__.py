"""Structured serve-stack observability: the typed event stream
(:mod:`.trace`), log2 histograms (:mod:`.hist`), per-tick phase timing
(:mod:`.timing`) and the Chrome-trace (Perfetto) JSON export
(:mod:`.chrome`). Copies of ``repro/serve/obs``."""

from repro_torch.serve.obs.chrome import (fleet_chrome_trace, to_chrome_trace,
                                          write_chrome_trace)
from repro_torch.serve.obs.hist import Log2Histogram, default_histograms
from repro_torch.serve.obs.timing import (TICK_SEGMENTS, TickTimer, TickTiming,
                                          profiling_enabled)
from repro_torch.serve.obs.trace import (EVENT_KINDS, FOLDED_COUNTERS, Event,
                                         EventTrace, fold_counters)

__all__ = [
    "EVENT_KINDS", "FOLDED_COUNTERS", "Event", "EventTrace",
    "fold_counters", "Log2Histogram", "default_histograms",
    "TICK_SEGMENTS", "TickTimer", "TickTiming", "profiling_enabled",
    "fleet_chrome_trace", "to_chrome_trace", "write_chrome_trace",
]
