# Copy of repro/serve/obs/hist.py (framework-free).
"""Fixed-bucket log2 latency histograms with SLO helpers (DESIGN.md §13).

The serve stack needs percentiles, not means: the paper's latency claims
are wall-clock reductions and ROADMAP item 1 asks for SLO-attainment
curves, both tail statements. A :class:`Log2Histogram` is a fixed array
of ``n_buckets`` counts whose bucket ``i`` covers ``(base·2^(i-1),
base·2^i]`` (bucket 0 is ``(-inf, base]``, the last bucket absorbs
overflow), so:

* recording is O(1) and allocation-free — safe inside the engine tick;
* any reported percentile ``P`` brackets the exact quantile ``q`` as
  ``q <= P <= max(base, 2q)`` (one bucket of relative error, pinned by
  the ``obs`` property tests);
* two histograms with the same layout merge by adding counts — the
  fleet-router aggregation path (ROADMAP item 1) with no raw samples
  shipped between replicas.
"""

from __future__ import annotations

import math


class Log2Histogram:
    """Log2-bucketed histogram over non-negative samples.

    ``base`` is the resolution floor: everything ``<= base`` lands in
    bucket 0. Tick-denominated latencies use ``base=1`` (one tick);
    tick wall durations use ``base=1e-4`` (100µs).
    """

    __slots__ = ("base", "n_buckets", "counts", "total")

    def __init__(self, base: float = 1.0, n_buckets: int = 32):
        if base <= 0 or n_buckets < 2:
            raise ValueError((base, n_buckets))
        self.base = float(base)
        self.n_buckets = n_buckets
        self.counts = [0] * n_buckets
        self.total = 0

    def bucket_of(self, value: float) -> int:
        if value <= self.base:
            return 0
        idx = math.ceil(math.log2(value / self.base))
        return min(idx, self.n_buckets - 1)

    def upper_edge(self, bucket: int) -> float:
        """Inclusive upper bound of ``bucket`` (conservative: the last
        bucket's true range is unbounded)."""
        return self.base * (2 ** bucket)

    def record(self, value: float) -> None:
        if value < 0:
            raise ValueError(f"negative sample {value!r}")
        self.counts[self.bucket_of(value)] += 1
        self.total += 1

    def merge(self, other: "Log2Histogram") -> "Log2Histogram":
        """Fold ``other`` into self; layouts must match exactly."""
        if (other.base, other.n_buckets) != (self.base, self.n_buckets):
            raise ValueError("histogram layouts differ: "
                             f"{(self.base, self.n_buckets)} vs "
                             f"{(other.base, other.n_buckets)}")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.total += other.total
        return self

    def percentile(self, p: float) -> float | None:
        """Upper bucket edge covering the ``p``-th percentile sample
        (``None`` when empty). Over-reports by at most one bucket."""
        if not 0 < p <= 100:
            raise ValueError(p)
        if self.total == 0:
            return None
        rank = max(1, math.ceil(p / 100.0 * self.total))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.upper_edge(i)
        return self.upper_edge(self.n_buckets - 1)

    def slo_attainment(self, threshold: float) -> float:
        """Fraction of samples provably ``<= threshold`` (1.0 when
        empty). Conservative: only buckets whose upper edge clears the
        threshold count, so the true attainment is >= the reported one."""
        if self.total == 0:
            return 1.0
        ok = sum(c for i, c in enumerate(self.counts)
                 if self.upper_edge(i) <= threshold)
        return ok / self.total

    def summary(self) -> dict:
        return {"count": self.total,
                "p50": self.percentile(50),
                "p95": self.percentile(95),
                "p99": self.percentile(99)}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        s = self.summary()
        return (f"Log2Histogram(base={self.base}, n={self.total}, "
                f"p50={s['p50']}, p95={s['p95']}, p99={s['p99']})")


def default_histograms() -> dict[str, Log2Histogram]:
    """The serve stack's standard latency set, tick-denominated except
    for wall-clock tick duration: ttft/tpot/queue_wait in ticks
    (base=1 tick), tick_s in seconds (base=100µs)."""
    return {
        "ttft": Log2Histogram(base=1.0),
        "tpot": Log2Histogram(base=1.0),
        "queue_wait": Log2Histogram(base=1.0),
        "tick_s": Log2Histogram(base=1e-4),
    }
