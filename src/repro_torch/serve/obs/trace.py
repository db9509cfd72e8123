# Copy of repro/serve/obs/trace.py (framework-free).
"""Typed serve-stack event trace: the observability substrate (DESIGN.md §13).

Every state change the engine or the offline simulator makes — arrival,
admission, page growth, prefix sharing, copy-on-write, reclaim,
preemption, resume, FULL->COND phase transition, token emission,
completion, expiry, step launch/compile — is one :class:`Event` in a
bounded ring buffer. Two invariants the ``obs`` suite pins:

* **counters are a fold over the stream**: every running counter on
  :class:`~repro.serve.metrics.ServeMetrics` equals
  :func:`fold_counters` applied to the events (when nothing rotated out
  of the ring), so the counters can never drift from the trace;
* **engine == sim, event for event**: on the same trace (with early-EOS
  stopping off) the real engine and ``repro.serve.sim`` emit identical
  event *keys* — the PR-4 decision-procedure discipline extended from a
  handful of counters to the whole observable history.

Events carry two clocks: the deterministic ``tick`` (what the equality
contract compares) and a monotonic ``t_wall`` stamped at emission (what
the Chrome-trace export renders; excluded from :meth:`Event.key` because
wall time is inherently nondeterministic).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

# The closed event vocabulary. ``emit`` rejects anything else so a typo'd
# kind fails loudly instead of silently forking the schema.
EVENT_KINDS = (
    "arrival",        # request entered the front door (uid)
    "reject",         # admission control refused it (uid)
    "admit",          # prefilled into the arena (uid; total_steps, full_steps)
    "grow",           # lazy on-demand page grant (uid; pages)
    "share",          # uncond prefix pages served from the canonical copy
    "cow",            # shared page detached copy-on-write (uid)
    "cache_evict",    # prefix-registry entry evicted under pool pressure
    "reclaim",        # uncond pages returned mid-flight (uid; pages)
    "preempt",        # in-flight request evicted back to the queue (uid)
    "resume",         # preempted request re-admitted, KV rebuilt (uid; full)
    "phase",          # plan crossed FULL -> COND (uid)
    "policy_switch",  # dynamic guidance policy dropped the uncond stream
                      # before the bound plan's boundary (uid; step, elided)
    "token",          # one token emitted (uid; cond = COND-mode step)
    "complete",       # request finished (uid; passes)
    "expire",         # deadline passed while queued (uid)
    "step_launch",    # one decode-step dispatch hit the device
    "step_compile",   # decode step lowered + compiled (jit-cache miss)
    "swap_out",       # victim's KV pages copied to the host tier (uid; pages)
    "swap_in",        # resume restored KV from host — zero passes (uid; pages)
    "host_evict",     # host-tier checkpoint dropped: LRU pressure or the
                      # owning resume checkpoint expired (uid; pages)
    "prefix_hit",     # cond prompt KV served from the content cache (uid;
                      # pages) — admission skips the prefill forward
    "prefix_miss",    # content-cache lookup missed; normal prefill (uid)
    "occupancy",      # page occupancy reached a new high-water mark (pages)
    "autotune",       # pass budget (re)derived from the roofline (budget)
    "tick",           # end-of-tick record (n_full, n_cond, budget, active,
                      # queue_depth, pages_in_use)
)


@dataclass(frozen=True)
class Event:
    """One observed state change.

    ``data`` is a sorted tuple of ``(name, value)`` pairs — hashable and
    deterministic, so whole streams compare with ``==`` over
    :meth:`key`. ``seq`` is the emission index (survives ring rotation:
    the first retained event of a trace that dropped ``d`` events has
    ``seq == d``); ``t_wall`` is ``time.perf_counter()`` at emission.
    """

    kind: str
    tick: int
    uid: str | None
    data: tuple
    seq: int
    t_wall: float

    def key(self) -> tuple:
        """The deterministic identity — everything but ``seq``/``t_wall``
        — that the engine==sim equality contract compares."""
        return (self.kind, self.tick, self.uid, self.data)

    def get(self, name: str, default=None):
        for k, v in self.data:
            if k == name:
                return v
        return default


class EventTrace:
    """Bounded ring buffer of :class:`Event` with drop accounting.

    ``capacity`` bounds resident events; older events rotate out first
    and every rotation is counted (``dropped == emitted - len(self)``),
    so a consumer can always tell a complete stream from a truncated one
    — :func:`fold_counters` over a trace that dropped events is a fold
    over a suffix, and the ``obs`` tests only assert counter equality at
    ``dropped == 0``.
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(capacity)
        self.capacity = capacity
        self.emitted = 0
        self.dropped = 0
        self._buf: deque[Event] = deque()

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self):
        return iter(self._buf)

    def emit(self, kind: str, tick: int, uid: str | None = None,
             **data) -> Event:
        """Append one event; returns it. ``data`` values must be plain
        scalars (they end up in Chrome-trace JSON ``args`` verbatim)."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}")
        ev = Event(kind, tick, uid, tuple(sorted(data.items())),
                   self.emitted, time.perf_counter())
        self.emitted += 1
        self._buf.append(ev)
        if len(self._buf) > self.capacity:
            self._buf.popleft()
            self.dropped += 1
        return ev

    def events(self) -> list[Event]:
        return list(self._buf)

    def keys(self) -> list[tuple]:
        """Deterministic stream identity — what engine==sim compares."""
        return [ev.key() for ev in self._buf]


#: Counter names fold_counters reconstructs — exactly the running
#: counters ServeMetrics keeps, so the two can be compared key by key.
FOLDED_COUNTERS = (
    "ticks", "denoiser_passes", "prefill_passes", "tokens_emitted",
    "completed", "expired", "rejected", "pages_reclaimed", "pages_grown",
    "shared_page_hits", "cow_copies", "cache_evictions", "preemptions",
    "resumes", "step_launches", "step_compiles", "uncond_ticks_elided",
    "swap_outs", "swap_ins", "host_evictions", "prefix_hits",
    "prefix_misses", "recompute_passes_avoided", "policy_switches",
    "uncond_passes_elided_dynamic",
)


def fold_counters(events) -> dict:
    """Reconstruct the running counters from an event stream.

    The metrics-integrity contract: for any :class:`ServeMetrics` whose
    ring buffer has not rotated (``trace.dropped == 0``),
    ``fold_counters(metrics.trace) == {k: getattr(metrics, k) ...}`` for
    every name in :data:`FOLDED_COUNTERS`. Counters are a *view* of the
    stream, never independent state that can drift from it.
    """
    c = dict.fromkeys(FOLDED_COUNTERS, 0)
    for ev in events:
        k = ev.kind
        if k == "tick":
            c["ticks"] += 1
            c["denoiser_passes"] += 2 * ev.get("n_full") + ev.get("n_cond")
        elif k == "token":
            c["tokens_emitted"] += 1
            c["uncond_ticks_elided"] += ev.get("cond", 0)
        elif k == "admit":
            # a content-cache hit admits with zero prefill passes — the
            # cached-logits replay produces token 0 without a forward
            if not ev.get("cached", 0):
                c["prefill_passes"] += 2
        elif k == "resume":
            c["resumes"] += 1
            # restore-from-host rebuilds KV by copy, not by recompute
            if not ev.get("from_host", 0):
                c["prefill_passes"] += 2
        elif k == "complete":
            c["completed"] += 1
        elif k == "expire":
            c["expired"] += 1
        elif k == "reject":
            c["rejected"] += 1
        elif k == "reclaim":
            c["pages_reclaimed"] += ev.get("pages")
        elif k == "grow":
            c["pages_grown"] += ev.get("pages")
        elif k == "share":
            c["shared_page_hits"] += ev.get("pages")
        elif k == "cow":
            c["cow_copies"] += 1
        elif k == "cache_evict":
            c["cache_evictions"] += 1
        elif k == "preempt":
            c["preemptions"] += 1
        elif k == "step_launch":
            c["step_launches"] += 1
        elif k == "step_compile":
            c["step_compiles"] += 1
        elif k == "swap_out":
            c["swap_outs"] += 1
        elif k == "swap_in":
            c["swap_ins"] += 1
            c["recompute_passes_avoided"] += 2
        elif k == "host_evict":
            c["host_evictions"] += 1
        elif k == "prefix_hit":
            c["prefix_hits"] += 1
            c["recompute_passes_avoided"] += 2
        elif k == "prefix_miss":
            c["prefix_misses"] += 1
        elif k == "policy_switch":
            c["policy_switches"] += 1
            c["uncond_passes_elided_dynamic"] += ev.get("elided")
        # arrival / phase / occupancy / autotune carry no counter
    return c
