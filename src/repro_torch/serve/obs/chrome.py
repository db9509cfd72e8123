# Copy of repro/serve/obs/chrome.py (framework-free).
"""Chrome-trace (Perfetto) export of a serve run (DESIGN.md §13).

``to_chrome_trace`` renders a :class:`~repro.serve.metrics.ServeMetrics`
— its event stream plus per-tick phase timings — into the Trace Event
Format JSON that ``chrome://tracing`` / https://ui.perfetto.dev load
directly:

* **pid 1 "engine"**: one complete (``ph: "X"``) span per tick, with the
  admit/schedule/step/finalize segments nested inside. When real
  :class:`TickTiming` records exist their perf_counter intervals are
  used verbatim, so the tick spans sum to ``wall_s``; simulator runs
  (no wall clock) get uniform synthetic ticks of ``synthetic_tick_s``.
* **pid 2 "requests"**: one thread per request uid carrying its
  lifecycle spans — ``queued`` (arrival→admit), ``FULL`` / ``COND``
  decode phases split at the phase-transition event, ``preempted`` gaps
  (preempt→resume), closed by completion or expiry. Span boundaries are
  tick boundaries, so request spans nest inside engine tick spans.

All timestamps are microseconds relative to the first tick, per the
trace-event spec.
"""

from __future__ import annotations

import json


def _span(name, cat, ts_s, end_s, pid, tid, args=None) -> dict:
    ev = {"name": name, "cat": cat, "ph": "X",
          "ts": round(ts_s * 1e6, 3),
          "dur": round(max(0.0, end_s - ts_s) * 1e6, 3),
          "pid": pid, "tid": tid}
    if args:
        ev["args"] = args
    return ev


def _tick_bounds(metrics, synthetic_tick_s: float) -> dict[int, tuple]:
    """tick -> (start_s, end_s) relative to the first tick."""
    timings = getattr(metrics, "tick_timings", None) or []
    if timings:
        base = timings[0].t0
        return {t.tick: (t.t0 - base, t.t1 - base) for t in timings}
    ticks = sorted({ev.tick for ev in metrics.trace if ev.kind == "tick"})
    return {t: (i * synthetic_tick_s, (i + 1) * synthetic_tick_s)
            for i, t in enumerate(ticks)}


def to_chrome_trace(metrics, *, synthetic_tick_s: float = 1e-3,
                    replica: int | None = None) -> dict:
    """Render one metrics object. ``replica`` relabels the two processes
    for fleet rendering: replica ``r`` exports as pids ``2r+1`` /
    ``2r+2`` named ``engine[r]`` / ``requests[r]``, so N replicas merge
    into one timeline with no pid collisions. ``replica=None`` keeps the
    historical pid 1/2 layout byte-for-byte (single-replica ``--trace-out``
    files are unchanged)."""
    bounds = _tick_bounds(metrics, synthetic_tick_s)
    pid_e = 1 if replica is None else 2 * replica + 1
    pid_r = 2 if replica is None else 2 * replica + 2
    tag = "" if replica is None else f"[{replica}]"

    def start_of(t):
        if t in bounds:
            return bounds[t][0]
        if not bounds:
            return 0.0
        return bounds[min(bounds)][0] if t < min(bounds) \
            else bounds[max(bounds)][1]

    def end_of(t):
        if t in bounds:
            return bounds[t][1]
        return start_of(t)

    out = [{"ph": "M", "name": "process_name", "pid": pid_e,
            "args": {"name": f"engine{tag}"}},
           {"ph": "M", "name": "process_name", "pid": pid_r,
            "args": {"name": f"requests{tag}"}}]

    # --- pid 1: engine ticks + phase segments -------------------------
    timings = {t.tick: t for t in (getattr(metrics, "tick_timings", None)
                                   or [])}
    for tick in sorted(bounds):
        t0, t1 = bounds[tick]
        tick_ev = next((ev for ev in metrics.trace
                        if ev.kind == "tick" and ev.tick == tick), None)
        args = dict(tick_ev.data) if tick_ev is not None else {}
        out.append(_span(f"tick {tick}", "tick", t0, t1, pid_e, 1,
                         args))
        timing = timings.get(tick)
        if timing is not None:
            base = timing.t0 - t0
            for name, s, e in timing.segments:
                out.append(_span(name, "tick_phase",
                                 s - base, e - base, pid_e, 1))

    # --- pid 2: per-request lifecycle spans ---------------------------
    tids: dict[str, int] = {}
    open_span: dict[str, tuple[str, float]] = {}
    n_request_spans = 0

    def tid_of(uid):
        if uid not in tids:
            tids[uid] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": pid_r,
                        "tid": tids[uid], "args": {"name": uid}})
        return tids[uid]

    def close(uid, end_s, args=None):
        nonlocal n_request_spans
        opened = open_span.pop(uid, None)
        if opened is None:
            return
        name, ts_s = opened
        out.append(_span(name, "request", ts_s, end_s, pid_r,
                         tid_of(uid), args))
        n_request_spans += 1

    for ev in metrics.trace:
        if ev.uid is None:
            continue
        if ev.kind == "arrival":
            open_span[ev.uid] = ("queued", start_of(ev.tick))
        elif ev.kind == "reject":
            close(ev.uid, start_of(ev.tick), {"rejected": True})
        elif ev.kind == "admit":
            close(ev.uid, start_of(ev.tick))
            mode = "FULL" if ev.get("full_steps", 0) > 0 else "COND"
            open_span[ev.uid] = (mode, start_of(ev.tick))
        elif ev.kind == "phase":
            close(ev.uid, end_of(ev.tick))
            open_span[ev.uid] = ("COND", end_of(ev.tick))
        elif ev.kind == "preempt":
            close(ev.uid, start_of(ev.tick))
            open_span[ev.uid] = ("preempted", start_of(ev.tick))
        elif ev.kind == "swap_out":
            # the victim's gap is a "swapped" span (KV parked on host),
            # visually distinct from a plain recompute-bound "preempted"
            close(ev.uid, start_of(ev.tick))
            open_span[ev.uid] = ("swapped", start_of(ev.tick))
        elif ev.kind == "host_evict":
            # LRU pressure demoted the checkpoint: back to the recompute
            # path (expiry-driven evicts find the span already closed)
            if open_span.get(ev.uid, ("",))[0] == "swapped":
                close(ev.uid, start_of(ev.tick), {"host_evicted": True})
                open_span[ev.uid] = ("preempted", start_of(ev.tick))
        elif ev.kind == "swap_in":
            close(ev.uid, start_of(ev.tick),
                  {"restored_pages": ev.get("pages")})
        elif ev.kind == "resume":
            close(ev.uid, start_of(ev.tick))
            mode = "FULL" if ev.get("full", 0) else "COND"
            open_span[ev.uid] = (mode, start_of(ev.tick))
        elif ev.kind == "complete":
            close(ev.uid, end_of(ev.tick), {"passes": ev.get("passes")})
        elif ev.kind == "expire":
            close(ev.uid, end_of(ev.tick), {"expired": True})

    # Still-open spans (in-flight at export time) close at the last tick.
    horizon = max((b[1] for b in bounds.values()), default=0.0)
    for uid in sorted(open_span):
        close(uid, horizon, {"in_flight": True})

    summary = metrics.summary() if hasattr(metrics, "summary") else {}
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "request_spans": n_request_spans,
            "ticks": len(bounds),
            "wall_s": summary.get("wall_s", 0.0),
            "passes_saved": summary.get("passes_saved", 0),
            "uncond_ticks_elided": summary.get("uncond_ticks_elided", 0),
            "swap_outs": summary.get("swap_outs", 0),
            "swap_ins": summary.get("swap_ins", 0),
            "prefix_hits": summary.get("prefix_hits", 0),
            "recompute_passes_avoided":
                summary.get("recompute_passes_avoided", 0),
            "events_emitted": metrics.trace.emitted,
            "events_dropped": metrics.trace.dropped,
        },
    }


def fleet_chrome_trace(metrics_list, *,
                       synthetic_tick_s: float = 1e-3) -> dict:
    """Merge N replicas' traces into one timeline document.

    Replica ``r`` renders under pids ``2r+1``/``2r+2`` (engine/request
    processes, named ``engine[r]``/``requests[r]``), so Perfetto shows
    the whole fleet side by side; ``otherData`` counters are summed
    across replicas (``wall_s`` too — fleet wall time is aggregate
    device time, replicas being independent hosts)."""
    events: list = []
    other: dict = {}
    for r, metrics in enumerate(metrics_list):
        doc = to_chrome_trace(metrics, synthetic_tick_s=synthetic_tick_s,
                              replica=r)
        events.extend(doc["traceEvents"])
        for k, v in doc["otherData"].items():
            other[k] = other.get(k, 0) + v
    other["replicas"] = len(metrics_list)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def write_chrome_trace(metrics, path, *,
                       synthetic_tick_s: float = 1e-3) -> dict:
    """Render and write the trace JSON; returns the document."""
    doc = to_chrome_trace(metrics, synthetic_tick_s=synthetic_tick_s)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc
