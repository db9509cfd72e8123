# Copy of repro/serve/metrics.py (framework-free).
"""Serving metrics: event stream, histograms, and latency accounting.

Shared by the real engine (``repro.serve.engine``) and the offline
simulator (``repro.serve.sim``) so policy numbers measured in simulation
are directly comparable to numbers measured against the model.

The metrics are layered on the ``repro.serve.obs`` event
trace (DESIGN.md §13): every ``on_*`` hook both updates its running
counter *and* emits a typed :class:`~repro.serve.obs.Event`, and the
``obs`` tests pin that the counters equal ``fold_counters`` over the
stream — counters are a view of the trace, not parallel state. The
engine and simulator emit identical event streams on the same trace
(asserted event-for-event).

Invariants the tests pin:

* ``passes`` recorded per tick counts the *actual* scheduled work
  (2·n_full + n_cond), never the bucket-padded compile shape;
* over completed requests, ``denoiser_passes`` equals
  ``sum(plan.denoiser_passes())`` exactly (when early-EOS stopping is off)
  — the engine's measured work is the plans' declared work;
* per-request ``passes_saved == full_cfg_passes - passes`` — the paper's
  guidance saving measured per request, not inferred from plans.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.serve.obs.hist import Log2Histogram, default_histograms
from repro_torch.serve.obs.timing import TickTiming
from repro_torch.serve.obs.trace import EventTrace


@dataclass(frozen=True)
class TickRecord:
    tick: int
    n_full: int
    n_cond: int
    passes: int            # 2*n_full + n_cond, pre-padding
    budget: int
    active: int            # requests resident in slots
    queue_depth: int
    pages_in_use: int = 0  # paged arena only: granted pages this tick
    bytes_in_use: int = 0  # pages_in_use priced in HBM bytes at the pool's
                           # kv_dtype (page counts are not comparable across
                           # dtypes; bytes are — DESIGN.md §11)


@dataclass
class RequestTimeline:
    arrival: float
    admitted: float | None = None
    first_token: float | None = None      # tick of first emitted token
    completed: float | None = None
    expired_at: float | None = None       # deadline passed while queued
    preempted_at: float | None = None     # open preemption gap, if any
    gap_ticks: float = 0.0                # closed preempt->resume dead time
    n_preempts: int = 0
    tokens: int = 0
    passes: int = 0
    total_steps: int = 0                  # plan.total_steps at admission
    full_steps: int = 0                   # FULL (2-pass) steps in the plan
    uncond_elided: int = 0                # COND-mode tokens: uncond passes
                                          # the plan skipped for this request

    @property
    def ttft(self) -> float | None:
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def tpot(self) -> float | None:
        """Mean ticks per output token after the first, with
        preempt->resume gaps subtracted — preempted dead time is queueing,
        not decode speed (it is reported separately as ``gap_ticks``)."""
        if self.completed is None or self.first_token is None or self.tokens < 2:
            return None
        return (self.completed - self.first_token - self.gap_ticks) \
            / (self.tokens - 1)

    @property
    def queue_wait(self) -> float | None:
        """Ticks from arrival to first admission."""
        if self.admitted is None:
            return None
        return self.admitted - self.arrival

    @property
    def full_cfg_passes(self) -> int:
        """Denoiser passes classic CFG would spend: 2 per plan step."""
        return 2 * self.total_steps

    @property
    def passes_saved(self) -> int:
        """``full_cfg_passes - passes`` — the paper's per-request saving
        (equals the COND steps in the plan when the request ran to
        completion without early EOS)."""
        return self.full_cfg_passes - self.passes

    @property
    def terminal(self) -> bool:
        return self.completed is not None or self.expired_at is not None


@dataclass
class ServeMetrics:
    records: list[TickRecord] = field(default_factory=list)
    max_records: int = 65536     # records beyond this rotate out (aggregates
                                 # below are running counters, never trimmed)
    timelines: dict[str, RequestTimeline] = field(default_factory=dict)
    trace: EventTrace = field(default_factory=EventTrace)
    hists: dict[str, Log2Histogram] = field(default_factory=default_histograms)
    tick_timings: list[TickTiming] = field(default_factory=list)
    max_timings: int = 65536
    denoiser_passes: int = 0     # decode passes (plan units)
    prefill_passes: int = 0      # prefill stream passes (2 per admission)
    pages_reclaimed: int = 0     # paged arena: pages returned before
                                 # completion (COND-transition reclaim)
    peak_pages_in_use: int = 0   # paged arena: high-water page occupancy
    peak_bytes_in_use: int = 0   # byte-true high-water mark: sampled as
                                 # pages_in_use * page_bytes at the *current*
                                 # page_bytes, so it stays honest even if the
                                 # pool's dtype (and page size in bytes)
                                 # changes mid-run — deriving it from
                                 # peak_pages_in_use afterwards would price
                                 # the whole peak at the last dtype
    page_bytes: int = 0          # HBM bytes one page pins (dtype-aware:
                                 # int8 pages are ~2x denser than bf16);
                                 # 0 until the engine/sim installs it
    pages_grown: int = 0         # lazy reservation: pages granted on demand
                                 # at tick boundaries (vs reserved up front)
    shared_page_hits: int = 0    # uncond prompt-prefix pages served by the
                                 # canonical copy instead of a fresh grant
    cow_copies: int = 0          # shared pages detached copy-on-write
    cache_evictions: int = 0     # prefix-registry entries evicted under
                                 # pool pressure to un-share/free pages
    preemptions: int = 0         # in-flight requests evicted back to queue
    resumes: int = 0             # preempted requests re-admitted
    step_launches: int = 0       # decode step dispatches (one per non-empty
                                 # tick in ragged mode; per phase-group in
                                 # signature mode)
    step_compiles: int = 0       # decode step lower+compile events — the
                                 # number the ragged step exists to pin at
                                 # one per model (signature mode pays one
                                 # per padded occupancy bucket)
    tokens_emitted: int = 0
    completed: int = 0
    expired: int = 0
    rejected: int = 0
    uncond_ticks_elided: int = 0  # COND-mode tokens across all requests:
                                  # uncond denoiser passes selective
                                  # guidance elided (the paper's saving,
                                  # in pass units)
    swap_outs: int = 0           # victim KV checkpoints copied to host tier
    swap_ins: int = 0            # resumes restored from host (zero passes)
    host_evictions: int = 0      # host checkpoints dropped (LRU pressure or
                                 # the owning resume checkpoint expired)
    prefix_hits: int = 0         # content-cache hits: cond prompt KV shared,
                                 # prefill forward skipped (DESIGN.md §14)
    prefix_misses: int = 0       # content-cache lookups that prefilled
    recompute_passes_avoided: int = 0  # prefill passes the host tier and the
                                       # content cache together elided (2 per
                                       # swap_in, 2 per prefix_hit)
    policy_switches: int = 0     # dynamic-policy FULL->COND switches fired
                                 # before the bound plan's boundary
    uncond_passes_elided_dynamic: int = 0  # uncond passes those switches
                                           # dropped beyond the static plan
    wall_s: float = 0.0
    _ticks: int = 0
    _scheduled: int = 0          # sum of per-tick requests in flight
    _budget_offered: int = 0

    # -- recording ---------------------------------------------------------

    def record_tick(self, tick: int, *, n_full: int, n_cond: int, budget: int,
                    active: int, queue_depth: int,
                    pages_in_use: int = 0) -> None:
        self.records.append(TickRecord(tick, n_full, n_cond,
                                       2 * n_full + n_cond, budget, active,
                                       queue_depth, pages_in_use,
                                       pages_in_use * self.page_bytes))
        if len(self.records) > self.max_records:
            del self.records[: -self.max_records]
        self.denoiser_passes += 2 * n_full + n_cond
        self._sample_occupancy(pages_in_use, tick)
        self._ticks += 1
        self._scheduled += n_full + n_cond
        self._budget_offered += budget
        self.trace.emit("tick", tick, n_full=n_full, n_cond=n_cond,
                        budget=budget, active=active,
                        queue_depth=queue_depth, pages_in_use=pages_in_use)

    def _sample_occupancy(self, pages_in_use: int, tick: int) -> None:
        """One page-occupancy sample: updates both high-water marks and
        emits an ``occupancy`` event when a new page peak is reached.
        The byte peak is priced at the *current* ``page_bytes`` and can
        therefore peak on a different sample than the page peak."""
        if pages_in_use > self.peak_pages_in_use:
            self.peak_pages_in_use = pages_in_use
            self.trace.emit("occupancy", tick, pages=pages_in_use)
        self.peak_bytes_in_use = max(self.peak_bytes_in_use,
                                     pages_in_use * self.page_bytes)

    def note_pages(self, pages_in_use: int, tick: int = 0) -> None:
        """Sample page occupancy mid-tick. Admission grants pages before
        the same tick's finalize/reclaim frees them, so the end-of-tick
        ``record_tick`` sample alone would undercount the true device
        high-water mark (e.g. a prefill-EOS request's pages)."""
        self._sample_occupancy(pages_in_use, tick)

    def on_tick_timing(self, timing: TickTiming) -> None:
        """One engine tick's wall-clock phase breakdown (engine only;
        the simulator has no wall clock)."""
        self.tick_timings.append(timing)
        if len(self.tick_timings) > self.max_timings:
            del self.tick_timings[: -self.max_timings]
        self.wall_s += timing.duration_s
        self.hists["tick_s"].record(timing.duration_s)

    def on_reclaim(self, uid: str, tick: int, pages: int) -> None:
        """Pages returned to the pool *before* request completion — the
        COND-transition HBM saving the paged arena exists to measure.
        A 0-page reclaim is a no-op (no event): a shared uncond prefix
        may be released without any page actually going back."""
        if pages <= 0:
            return
        self.pages_reclaimed += pages
        self.trace.emit("reclaim", tick, uid, pages=pages)

    def on_grow(self, uid: str, tick: int, pages: int) -> None:
        """Pages granted on demand at a tick boundary (lazy reservation)."""
        self.pages_grown += pages
        self.trace.emit("grow", tick, uid, pages=pages)

    def on_share(self, uid: str, tick: int, pages: int) -> None:
        """Uncond prefix pages served from the canonical shared copy."""
        self.shared_page_hits += pages
        self.trace.emit("share", tick, uid, pages=pages)

    def on_cow(self, uid: str, tick: int) -> None:
        """A shared page detached copy-on-write ahead of a decode write."""
        self.cow_copies += 1
        self.trace.emit("cow", tick, uid)

    def on_cache_evict(self, uid: str, tick: int) -> None:
        """A prefix-registry entry evicted under pool pressure while
        provisioning ``uid`` (un-shares pages; may free the canonical
        copy outright)."""
        self.cache_evictions += 1
        self.trace.emit("cache_evict", tick, uid)

    def on_step_launch(self, tick: int = 0) -> None:
        """One decode-step dispatch hit the device."""
        self.step_launches += 1
        self.trace.emit("step_launch", tick)

    def on_step_compile(self, tick: int = 0) -> None:
        """A decode step was lowered + compiled (jit-cache miss). The
        engine counts this at miss time, so a metrics reset after warm-up
        (the benchmark pattern) reads 0 recompiles as long as the cache
        keeps hitting."""
        self.step_compiles += 1
        self.trace.emit("step_compile", tick)

    def on_autotune(self, tick: int, budget: int) -> None:
        """The roofline autotuner (re)derived the per-tick pass budget."""
        self.trace.emit("autotune", tick, budget=budget)

    def on_swap_out(self, uid: str, tick: int, pages: int) -> None:
        """A preemption victim's KV pages were copied to the host tier
        (checkpointed for restore-by-copy instead of recompute)."""
        self.swap_outs += 1
        self.trace.emit("swap_out", tick, uid, pages=pages)

    def on_swap_in(self, uid: str, tick: int, pages: int) -> None:
        """A resume restored its KV from the host tier by copy — zero
        denoiser passes, where the recompute path pays a 2-pass batched
        forward over prompt + generated."""
        self.swap_ins += 1
        self.recompute_passes_avoided += 2
        self.trace.emit("swap_in", tick, uid, pages=pages)

    def on_host_evict(self, uid: str, tick: int, pages: int) -> None:
        """A host-tier checkpoint was dropped — LRU pressure from a newer
        swap-out, or its owning resume checkpoint expired. The uid (if it
        ever resumes) falls back to the recompute path."""
        self.host_evictions += 1
        self.trace.emit("host_evict", tick, uid, pages=pages)

    def on_prefix_hit(self, uid: str, tick: int, pages: int) -> None:
        """Content-addressed prefix cache hit: cond prompt KV served from
        the canonical copy and token 0 replayed from the founder's cached
        logits — the admission skips its prefill forward entirely."""
        self.prefix_hits += 1
        self.recompute_passes_avoided += 2
        self.trace.emit("prefix_hit", tick, uid, pages=pages)

    def on_prefix_miss(self, uid: str, tick: int) -> None:
        """Content-cache lookup missed (cold, evicted, colliding, or not
        yet warm): the request prefills normally."""
        self.prefix_misses += 1
        self.trace.emit("prefix_miss", tick, uid)

    def on_preempt(self, uid: str, tick: float) -> None:
        """An in-flight request evicted back to the queue (pages freed,
        cursor/tokens checkpointed for exact resume). Opens a preemption
        gap on the timeline so TPOT excludes the dead time."""
        self.preemptions += 1
        tl = self.timelines.get(uid)
        if tl is not None:
            tl.preempted_at = tick
            tl.n_preempts += 1
        self.trace.emit("preempt", int(tick), uid)

    def on_resume(self, uid: str, tick: float, *, full: int = 0,
                  from_host: bool = False) -> None:
        """A preempted request re-admitted: its KV is rebuilt by one
        forward over prompt + generated tokens (both streams run) — or,
        with ``from_host``, restored from the host tier by copy, in which
        case no prefill passes are spent. Closes the open preemption
        gap."""
        self.resumes += 1
        if not from_host:
            self.prefill_passes += 2
        tl = self.timelines.get(uid)
        if tl is not None and tl.preempted_at is not None:
            tl.gap_ticks += tick - tl.preempted_at
            tl.preempted_at = None
        self.trace.emit("resume", int(tick), uid, full=int(full),
                        from_host=int(from_host))

    def on_arrival(self, uid: str, tick: float) -> None:
        self.timelines[uid] = RequestTimeline(arrival=tick)
        self.trace.emit("arrival", int(tick), uid)

    def on_reject(self, uid: str, tick: float) -> None:
        """Admission control refused the request outright."""
        self.rejected += 1
        self.trace.emit("reject", int(tick), uid)

    def on_admit(self, uid: str, tick: float, *, total_steps: int = 0,
                 full_steps: int = 0, cached: bool = False) -> None:
        """``cached`` marks a content-cache hit: the admission shared the
        canonical cond prompt KV and replayed token 0 from cached logits,
        so no prefill passes were spent."""
        tl = self.timelines[uid]
        tl.admitted = tick
        tl.total_steps = total_steps
        tl.full_steps = full_steps
        if not cached:
            self.prefill_passes += 2
        if tl.queue_wait is not None:
            self.hists["queue_wait"].record(tl.queue_wait)
        self.trace.emit("admit", int(tick), uid, total_steps=total_steps,
                        full_steps=full_steps, cached=int(cached))

    def on_token(self, uid: str, tick: float, *, cond: bool = False) -> None:
        tl = self.timelines[uid]
        if tl.first_token is None:
            tl.first_token = tick
            if tl.ttft is not None:
                self.hists["ttft"].record(tl.ttft)
        tl.tokens += 1
        self.tokens_emitted += 1
        if cond:
            tl.uncond_elided += 1
            self.uncond_ticks_elided += 1
        self.trace.emit("token", int(tick), uid, cond=int(cond))

    def on_phase_transition(self, uid: str, tick: float) -> None:
        """The request's plan crossed FULL -> COND: from here on it costs
        one denoiser pass per tick instead of two."""
        self.trace.emit("phase", int(tick), uid)

    def on_policy_switch(self, uid: str, tick: float, *, step: int,
                         elided: int) -> None:
        """A dynamic guidance policy dropped the uncond stream at ``step``,
        before its bound plan's static boundary — ``elided`` uncond passes
        the admission-time plan priced but the policy decided not to spend
        (DESIGN.md §15)."""
        self.policy_switches += 1
        self.uncond_passes_elided_dynamic += elided
        self.trace.emit("policy_switch", int(tick), uid, step=int(step),
                        elided=int(elided))

    def on_complete(self, uid: str, tick: float, passes: int) -> None:
        tl = self.timelines[uid]
        tl.completed = tick
        tl.passes = passes
        self.completed += 1
        if tl.tpot is not None:
            self.hists["tpot"].record(tl.tpot)
        self.trace.emit("complete", int(tick), uid, passes=passes)

    def on_expire(self, uid: str, tick: float) -> None:
        """Deadline passed while queued: the timeline is closed as
        terminal so latency aggregation excludes it explicitly."""
        self.expired += 1
        tl = self.timelines.get(uid)
        if tl is not None:
            tl.expired_at = tick
        self.trace.emit("expire", int(tick), uid)

    # -- aggregates --------------------------------------------------------

    @property
    def ticks(self) -> int:
        return self._ticks

    def mean_in_flight(self) -> float:
        """Mean requests *scheduled* per tick — the acceptance metric: the
        phase-aware packer must beat the static engine on this at equal
        pass budget."""
        return self._scheduled / self._ticks if self._ticks else 0.0

    def utilization(self) -> float:
        """Denoiser-pass slots used / offered."""
        if not self._budget_offered:
            return 0.0
        return self.denoiser_passes / self._budget_offered

    def mean_ttft(self) -> float | None:
        vals = [t.ttft for t in self.timelines.values() if t.ttft is not None]
        return sum(vals) / len(vals) if vals else None

    def mean_tpot(self) -> float | None:
        vals = [t.tpot for t in self.timelines.values() if t.tpot is not None]
        return sum(vals) / len(vals) if vals else None

    def passes_saved(self) -> int:
        """Total denoiser passes saved vs classic CFG over *completed*
        requests: ``sum(2*total_steps - passes)``. With early-EOS off
        this equals the COND steps in the completed plans — the paper's
        complexity reduction, measured."""
        return sum(t.passes_saved for t in self.timelines.values()
                   if t.completed is not None and t.total_steps > 0)

    def full_cfg_passes(self) -> int:
        return sum(t.full_cfg_passes for t in self.timelines.values()
                   if t.completed is not None)

    def savings_fraction(self) -> float:
        """passes_saved / full_cfg_passes over completed requests — the
        measured counterpart of the paper's Table 1 reduction. 0.0 on a
        cold replica (no completions yet) — the fleet router reads this
        before any traffic lands."""
        full = self.full_cfg_passes()
        return self.passes_saved() / full if full else 0.0

    def prefix_hit_rate(self) -> float:
        """Content-cache hit rate over lazy admissions — the router's
        prefix-affinity signal. 0.0 on a cold replica (no admissions yet),
        never a ZeroDivisionError: the fleet router polls replicas that
        have not seen a single request."""
        lookups = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / lookups if lookups else 0.0

    def request_rows(self) -> list[dict]:
        """Per-request report rows (benchmark / launch output)."""
        rows = []
        for uid, t in self.timelines.items():
            rows.append({
                "uid": uid,
                "state": ("done" if t.completed is not None else
                          "expired" if t.expired_at is not None else
                          "in_flight"),
                "queue_wait": t.queue_wait,
                "ttft": t.ttft,
                "tpot": None if t.tpot is None else round(t.tpot, 3),
                "gap_ticks": t.gap_ticks,
                "preempts": t.n_preempts,
                "tokens": t.tokens,
                "passes": t.passes,
                "full_cfg_passes": t.full_cfg_passes,
                "passes_saved": t.passes_saved if t.completed is not None
                else None,
            })
        return rows

    def summary(self) -> dict:
        return {
            "ticks": self.ticks,
            "completed": self.completed,
            "expired": self.expired,
            "rejected": self.rejected,
            "tokens": self.tokens_emitted,
            "denoiser_passes": self.denoiser_passes,
            "prefill_passes": self.prefill_passes,
            "mean_in_flight": round(self.mean_in_flight(), 3),
            "utilization": round(self.utilization(), 3),
            "pages_reclaimed": self.pages_reclaimed,
            "peak_pages_in_use": self.peak_pages_in_use,
            "page_bytes": self.page_bytes,
            "peak_bytes_in_use": self.peak_bytes_in_use,
            "pages_grown": self.pages_grown,
            "shared_page_hits": self.shared_page_hits,
            "cow_copies": self.cow_copies,
            "cache_evictions": self.cache_evictions,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "host_evictions": self.host_evictions,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_rate": round(self.prefix_hit_rate(), 4),
            "recompute_passes_avoided": self.recompute_passes_avoided,
            "step_launches": self.step_launches,
            "step_compiles": self.step_compiles,
            "mean_ttft": self.mean_ttft(),
            "mean_tpot": self.mean_tpot(),
            "ttft": self.hists["ttft"].summary(),
            "tpot": self.hists["tpot"].summary(),
            "queue_wait": self.hists["queue_wait"].summary(),
            "tick_s": self.hists["tick_s"].summary(),
            "passes_saved": self.passes_saved(),
            "uncond_ticks_elided": self.uncond_ticks_elided,
            "policy_switches": self.policy_switches,
            "uncond_passes_elided_dynamic": self.uncond_passes_elided_dynamic,
            "savings_fraction": round(self.savings_fraction(), 4),
            "events": {"emitted": self.trace.emitted,
                       "dropped": self.trace.dropped},
            "wall_s": round(self.wall_s, 4),
        }
