# Copy of repro/serve/scheduler.py (framework-free).
"""Phase-aware pass-budget packing — the core policy of ``repro.serve``.

The unit of scheduling is the **denoiser-pass slot**: every tick has a
fixed ``pass_budget``, a request whose :class:`PlanCursor` sits in a FULL
segment costs 2 passes (two denoiser streams), one in a COND segment costs
1 (the paper's optimization). Packing on that asymmetry is what converts
the paper's per-request latency saving into fleet throughput: a tick full
of late-phase (COND) requests carries twice as many requests as a tick of
early-phase (FULL) ones at identical hardware cost.

Policies
--------
* ``"phase"`` — FCFS with COND backfill and an anti-starvation guard:
  requests are packed in arrival order; a request that does not fit the
  remaining budget is passed over and *younger, cheaper* requests may
  backfill the gap — but once any request has been passed over
  ``starvation_limit`` ticks it is promoted to the front of the order and,
  if it still does not fit, packing stops behind it so the budget frees up
  next tick (bounded wait even under adversarial COND floods). Within each
  class (starved, fresh) higher ``priority`` packs first; inside a priority
  level deadline-bearing requests pack earliest-deadline first (EDF) and
  deadline-free requests keep pure FCFS order behind them, so
  latency-sensitive traffic jumps the line without touching the aging
  guard's starvation bound.

The same priorities drive **preemption** under lazy page reservation:
:func:`victim_key` is a strict total order (lowest priority, latest
deadline, youngest admission evicts first) and :func:`provision_growth`
evicts along it when the page pool runs dry, checkpointing nothing here —
the engine owns the RUNNING -> PREEMPTED -> QUEUED -> RUNNING state
machine (DESIGN.md §10); this module only decides *who*.
* ``"static"`` — the seed engine's behavior as a policy: the resident
  batch steps in lockstep and admission opens only when the batch has
  fully drained. Used as the baseline in ``sim`` and benchmarks.

FULL->COND transitions need no special casing here: ``commit`` advances
each scheduled cursor, so a request crossing the boundary simply costs 1
instead of 2 on the next tick and the packer re-packs around it.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.selective import Mode, PlanCursor

POLICIES = ("phase", "static")


def bucket_pow2(n: int) -> int:
    """Round a group size up to the next power of two (0 stays 0) — the
    padding the per-signature compile cache keys on. The engine and the
    simulator share this so their recompile counts agree exactly."""
    if n <= 1:
        return n
    return 1 << (n - 1).bit_length()


@dataclass
class ActiveRequest:
    uid: str
    slot: int
    cursor: PlanCursor
    arrival: float = 0.0
    seq: int = 0                  # admission order, the FCFS key
    skipped_ticks: int = 0        # consecutive ticks passed over
    deadline: float | None = None # EDF key within a class (None = last)
    priority: int = 0             # larger = more important (packs first,
                                  # preempted last)

    @property
    def edf_key(self) -> tuple:
        """Earliest-deadline-first within a class: deadline-bearing
        requests first (earliest deadline wins), then FCFS by seq."""
        return (self.deadline is None,
                self.deadline if self.deadline is not None else 0.0,
                self.seq)

    @property
    def pack_key(self) -> tuple:
        """Packing order inside a starved/fresh class: priority classes
        first, EDF/FCFS within a class — priorities layer *under* the
        aging guard, so the starvation bound is untouched."""
        return (-self.priority,) + self.edf_key


_LATEST = float("inf")


def victim_key(e: ActiveRequest) -> tuple:
    """Total preemption order, ascending = evict first: lowest priority,
    then latest deadline (deadline-free = latest of all), then youngest
    admission (least progress lost; ``seq`` makes the order strict, so
    preemption can never cycle — the globally strongest request always
    runs to completion and frees its pages)."""
    return (e.priority,
            -(e.deadline if e.deadline is not None else _LATEST),
            -e.seq)


@dataclass(frozen=True)
class PassRow:
    """One denoiser pass of the tick's flat ragged pass list: which
    request-stream this row runs. ``stream`` is "c" (conditional) or
    "u" (unconditional — the second pass of a FULL step)."""

    entry: ActiveRequest
    stream: str


@dataclass(frozen=True)
class TickPlan:
    """One tick's packing: which slots step in which mode."""

    full: tuple[ActiveRequest, ...]
    cond: tuple[ActiveRequest, ...]
    budget: int
    skipped: tuple[str, ...] = ()

    @property
    def n_full(self) -> int:
        return len(self.full)

    @property
    def n_cond(self) -> int:
        return len(self.cond)

    @property
    def in_flight(self) -> int:
        return self.n_full + self.n_cond

    @property
    def cost(self) -> int:
        return 2 * self.n_full + self.n_cond

    @property
    def signature(self) -> tuple[int, int]:
        """(n_full, n_cond) — the occupancy signature the engine's
        per-signature compile cache keys on (before bucket padding;
        the ragged step has no use for it)."""
        return (self.n_full, self.n_cond)

    @property
    def n_rows(self) -> int:
        """Rows of the flat ragged pass list — one per denoiser pass, so
        ``n_rows == cost <= budget`` whatever the phase mix."""
        return self.cost

    def pass_rows(self) -> tuple[PassRow, ...]:
        """The tick's work as a flat pass list (DESIGN.md §12 row-layout
        contract): the first ``in_flight`` rows are the **output** rows —
        every scheduled entry's conditional pass in ``full + cond`` order,
        exactly the order :meth:`commit` emits events — and the next
        ``n_full`` rows are the FULL entries' unconditional passes in the
        same order, so output row ``i < n_full`` pairs with uncond row
        ``in_flight + i``. Rows past ``n_rows`` (up to the step's fixed
        capacity) are padding the engine fabricates (phase 0, out-of-range
        block tables)."""
        out = [PassRow(e, "c") for e in self.full + self.cond]
        out += [PassRow(e, "u") for e in self.full]
        return tuple(out)


@dataclass
class TickEvent:
    uid: str
    slot: int
    mode: Mode
    local_step: int               # plan step that was executed
    done: bool                    # cursor exhausted after this step


class Scheduler:
    """Packs active requests into per-tick :class:`TickPlan`s."""

    def __init__(self, pass_budget: int, *, policy: str = "phase",
                 starvation_limit: int = 4):
        if pass_budget < 2:
            raise ValueError("pass_budget must fit one FULL step (>= 2)")
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        if starvation_limit < 1:
            raise ValueError(starvation_limit)
        self.pass_budget = pass_budget
        self.policy = policy
        self.starvation_limit = starvation_limit
        self._active: dict[str, ActiveRequest] = {}
        self._seq = 0

    # -- membership --------------------------------------------------------

    @property
    def n_active(self) -> int:
        return len(self._active)

    def active(self) -> list[ActiveRequest]:
        return sorted(self._active.values(), key=lambda e: e.seq)

    def admit(self, uid: str, slot: int, cursor: PlanCursor, *,
              arrival: float = 0.0, deadline: float | None = None,
              priority: int = 0) -> ActiveRequest:
        if uid in self._active:
            raise ValueError(f"uid {uid!r} already active")
        cursor.plan.validate_for_ar()
        entry = ActiveRequest(uid, slot, cursor, arrival, self._seq,
                              deadline=deadline, priority=priority)
        self._seq += 1
        self._active[uid] = entry
        return entry

    def release(self, uid: str) -> None:
        del self._active[uid]

    def victim(self, exclude: str) -> ActiveRequest | None:
        """The in-flight request the preemption order evicts first
        (lowest priority, latest deadline, youngest), never ``exclude``;
        None when nothing else is active."""
        cands = [e for e in self._active.values() if e.uid != exclude]
        return min(cands, key=victim_key) if cands else None

    def reslot(self, uid: str, slot: int) -> None:
        """Point an active request at a new arena slot (defragmentation)."""
        self._active[uid].slot = slot

    def admission_quota(self, free_slots: int) -> int:
        """How many queued requests may be admitted this tick."""
        if self.policy == "static":
            # lockstep batches: refill only once fully drained, and only as
            # many as can step together at worst-case (all-FULL) cost
            if self._active:
                return 0
            return min(free_slots, self.pass_budget // 2)
        return free_slots

    # -- packing -----------------------------------------------------------

    def plan_tick(self) -> TickPlan:
        if self.policy == "static":
            return self._plan_static()
        return self._plan_phase()

    def _plan_static(self) -> TickPlan:
        entries = self.active()
        full = tuple(e for e in entries if e.cursor.mode is Mode.FULL)
        cond = tuple(e for e in entries if e.cursor.mode is Mode.COND)
        # admission_quota guarantees worst-case fit; assert, don't trust
        assert 2 * len(full) + len(cond) <= self.pass_budget
        return TickPlan(full, cond, self.pass_budget)

    def _plan_phase(self) -> TickPlan:
        # EDF within FCFS classes: the starved class still pre-empts the
        # fresh class (the aging guard's bound is untouched), but inside
        # each class deadline-bearing requests pack earliest-deadline
        # first; deadline-free requests keep pure FCFS behind them.
        starved = sorted((e for e in self.active()
                          if e.skipped_ticks >= self.starvation_limit),
                         key=lambda e: e.pack_key)
        fresh = sorted((e for e in self.active()
                        if e.skipped_ticks < self.starvation_limit),
                       key=lambda e: e.pack_key)
        remaining = self.pass_budget
        full: list[ActiveRequest] = []
        cond: list[ActiveRequest] = []
        skipped: list[str] = []
        blocked = False               # a starved request could not fit
        for entry in starved + fresh:
            cost = entry.cursor.cost
            fits = cost <= remaining
            if fits and not blocked:
                (full if cost == 2 else cond).append(entry)
                remaining -= cost
            else:
                skipped.append(entry.uid)
                if entry.skipped_ticks >= self.starvation_limit:
                    # reserve the leftover budget: nothing may backfill past
                    # a starved request, so it is schedulable next tick
                    blocked = True
        return TickPlan(tuple(full), tuple(cond), self.pass_budget,
                        tuple(skipped))

    def commit(self, plan: TickPlan) -> list[TickEvent]:
        """Advance the scheduled cursors; update starvation counters."""
        events: list[TickEvent] = []
        scheduled = set()
        for entry in plan.full + plan.cond:
            local = entry.cursor.step
            mode = entry.cursor.advance()
            entry.skipped_ticks = 0
            scheduled.add(entry.uid)
            events.append(TickEvent(entry.uid, entry.slot, mode, local,
                                    entry.cursor.done))
        for entry in self._active.values():
            if entry.uid not in scheduled:
                entry.skipped_ticks += 1
        return events


def provision_growth(plan: TickPlan, sched: Scheduler, pages, *,
                     page_size: int, pos_of, metrics, preempt,
                     copy_page=None, reclaim_cache=None,
                     now: int = 0) -> TickPlan:
    """Grant the pages this tick's writes need — growing, copy-on-write
    detaching, or preempting — and return the (possibly filtered) plan.

    The lazy-reservation core, shared verbatim by the engine and the
    offline simulator so their ``pages_grown``/``preemptions``/
    ``cow_copies`` counts — and the grow/cow/cache-evict *events*, which
    ``now`` stamps with the current tick — agree tick for tick. For each
    scheduled entry,
    strongest first (descending :func:`victim_key`), every stream the
    step writes ("c", plus "u" for FULL steps) must have a *private* page
    covering the write position:

    * position beyond the block table -> :meth:`PageAllocator.grow`;
    * position lands in a shared page (uncond prompt prefix, or a
      content-cache cond prompt page — the procedure is stream-agnostic,
      any refcount>1 page at the write index CoW-detaches) ->
      :meth:`PageAllocator.cow` + ``copy_page(src, dst)`` device copy;
    * pool dry -> first evict prefix-registry cache entries
      (``reclaim_cache()``: frees stranded canonical pages and un-shares
      pages whose CoW was the whole problem — cache eviction is free,
      preemption loses work; with the §14 tier the callback drains the
      content-addressed prompt cache before the length-keyed uncond
      registry, since content entries are pure speculation while uncond
      shares are in active use), then evict the weakest *strictly weaker*
      in-flight request via ``preempt(uid)`` (which must free its pages)
      and retry; no such victim -> defer this entry (dropped from the
      plan, keeps its pages, ages toward the starvation guard).

    Because the victim order is strict and total, the strongest entry can
    always either grow or evict, so the engine never livelocks: at least
    one request makes progress every tick the pool is contended.
    """
    entries = sorted(plan.full + plan.cond, key=victim_key, reverse=True)
    dropped: set[str] = set()
    kept: set[str] = set()
    deferred: list[str] = []
    for entry in entries:
        if entry.uid in dropped:
            continue
        idx = pos_of(entry.uid) // page_size
        streams = ("c", "u") if entry.cursor.mode is Mode.FULL else ("c",)
        ok = True
        for stream in streams:
            while ok:
                owned = pages.owned(entry.uid, stream)
                if idx < len(owned):
                    if pages.refcount(owned[idx]) == 1:
                        break                        # private: writable
                    got = pages.cow(entry.uid, stream, idx)
                    if got is not None:
                        if copy_page is not None:
                            copy_page(*got)
                        metrics.on_cow(entry.uid, now)
                        break
                else:
                    grown = pages.grow(entry.uid, stream, 1)
                    if grown is not None:
                        metrics.on_grow(entry.uid, now, len(grown))
                        break
                if reclaim_cache is not None and reclaim_cache():
                    metrics.on_cache_evict(entry.uid, now)
                    continue                         # retry: cache evicted
                victim = sched.victim(exclude=entry.uid)
                if victim is None or \
                        not victim_key(victim) < victim_key(entry):
                    ok = False                       # defer: no weaker victim
                    break
                preempt(victim.uid)
                dropped.add(victim.uid)
            if not ok:
                break
        if ok:
            kept.add(entry.uid)
        else:
            deferred.append(entry.uid)
    if not dropped and not deferred:
        return plan
    return TickPlan(tuple(e for e in plan.full if e.uid in kept),
                    tuple(e for e in plan.cond if e.uid in kept),
                    plan.budget, plan.skipped + tuple(deferred))


def admission_cutoff(now: int, *, pipelined: bool) -> int:
    """Latest arrival tick admissible at tick ``now``.

    Synchronous ticks admit anything that has arrived by ``now``. The
    async pipeline decides tick ``now``'s admissions one tick early —
    while tick ``now - 1``'s ragged step runs on device — so a request
    arriving *at* ``now`` is invisible to the decision and waits one
    tick. Tick 0 has no prior tick to overlap with, so the pipeline
    fills inline and the cutoff stays 0.

    The single definition shared by the engine's async tick loop and the
    simulator: both filter the queue head by
    ``arrival <= admission_cutoff(now, pipelined=...)``, so the pipelined
    admission schedule — and every downstream counter and event — agrees
    tick for tick.
    """
    if not pipelined:
        return now
    return max(0, now - 1)
