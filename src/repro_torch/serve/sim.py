# Copy of repro/serve/sim.py (framework-free).
"""Deterministic offline scheduler simulator — policy tests without a model.

Replays a synthetic arrival trace through the *real* ``ArrivalQueue``,
``StatePool`` and ``Scheduler`` (the same objects the engine drives), with
the denoiser step replaced by pure bookkeeping. One simulated tick is one
engine tick; everything is integer-clocked and seeded, so property tests
can sweep thousands of (plan, trace, policy) combinations in milliseconds
and any regression reproduces exactly.

The simulator is also the cheap half of the continuous-vs-static
comparison: ``simulate(trace, policy="phase")`` vs ``policy="static"``
quantifies the packing win before any XLA compile happens.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.policy import DynamicPlanCursor, ReplayGuidancePolicy
from repro_torch.core.selective import GuidancePlan, Mode, PlanCursor
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import ArrivalQueue, ServeRequest
from repro_torch.serve.scheduler import (Scheduler, admission_cutoff, bucket_pow2,
                                   provision_growth)
from repro_torch.serve.state import (ContentPrefixRegistry, HostPagePool,
                               PageAllocator, PrefixShareRegistry, StatePool,
                               fresh_lazy_needs, pages_for, plan_swap_out,
                               resume_lazy_needs, stream_page_needs)


@dataclass(frozen=True)
class SimRequest:
    uid: str
    arrival: int                       # tick the request enters the queue
    plan: GuidancePlan
    ttl: float | None = None
    prompt_len: int = 8                # paged arena: mixed lengths share
                                       # one pool (slot sim ignores this)
    priority: int = 0                  # packs first, preempted last
    content: str | None = None         # prompt-identity label: two requests
                                       # with equal labels model identical
                                       # token ids (the engine hashes real
                                       # ids; the sim needs only equality).
                                       # None = unique prompt
    switch_step: int | None = None     # recorded dynamic FULL->COND switch
                                       # (harvested from an engine run's
                                       # policy_switch event): the sim
                                       # replays it through a
                                       # ReplayGuidancePolicy cursor and
                                       # must reproduce the engine's
                                       # policy_switch/reclaim events
                                       # exactly. None = static schedule

    @property
    def full_steps(self) -> int:
        return sum(s.length for s in self.plan.segments
                   if s.mode is Mode.FULL)


@dataclass
class SimReport:
    metrics: ServeMetrics
    completions: dict[str, int] = field(default_factory=dict)   # uid -> tick
    max_wait: int = 0        # worst ticks-between-schedules over all requests
    pages: PageAllocator | None = None     # the replayed device allocator
    host: HostPagePool | None = None       # host-tier bookkeeping, if any
    content: ContentPrefixRegistry | None = None   # content cache, if any

    @property
    def makespan(self) -> int:
        return self.metrics.ticks


def poisson_arrivals(seed: int, *, n: int, rate: float) -> np.ndarray:
    """Poisson-ish arrival ticks: exponential inter-arrival times at
    ``rate`` requests/tick, quantised to the tick clock. Deterministic in
    ``seed``. Shared by the simulator, the launcher and the benchmarks."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, n)).astype(int)


def poisson_trace(seed: int, *, n: int, rate: float, total_steps: int,
                  fraction: float, guidance_scale: float = 4.0,
                  ttl: float | None = None) -> list[SimRequest]:
    """:func:`poisson_arrivals` wrapped into simulator requests, one
    suffix plan each."""
    arrivals = poisson_arrivals(seed, n=n, rate=rate)
    plan = GuidancePlan.suffix(total_steps, fraction, guidance_scale)
    return [SimRequest(f"s{i:04d}", int(t), plan, ttl)
            for i, t in enumerate(arrivals)]


def simulate(trace: list[SimRequest], *, num_slots: int, pass_budget: int,
             policy: str = "phase", starvation_limit: int = 4,
             prefills_per_tick: int | None = None, queue_depth: int = 4096,
             max_ticks: int = 100_000, kv: str = "slot",
             page_size: int = 4, num_pages: int | None = None,
             reservation: str = "eager", kv_dtype: str = "bf16",
             page_bytes: int | None = None, step_mode: str | None = None,
             bucket: bool = True, host_pages: int = 0,
             swap_min_pages: int = 0, prefix_cache: str = "length",
             async_ticks: bool = False, on_tick=None) -> SimReport:
    """Replay ``trace`` against a scheduler policy; returns a
    :class:`SimReport` whose metrics mirror the real engine's.

    ``kv="paged"`` replays the same trace against the paged-arena
    bookkeeping (the real :class:`PageAllocator`): under
    ``reservation="eager"`` admission reserves each request's worst-case
    pages (uncond = FULL prefix only); under ``"lazy"`` admission grants
    prompt pages only and the tick loop replays the engine's exact
    on-demand growth / uncond prefix sharing / priority preemption
    decision procedure (:func:`repro.serve.scheduler.provision_growth` —
    literally the same function the engine calls), so ``pages_grown``,
    ``shared_page_hits``, ``cow_copies`` and ``preemptions`` measured
    offline equal the real engine's on the same trace. Unconditional
    pages are reclaimed at the FULL->COND transition either way.

    ``kv_dtype`` labels the page pool the bookkeeping fronts ("bf16" or
    "int8"); page *counts* and every scheduling decision are identical
    across dtypes (quantization changes bytes per page, never pages per
    request), but ``page_bytes`` — HBM bytes one page pins, e.g. from
    :func:`repro.serve.state.page_nbytes` — prices the per-tick
    ``bytes_in_use`` / ``peak_bytes_in_use`` counters so occupancy is
    comparable across dtypes, mirroring the engine's accounting.

    ``step_mode`` mirrors the engine's step dispatch for the
    ``step_launches`` / ``step_compiles`` counters (None picks the
    engine's default: "ragged" when ``kv="paged"``, else "signature"):
    signature mode charges one compile per new pow2-bucketed occupancy
    signature (``bucket=False`` disables the padding, as on the engine),
    ragged mode charges exactly one compile ever — the simulated
    counters equal the real engine's on the same trace.

    ``host_pages`` enables the two-tier bookkeeping (DESIGN.md §14): a
    :class:`HostPagePool` (never attached — no storage) takes preemption
    victims' pages per :func:`plan_swap_out` (``swap_min_pages`` is the
    restore-vs-recompute floor) and resumes restore by copy, LRU evictees
    falling back to the recompute path. ``prefix_cache="content"`` mirrors
    the engine's content-addressed cond prompt cache using each request's
    ``content`` label as the identity the engine derives by hashing token
    ids. Both replay the engine's exact decision procedures, so
    ``swap_outs``/``swap_ins``/``host_evictions``/``prefix_hits``/
    ``prefix_misses`` — and the event streams — agree event for event.

    ``async_ticks`` mirrors the engine's pipelined tick (DESIGN.md §16):
    admission for tick t is decided during tick t-1's overlap window, so
    a request arriving at tick t is physically absent from the queue the
    decision scans. The sim's queue holds future arrivals, so the shared
    :func:`repro.serve.scheduler.admission_cutoff` reproduces that
    constraint as an explicit arrival filter — the *same function* the
    engine uses to gate its pipeline fill.

    ``on_tick(tick, pages, sched, queue)``, when given, runs at the end
    of every simulated tick — the serve-invariant harness hooks
    :meth:`PageAllocator.check` here.
    """
    if reservation not in ("eager", "lazy"):
        raise ValueError(reservation)
    if reservation == "lazy" and kv != "paged":
        raise ValueError('reservation="lazy" requires kv="paged"')
    if step_mode is None:
        step_mode = "ragged" if kv == "paged" else "signature"
    if step_mode not in ("signature", "ragged"):
        raise ValueError(step_mode)
    if step_mode == "ragged" and kv != "paged":
        raise ValueError('step_mode="ragged" requires kv="paged"')
    if prefix_cache not in ("length", "content"):
        raise ValueError(prefix_cache)
    if prefix_cache == "content" and reservation != "lazy":
        raise ValueError('prefix_cache="content" requires reservation="lazy"')
    if host_pages and reservation != "lazy":
        raise ValueError("host_pages requires reservation=\"lazy\"")
    trace = sorted(trace, key=lambda r: (r.arrival, r.uid))
    queue = ArrivalQueue(max_depth=queue_depth)
    pool = StatePool(num_slots)
    pages: PageAllocator | None = None
    prefix: PrefixShareRegistry | None = None
    content: ContentPrefixRegistry | None = None
    host: HostPagePool | None = None
    need_of: dict[str, tuple[int, int]] = {}
    if kv == "paged":
        cap = max((r.prompt_len + r.plan.total_steps for r in trace),
                  default=page_size)
        if num_pages is None:
            num_pages = 2 * num_slots * pages_for(cap, page_size)
        pages = PageAllocator(num_pages, page_size, kv_dtype=kv_dtype)
        if reservation == "lazy":
            prefix = PrefixShareRegistry(pages)
        if prefix_cache == "content":
            content = ContentPrefixRegistry(pages)
        if host_pages > 0:
            host = HostPagePool(host_pages)      # bookkeeping only: the
        for r in trace:                          # sim never attaches storage
            need_of[r.uid] = stream_page_needs(r.plan, r.prompt_len,
                                               page_size)
    sched = Scheduler(pass_budget, policy=policy,
                      starvation_limit=starvation_limit)
    metrics = ServeMetrics()
    if page_bytes is not None:
        metrics.page_bytes = page_bytes
    report = SimReport(metrics, pages=pages, host=host, content=content)
    cursors: dict[str, PlanCursor] = {}
    sim_req: dict[str, SimRequest] = {r.uid: r for r in trace}
    req_of: dict[str, ServeRequest] = {}
    # uid -> (step, passes, realized switch_step, ema) — the engine's
    # _ResumeState checkpoint fields, minus the tensors
    resume: dict[str, tuple[int, int, int | None, float]] = {}
    # checkpoint state driving the reclaim trigger (engine's
    # _RequestState.uncond_dead): survives preemption so a request
    # preempted at the boundary reclaims exactly once
    uncond_dead: dict[str, bool] = {}
    last_scheduled: dict[str, int] = {}
    compiled: set[tuple] = set()       # step shapes already "compiled"
    next_arrival = 0
    tick = 0

    def make_cursor(uid: str, plan: GuidancePlan, *, step: int = 0,
                    passes: int = 0, switch_step: int | None = None,
                    ema: float = 0.0) -> PlanCursor:
        # the engine's _cursor_for: requests carrying a recorded switch
        # replay it through a DynamicPlanCursor; the rest stay plain
        sw_at = sim_req[uid].switch_step
        if sw_at is None:
            return PlanCursor(plan, step=step, passes_executed=passes)
        return ReplayGuidancePolicy(plan, sw_at).cursor(
            step=step, passes_executed=passes, switch_step=switch_step,
            ema=ema)

    def release_uncond(uid: str) -> int:
        # canonical pages freed with the last user count as reclaimed too
        freed = pages.free(uid, "u")
        if prefix is not None:
            freed += prefix.release(uid)
        return freed

    def ckey_of(uid: str):
        # the engine hashes the prompt's token ids; two sim requests model
        # identical prompts iff their content labels are equal (None =
        # unique prompt, keyed by uid so it can publish but never hit)
        if content is None:
            return None
        label = sim_req[uid].content
        return label if label is not None else f"~{uid}"

    def reclaim_cache() -> bool:
        # content tier first, mirroring the engine's _reclaim_cache
        if content is not None and content.evict_under_pressure():
            return True
        return prefix.evict_under_pressure()

    def free_for_admission(n: int, uid: str) -> bool:
        # blocked admission drains the *content* cache only (engine's
        # _free_for_admission): persistent entries can fill an idle pool
        # with nothing active to trigger provision_growth's reclaim, and
        # the non-persistent length registry can never pin an idle pool
        while pages.n_free < n:
            if content is None or not content.evict_under_pressure():
                return False
            metrics.on_cache_evict(uid, tick)
        return True

    def preempt(uid: str) -> None:
        # event order is the engine's _preempt contract:
        # preempt -> host_evict* (LRU victims) -> swap_out
        entry = sched._active[uid]
        cur = cursors[uid]
        resume[uid] = (cur.step, cur.passes_executed,
                       getattr(cur, "switch_step", None),
                       getattr(cur, "ema", 0.0))
        pool.free(entry.slot)
        metrics.on_preempt(uid, tick)
        swap = plan_swap_out(pages, host, uid, min_pages=swap_min_pages)
        if swap is not None:
            put = host.put(uid, swap)
            assert put is not None     # plan_swap_out checked capacity
            _placed, evicted = put
            for euid, n_freed in evicted:
                metrics.on_host_evict(euid, tick, n_freed)
            metrics.on_swap_out(uid, tick, sum(swap.values()))
        pages.free_all(uid)
        prefix.release(uid)
        if content is not None:
            content.release(uid)
        sched.release(uid)
        queue.requeue(req_of[uid])

    def drained() -> bool:
        return (next_arrival >= len(trace) and len(queue) == 0
                and sched.n_active == 0)

    while not drained():
        if tick >= max_ticks:
            raise RuntimeError(f"simulation did not drain in {max_ticks} ticks")
        # arrivals scheduled for this tick
        while next_arrival < len(trace) and trace[next_arrival].arrival <= tick:
            sr = trace[next_arrival]
            next_arrival += 1
            req = ServeRequest(sr.uid, prompt=[], ttl=sr.ttl, plan=sr.plan,
                               prompt_len=sr.prompt_len, priority=sr.priority)
            req_of[sr.uid] = req
            metrics.on_arrival(sr.uid, tick)
            if pages is not None and sum(need_of[sr.uid]) > pages.num_pages:
                metrics.on_reject(sr.uid, tick)  # can never fit: don't
            elif not queue.push(req, tick):      # wedge the FCFS head
                metrics.on_reject(sr.uid, tick)
        # deadline expiry: a preempted request's host checkpoint dies with
        # its resume checkpoint (the no-leak-at-drain contract)
        for dead in queue.expire(tick):
            had_ckpt = resume.pop(dead.uid, None) is not None
            metrics.on_expire(dead.uid, tick)
            if had_ckpt and host is not None:
                freed = host.drop(dead.uid)
                if freed:
                    metrics.on_host_evict(dead.uid, tick, freed)
        # admission
        quota = sched.admission_quota(pool.n_free)
        if prefills_per_tick is not None:
            quota = min(quota, prefills_per_tick)
        for _ in range(quota):
            req = queue.peek()
            if req is None:
                break
            uid = req.uid
            if async_ticks and sim_req[uid].arrival > \
                    admission_cutoff(tick, pipelined=True):
                # pipelined mode decided this tick's admissions one tick
                # ago — the head had not arrived yet. FIFO: nothing
                # behind it is older.
                break
            S = sim_req[uid].prompt_len
            resumed = False
            from_host = 0              # pages restored from the host tier
            hit_pages = 0              # cond pages shared on a content hit
            miss = False               # content lookup ran and missed
            if pages is None:
                queue.pop()
            elif reservation == "lazy" and uid in resume:
                step, passes, sw, ema = resume[uid]
                if host is not None and host.holds(uid):
                    # restore by copy — the engine's zero-pass path
                    held = host.pages_of(uid)
                    total = sum(len(v) for v in held.values())
                    if not free_for_admission(total, uid):
                        break          # head-of-line waits for pages
                    queue.pop()
                    del resume[uid]
                    for stream in sorted(held):
                        pages.alloc(uid, stream, len(held[stream]))
                    host.drop(uid)
                    from_host = total
                else:
                    shared = prefix.lookup(S) is not None
                    need_c, need_u, wants_u, n_share = resume_lazy_needs(
                        req.plan, step, S, page_size, shared=shared,
                        switch_step=sw)
                    if not free_for_admission(need_c + need_u, uid):
                        break          # head-of-line waits for pages
                    queue.pop()
                    del resume[uid]
                    pages.alloc(uid, "c", need_c)
                    if wants_u:
                        if n_share:
                            prefix.acquire(S, uid, count=n_share)
                            metrics.on_share(uid, tick, n_share)
                            if need_u:
                                pages.grow(uid, "u", need_u)
                        else:
                            pages.alloc(uid, "u", need_u)
                resumed = True
                cursor = make_cursor(uid, req.plan, step=step, passes=passes,
                                     switch_step=sw, ema=ema)
            elif reservation == "lazy":
                shared = prefix.lookup(S) is not None
                need_c, need_u, wants_u = fresh_lazy_needs(
                    req.plan, S, page_size, shared=shared)
                ckey = ckey_of(uid)
                if ckey is not None and content.ready(ckey, tick) \
                        and content.matches(ckey, ckey) \
                        and (not wants_u or shared):
                    # content hit: share canonical cond prompt pages, no
                    # fresh grant needed (the engine skips its prefill)
                    queue.pop()
                    got = content.acquire(ckey, uid)
                    hit_pages = len(got)
                    if wants_u:
                        n_share = len(prefix.acquire(S, uid))
                        metrics.on_share(uid, tick, n_share)
                else:
                    if not free_for_admission(need_c + need_u, uid):
                        break          # head-of-line waits for pages
                    queue.pop()
                    pages.alloc(uid, "c", need_c)
                    if wants_u and shared:
                        got = prefix.acquire(S, uid)
                        metrics.on_share(uid, tick, len(got))
                    elif wants_u:
                        pages.alloc(uid, "u", need_u)
                        prefix.publish(S, uid)
                    miss = ckey is not None
                    if miss and content.lookup(ckey) is None:
                        # founder: canonical entry, hittable next tick
                        content.publish(ckey, uid, ids=ckey, tick=tick)
            else:
                need_c, need_u = need_of[uid]
                if pages.n_free < need_c + need_u:
                    break              # head-of-line waits for pages
                queue.pop()
                pages.alloc(uid, "c", need_c)
                if need_u:
                    pages.alloc(uid, "u", need_u)
            slot = pool.alloc(uid)
            assert slot is not None
            if not resumed:
                cursor = make_cursor(uid, req.plan)
                uncond_dead[uid] = not any(s.mode is Mode.FULL
                                           for s in req.plan.segments)
            cursors[uid] = cursor
            sched.admit(uid, slot, cursor, arrival=req.arrival,
                        deadline=req.deadline, priority=req.priority)
            last_scheduled[uid] = tick
            # event order per admission mirrors the engine's queue-order
            # bookkeeping: share -> hit/miss -> (swap_in ->) resume|admit
            if hit_pages:
                metrics.on_prefix_hit(uid, tick, hit_pages)
            elif miss:
                metrics.on_prefix_miss(uid, tick)
            if resumed:
                if from_host:
                    metrics.on_swap_in(uid, tick, from_host)
                metrics.on_resume(uid, tick,       # KV rebuilt, no emit
                                  full=int(cursor.mode is Mode.FULL),
                                  from_host=bool(from_host))
            else:
                plan_ = req.plan
                metrics.on_admit(
                    uid, tick, total_steps=plan_.total_steps,
                    full_steps=plan_.denoiser_passes() - plan_.total_steps,
                    cached=bool(hit_pages))
                metrics.on_token(uid, tick)        # prefill emits token 0
        if pages is not None:
            metrics.note_pages(pages.n_in_use, tick)
        # pack + provision (lazy growth / CoW / preemption) + execute
        plan = sched.plan_tick()
        if reservation == "lazy" and plan.in_flight:
            plan = provision_growth(
                plan, sched, pages, page_size=page_size,
                pos_of=lambda uid: sim_req[uid].prompt_len
                + cursors[uid].step,
                metrics=metrics, preempt=preempt,
                reclaim_cache=reclaim_cache, now=tick)
            metrics.note_pages(pages.n_in_use, tick)
        if plan.in_flight:
            # mirror the engine's step dispatch: one launch per non-empty
            # tick, one compile per never-seen step shape
            metrics.on_step_launch(tick)
            shape = ("rstep",) if step_mode == "ragged" else (
                "step",
                bucket_pow2(plan.n_full) if bucket else plan.n_full,
                bucket_pow2(plan.n_cond) if bucket else plan.n_cond)
            if shape not in compiled:
                compiled.add(shape)
                metrics.on_step_compile(tick)
        events = sched.commit(plan)
        for ev in events:
            report.max_wait = max(report.max_wait,
                                  tick - last_scheduled[ev.uid])
            last_scheduled[ev.uid] = tick
            cursor = cursors[ev.uid]
            if not ev.done:
                metrics.on_token(ev.uid, tick,     # step i emits token i+1
                                 cond=ev.mode is Mode.COND)
                if ev.mode is Mode.FULL \
                        and isinstance(cursor, DynamicPlanCursor) \
                        and cursor.observe(0.0):
                    # replay cursors trigger on step alone — the recorded
                    # switch re-fires at the engine's exact tick
                    metrics.on_policy_switch(
                        ev.uid, tick, step=cursor.switch_step,
                        elided=cursor.elided_uncond_passes())
                if not uncond_dead[ev.uid] and cursor.mode is Mode.COND:
                    uncond_dead[ev.uid] = True
                    metrics.on_phase_transition(ev.uid, tick)
                    if pages is not None:
                        metrics.on_reclaim(ev.uid, tick,
                                           release_uncond(ev.uid))
            else:
                pool.free(ev.slot)
                if pages is not None:
                    pages.free_all(ev.uid)
                    if prefix is not None:
                        prefix.release(ev.uid)
                    if content is not None:
                        content.release(ev.uid)
                sched.release(ev.uid)
                metrics.on_complete(ev.uid, tick, cursor.passes_executed)
                report.completions[ev.uid] = tick
        metrics.record_tick(tick, n_full=plan.n_full, n_cond=plan.n_cond,
                            budget=plan.budget, active=sched.n_active,
                            queue_depth=len(queue),
                            pages_in_use=pages.n_in_use if pages else 0)
        if host is not None:
            host.check()               # conservation, every simulated tick
        if on_tick is not None:
            on_tick(tick, pages, sched, queue)
        tick += 1
    return report


def compare_policies(trace: list[SimRequest], *, num_slots: int,
                     pass_budget: int, **kw) -> dict[str, SimReport]:
    """The headline comparison: phase-aware continuous batching vs the
    static lockstep baseline on the same trace and pass budget."""
    return {p: simulate(trace, num_slots=num_slots, pass_budget=pass_budget,
                        policy=p, **kw)
            for p in ("phase", "static")}
