"""Continuous-batching serve engine over the paged KV arena. Counterpart of
``repro.serve.engine.ContinuousEngine``, for the part of it that runs on
pages with eager reservation and synchronous ticks.

Requests join and leave mid-flight. Each tick expires queued requests past
their deadline, admits new ones (a batched, pow2-bucketed prefill of both
streams into the shared page pool), asks the :class:`Scheduler` to pack the
active requests against the tick's denoiser-pass budget (FULL = 2 passes,
COND = 1), runs one decode step, then emits tokens, retires completed
requests and returns a request's unconditional pages to the pool the moment
its plan crosses into the COND suffix.

Two step modes:

* ``"ragged"`` (the default) runs the whole tick as one step of
  ``ragged_rows`` rows, one denoiser pass each with its own block table,
  position and phase: FULL entries give a cond and an uncond row, COND
  entries one, the rest is phase-0 padding. The attention goes to the
  ragged paged kernels (B7 bf16, B8 int8). Its shape never changes, so it
  is counted as one compile per model, under the key ``("rstep", R)``.
* ``"signature"`` runs the FULL and COND groups of the tick, each padded to
  a power of two, through the per-row-position kernels (B9, B10); one
  compile is counted per ``("pstep", n_full, n_cond)`` bucket.

``kv_dtype="int8"`` stores the pool as int8 values with float32 scales per
(position, kv head), quantized on write. The combine stage is Eq. 1 with a
per-row scale (``cfg``, and ``interval`` with scale 1 outside the interval)
or APG (``apg``), and the guidance policy is ``static``, ``divergence`` or
``interval`` (``repro_torch.core.policy``).

The port differs from the reference in what a framework forces: the
engine takes the port's ``Transformer`` where the reference takes params;
the pool lives on the model's device and is updated in place; there is no
jit, so the first use of a step shape counts as the compile the reference
would pay, under the reference's keys (``step_compiles`` and
``step_launches`` fold to the reference's values); and randomness for
temperature > 0 comes from a ``torch.Generator`` seeded per request and
step, not from jax's threefry keys, so sampled tokens differ from the
reference's while greedy tokens are the parity contract.

Options the port does not have yet raise ``NotImplementedError`` naming
their ``ROADMAP.md`` item: the slot arena, lazy reservation, the host tier,
the content prefix cache, async ticks, a mesh or sharding rules, and
``pass_budget="auto"``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.guidance import apg_combine, cfg_combine_rowscale
from repro_torch.core.policy import (GUIDANCE_POLICIES, DivergenceGuidancePolicy,
                                     DynamicPlanCursor, GuidancePolicy, make_policy)
from repro_torch.core.selective import GuidancePlan, Mode, PlanCursor, round_half_up
from repro_torch.data.tokenizer import EOS, PAD, encode
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.obs import TickTimer
from repro_torch.serve.queue import ArrivalQueue, ServeRequest
from repro_torch.serve.scheduler import Scheduler, TickPlan, bucket_pow2
from repro_torch.serve.state import (PageAllocator, StatePool, kv_page_bytes, pages_for,
                                     stream_page_needs)

KV_MODES = ("slot", "paged")
KV_DTYPES = ("bf16", "int8")
RESERVATION_MODES = ("eager", "lazy")
STEP_MODES = ("signature", "ragged")
PREFIX_CACHE_MODES = ("length", "content")
COMBINE_MODES = ("cfg", "apg", "interval")
TICK_MODES = ("sync", "async")

_bucket = bucket_pow2


_RAGGED_INT = ("tok", "pos", "lstep", "u_idx", "phase")    # int32 rows after the tables


def _ragged_views(ibuf, fbuf, R: int, nb: int) -> dict:
    """Named views of the ragged step's two flat row buffers (numpy arrays
    on the host, tensors on the device): block tables (R, nb), then R
    int32 values per name of ``_RAGGED_INT``; scales and temperatures."""
    views = {"bt": ibuf[:R * nb].reshape(R, nb), "scale": fbuf[:R], "temp": fbuf[R:]}
    for i, name in enumerate(_RAGGED_INT):
        views[name] = ibuf[R * (nb + i):R * (nb + i + 1)]
    return views


def _later(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class _SlotArrays:
    """Host-side per-slot scalars (token, position, scale, ...); ``key`` is
    the request's sampling seed."""

    def __init__(self, n: int):
        self.tok = np.zeros(n, np.int32)
        self.pos = np.zeros(n, np.int32)
        self.scale = np.zeros(n, np.float32)
        self.temp = np.zeros(n, np.float32)
        self.lstep = np.zeros(n, np.int32)
        self.key = np.zeros(n, np.uint32)


class _RequestState:
    def __init__(self, req: ServeRequest, cursor: PlanCursor, slot: int):
        self.req = req
        self.cursor = cursor
        self.slot = slot
        self.generated: list[int] = []
        # True once the uncond stream is dead: reclaimed at the transition,
        # or never allocated (all-COND plan)
        self.uncond_dead = not any(s.mode is Mode.FULL for s in cursor.plan.segments)


class _PrefillItem:
    """One eager admission, normalized for the batched bucketed prefill."""

    def __init__(self, req: ServeRequest, slot: int, tokens: np.ndarray, true_len: int,
                 key: int):
        self.req = req
        self.slot = slot
        self.tokens = tokens              # (true_len,) int32
        self.true_len = true_len
        self.key = key


class ContinuousEngine:
    """Phase-aware continuous batching over the paged KV arena.

    ``model`` is a ``repro_torch.models.transformer.Transformer`` on the
    device the engine runs on (``Transformer.init`` puts it on the GPU
    unless asked for the CPU). The constructor takes the reference's
    arguments and defaults; ``kv="paged"`` is required.
    """

    def __init__(self, model, cfg, *, num_slots: int = 8,
                 pass_budget=None, prompt_len: int = 32,
                 max_new: int = 32, selective_fraction: float = 0.2,
                 rules=None, seed: int = 0, stop_on_eos: bool = True,
                 policy: str = "phase", starvation_limit: int = 4,
                 defrag_threshold: float = 0.5, prefills_per_tick: int = 2,
                 queue_depth: int = 256, bucket: bool = True,
                 kv: str = "slot", page_size: int = 8,
                 num_pages: int | None = None,
                 reservation: str = "eager",
                 kv_dtype: str = "bf16",
                 target_tick_s: float = 50e-3,
                 step_mode: str | None = None,
                 host_pool_bytes: int = 0,
                 swap_min_pages: int | str = 0,
                 prefix_cache: str = "length",
                 guidance_policy: str = "static",
                 divergence_threshold: float = 0.0,
                 divergence_momentum: float = 0.0,
                 combine: str = "cfg",
                 apg_eta: float = 0.0,
                 apg_threshold: float = 0.0,
                 interval: tuple[float, float] = (0.0, 1.0),
                 mesh=None,
                 tick_mode: str = "sync"):
        # the reference's validation, in its order
        if kv not in KV_MODES:
            raise ValueError(f"kv {kv!r} not in {KV_MODES}")
        if step_mode is None:
            step_mode = "ragged" if kv == "paged" else "signature"
        if step_mode not in STEP_MODES:
            raise ValueError(f"step_mode {step_mode!r} not in {STEP_MODES}")
        if tick_mode not in TICK_MODES:
            raise ValueError(f"tick_mode {tick_mode!r} not in {TICK_MODES}")
        if step_mode == "ragged" and kv != "paged":
            raise ValueError('step_mode="ragged" requires kv="paged" (the '
                             "flat pass list addresses KV through block tables)")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
        if kv_dtype == "int8" and kv != "paged":
            raise ValueError('kv_dtype="int8" requires kv="paged"')
        if reservation not in RESERVATION_MODES:
            raise ValueError(f"reservation {reservation!r} not in {RESERVATION_MODES}")
        if reservation == "lazy" and kv != "paged":
            raise ValueError('reservation="lazy" requires kv="paged" '
                             "(the slot arena reserves whole rows)")
        if prefix_cache not in PREFIX_CACHE_MODES:
            raise ValueError(f"prefix_cache {prefix_cache!r} not in {PREFIX_CACHE_MODES}")
        if prefix_cache == "content" and reservation != "lazy":
            raise ValueError('prefix_cache="content" requires reservation="lazy"')
        if host_pool_bytes < 0:
            raise ValueError(host_pool_bytes)
        if host_pool_bytes and reservation != "lazy":
            raise ValueError('host_pool_bytes requires reservation="lazy" '
                             "(swap-out rides the preemption path)")
        if swap_min_pages != "auto" and (not isinstance(swap_min_pages, int)
                                         or swap_min_pages < 0):
            raise ValueError(f"swap_min_pages {swap_min_pages!r}")
        if swap_min_pages == "auto" and pass_budget != "auto":
            raise ValueError('swap_min_pages="auto" needs the roofline '
                             'latency model: set pass_budget="auto"')
        if guidance_policy not in GUIDANCE_POLICIES:
            raise ValueError(f"guidance_policy {guidance_policy!r} not in "
                             f"{GUIDANCE_POLICIES}")
        if guidance_policy == "divergence" and divergence_threshold <= 0.0:
            raise ValueError('guidance_policy="divergence" needs divergence_threshold > 0')
        if combine not in COMBINE_MODES:
            raise ValueError(f"combine {combine!r} not in {COMBINE_MODES}")
        if not 0.0 <= interval[0] < interval[1] <= 1.0:
            raise ValueError(f"interval {interval!r} must satisfy 0 <= start < stop <= 1")
        # what the port does not have yet
        if kv == "slot":
            raise _later('kv="slot" (the slot arena)', "A10.1")
        if reservation == "lazy":
            raise _later('reservation="lazy" (growth, preemption, resume, CoW)', "A10")
        if host_pool_bytes:
            raise _later("host_pool_bytes (the host tier)", "A11")
        if prefix_cache == "content":
            raise _later('prefix_cache="content"', "A11")
        if tick_mode == "async":
            raise _later('tick_mode="async"', "A11")
        if mesh is not None or rules is not None:
            raise _later("a mesh or sharding rules", "A13")
        if pass_budget == "auto":
            raise _later('pass_budget="auto" (the roofline autotuner)', "A11")
        if guidance_policy == "interval" and combine == "cfg":
            # the interval policy's semantics live in the combine stage
            combine = "interval"
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.num_slots = num_slots
        self.prompt_len = prompt_len           # engine-wide maximum
        self.max_new = max_new
        self.capacity = prompt_len + max_new
        self.selective_fraction = selective_fraction
        self.tick_mode = tick_mode
        self.stop_on_eos = stop_on_eos
        self.guidance_policy = guidance_policy
        self.divergence_threshold = divergence_threshold
        self.divergence_momentum = divergence_momentum
        self.combine = combine
        self.apg_eta = apg_eta
        self.apg_threshold = apg_threshold
        self.interval = (float(interval[0]), float(interval[1]))
        self.prefills_per_tick = prefills_per_tick
        self.bucket = bucket
        self.kv = kv
        self.kv_dtype = kv_dtype
        self.page_size = page_size
        self.nb_max = pages_for(self.capacity, page_size)
        self.pass_budget = pass_budget if pass_budget is not None else num_slots
        self.step_mode = step_mode
        # the ragged step's fixed row count: every tick fits
        self.ragged_rows = min(self.pass_budget, 2 * num_slots)
        self.reservation = reservation
        self.queue = ArrivalQueue(max_depth=queue_depth)
        self.pool = StatePool(num_slots)       # slot rows
        # fails fast on stacks the paged arena cannot hold
        self.page_bytes = kv_page_bytes(cfg, page_size, kv_dtype)
        self.num_pages = num_pages if num_pages is not None \
            else 2 * num_slots * self.nb_max
        self.pages = PageAllocator(self.num_pages, page_size, kv_dtype=kv_dtype)
        self.scheduler = Scheduler(self.pass_budget, policy=policy,
                                   starvation_limit=starvation_limit)
        self.metrics = ServeMetrics()
        self.metrics.page_bytes = self.page_bytes
        self.results: dict[str, list[int]] = {}
        self.tick_count = 0

        self.seed = seed
        self._req_seq = 0
        self._states: dict[str, _RequestState] = {}
        self._slots = _SlotArrays(num_slots)
        self._shapes: set = set()              # step shapes used, by the reference's jit keys
        self._pool_p = None                    # one paged pool per layer
        self._staging = None                   # the ragged step's host and device rows

    # -- public API --------------------------------------------------------

    def submit(self, req: ServeRequest) -> bool:
        """Queue a request at the current tick; False = rejected (queue
        full, or the request's plan/length is invalid for this engine)."""
        self.metrics.on_arrival(req.uid, self.tick_count)
        try:
            plan = self._plan_for(req)
            plan.validate_for_ar()
            S = self._prompt_len_for(req)
            # a request that can never fit the pool must not wedge the
            # FCFS head of the queue forever
            if sum(stream_page_needs(plan, S, self.page_size)) > self.num_pages:
                raise ValueError("page need exceeds pool")
        except ValueError:
            self.metrics.on_reject(req.uid, self.tick_count)
            return False
        ok = self.queue.push(req, self.tick_count)
        if not ok:
            self.metrics.on_reject(req.uid, self.tick_count)
        return ok

    def drain(self, max_ticks: int = 100_000) -> None:
        """Tick until queue and slots are empty."""
        while len(self.queue) or self.scheduler.n_active:
            if self.tick_count >= max_ticks:
                raise RuntimeError(f"engine did not drain in {max_ticks} ticks")
            self.tick()

    def serve(self, requests: list[ServeRequest]) -> dict[str, list[int]]:
        """Submit everything now, drain, return uid -> generated tokens."""
        return self.serve_trace(requests, [0] * len(requests))

    def serve_trace(self, requests: list[ServeRequest], arrivals,
                    max_ticks: int = 100_000) -> dict[str, list[int]]:
        """Drive an arrival trace: ``requests[i]`` is submitted once
        ``arrivals[i]`` ticks (relative to now, non-decreasing) have
        elapsed; drains and returns uid -> generated tokens."""
        start = self.tick_count
        i = 0
        while i < len(requests) or self.scheduler.n_active or len(self.queue):
            if self.tick_count - start >= max_ticks:
                raise RuntimeError(f"trace did not drain in {max_ticks} ticks")
            while i < len(requests) and start + int(arrivals[i]) <= self.tick_count:
                self.submit(requests[i])
                i += 1
            self.tick()
        return {r.uid: self.results[r.uid] for r in requests if r.uid in self.results}

    @torch.no_grad()
    def tick(self) -> TickPlan:
        timer = TickTimer(self.tick_count)
        now = self.tick_count
        # metrics objects are replaceable (benchmarks reset them between
        # warm-up and measurement): keep the byte pricing installed
        self.metrics.page_bytes = self.page_bytes
        with timer.phase("admit"):
            self._expire_queue(now)
            self._admit_paged(now)
            self.metrics.note_pages(self.pages.n_in_use, now)
        with timer.phase("schedule"):
            plan = self.scheduler.plan_tick()
        with timer.phase("step"):
            sampled, divs = self._execute(plan) if plan.in_flight else ([], [])
        with timer.phase("finalize"):
            events = self.scheduler.commit(plan)
            for ev, nxt, dv in zip(events, sampled, divs):
                state = self._states[ev.uid]
                if ev.done:
                    self._finalize(ev.uid, now)       # last sample discarded
                    continue
                if self.stop_on_eos and nxt == EOS:
                    self._finalize(ev.uid, now)
                    continue
                state.generated.append(int(nxt))
                slot = state.slot
                self._slots.tok[slot] = nxt
                self._slots.pos[slot] += 1
                self._slots.lstep[slot] += 1
                self.metrics.on_token(ev.uid, now, cond=ev.mode is Mode.COND)
                cursor = state.cursor
                if ev.mode is Mode.FULL and isinstance(cursor, DynamicPlanCursor) \
                        and cursor.observe(dv):
                    # the EMA'd cond/uncond divergence crossed the policy's
                    # threshold: every remaining plan-FULL step runs COND
                    self.metrics.on_policy_switch(ev.uid, now, step=cursor.switch_step,
                                                  elided=cursor.elided_uncond_passes())
                if not state.uncond_dead and not cursor.done and cursor.mode is Mode.COND:
                    # the schedule just crossed into COND: the uncond stream
                    # is dead, its pages go back to the shared pool now
                    state.uncond_dead = True
                    self.metrics.on_phase_transition(ev.uid, now)
                    self.metrics.on_reclaim(ev.uid, now, self._release_uncond(ev.uid))
            self.metrics.record_tick(
                now, n_full=plan.n_full, n_cond=plan.n_cond, budget=plan.budget,
                active=self.scheduler.n_active, queue_depth=len(self.queue),
                pages_in_use=self.pages.n_in_use)
        self.metrics.on_tick_timing(timer.finish())
        self.tick_count += 1
        return plan

    def kv_hbm_bytes(self) -> dict:
        """Reserved vs peak-in-use KV arena bytes, from the page price alone
        (asking never allocates the pool)."""
        return {"kv": "paged", "kv_dtype": self.kv_dtype,
                "reserved_bytes": self.num_pages * self.page_bytes,
                "page_bytes": self.page_bytes,
                "peak_in_use_bytes": self.metrics.peak_bytes_in_use,
                "num_pages": self.num_pages,
                "page_size": self.page_size}

    def autotune_budget(self) -> dict:
        raise _later('pass_budget="auto" (the roofline autotuner)', "A11")

    # -- admission ---------------------------------------------------------

    def _expire_queue(self, now: int) -> None:
        for dead in self.queue.expire(now):
            self.metrics.on_expire(dead.uid, now)

    def _plan_for(self, req: ServeRequest) -> GuidancePlan:
        if req.plan is not None:
            if req.plan.total_steps > self.max_new:
                raise ValueError(f"plan of {req.plan.total_steps} steps "
                                 f"exceeds engine max_new={self.max_new}")
            base = req.plan
        else:
            total = max(1, min(req.max_new_tokens, self.max_new))
            frac = (self.selective_fraction if req.selective_fraction is None
                    else req.selective_fraction)
            base = GuidancePlan.suffix(total, frac, req.guidance_scale)
        # the bound plan: what admission, reservation and the pass budget
        # price, an upper bound on FULL steps
        return self._policy_for(base).bound_plan()

    def _policy_for(self, plan: GuidancePlan) -> GuidancePolicy:
        return make_policy(self.guidance_policy, plan,
                           threshold=self.divergence_threshold,
                           momentum=self.divergence_momentum,
                           interval=self.interval)

    def _cursor_for(self, plan: GuidancePlan) -> PlanCursor:
        policy = self._policy_for(plan)
        if isinstance(policy, DivergenceGuidancePolicy):
            return policy.cursor(step=0, passes_executed=0, switch_step=None, ema=0.0)
        return policy.cursor(step=0, passes_executed=0)

    def _eff_scale(self, uid: str, lstep: int | None = None) -> np.float32:
        """Combine-stage guidance scale for ``uid``'s next sample: flat,
        except under interval combine, where it is 1.0 outside
        ``[start, stop)`` of the plan's steps."""
        state = self._states[uid]
        if self.combine != "interval":
            return np.float32(state.req.guidance_scale)
        if lstep is None:
            lstep = int(self._slots.lstep[state.slot])
        total = state.cursor.plan.total_steps
        a = round_half_up(total * self.interval[0])
        b = round_half_up(total * self.interval[1])
        return np.float32(state.cursor.plan.guidance_scale if a <= lstep < b else 1.0)

    def _combine(self, l_u, l_c, scales):
        """The configured combine with a (n,) float32 scale per row: Eq. 1
        (``cfg``/``interval``; B3) or APG (``apg``; B2). Rows paired with
        themselves (u == c) come out as c exactly."""
        if self.combine == "apg":
            return apg_combine(l_u, l_c, scales, eta=self.apg_eta,
                               threshold=self.apg_threshold)
        return cfg_combine_rowscale(l_u, l_c, scales)

    def _sample(self, logits, uids, temps, keys, steps):
        """Next tokens (n,) on the device from logits (n, V) float32. Rows
        ``i < len(uids)`` are requests, the rest padding. Greedy at
        temperature 0; above, a draw from a generator seeded by the
        request's key and ``steps[i]``, as the reference folds its key
        with the step."""
        nxt = logits.argmax(dim=-1)
        for i in np.flatnonzero(np.asarray(temps[:len(uids)]) > 0):
            gen = torch.Generator(device=logits.device)
            gen.manual_seed((int(keys[i]) << 24) + int(steps[i]))
            probs = torch.softmax(logits[i] / float(temps[i]), dim=-1)
            nxt[i] = torch.multinomial(probs, 1, generator=gen)[0]
        return nxt

    def _prompt_len_for(self, req: ServeRequest) -> int:
        S = self.prompt_len if req.prompt_len is None else req.prompt_len
        if not 1 <= S <= self.prompt_len:
            raise ValueError(f"prompt_len {S} outside [1, {self.prompt_len}]")
        return S

    def _tokenize(self, prompt, length: int) -> np.ndarray:
        if isinstance(prompt, str):
            ids = encode(prompt, self.cfg.vocab_size, length)
        else:
            ids = list(prompt)[:length]
            ids = ids + [PAD] * (length - len(ids))
        return np.asarray(ids, np.int32)

    def _admit_paged(self, now: int) -> None:
        """Pop admissible requests, prefill them in per-length-bucket
        batches (one forward serves k > 1 admissions of a bucket),
        then emit the admission events in queue order. Eager reservation:
        admission needs the full worst-case page span of both streams."""
        quota = min(self.scheduler.admission_quota(self.pool.n_free),
                    self.prefills_per_tick)
        batch: list[_PrefillItem] = []
        while len(batch) < quota:
            req = self.queue.peek()
            if req is None:
                break
            item = self._try_admit_eager(req, self._plan_for(req), self._prompt_len_for(req))
            if item is None:
                break                         # head-of-line waits for pages
            batch.append(item)
        if not batch:
            return
        if self._pool_p is None:
            self._pool_p = T.paged_cache_specs(self.cfg, self.num_pages, self.page_size,
                                               kv_dtype=self.kv_dtype, device=self.device)
        groups: dict[int, list] = {}
        for item in batch:
            groups.setdefault(_bucket(item.true_len), []).append(item)
        tok0_of: dict[str, int] = {}
        for Sb in sorted(groups):
            items = groups[Sb]
            tok0 = self._prefill_paged_group(Sb, items).cpu()
            for i, it in enumerate(items):
                tok0_of[it.req.uid] = int(tok0[i])
        # bookkeeping in queue order, not bucket order
        for it in batch:
            uid = it.req.uid
            state = self._states[uid]
            plan = state.cursor.plan
            self.metrics.on_admit(uid, now, total_steps=plan.total_steps,
                                  full_steps=plan.denoiser_passes() - plan.total_steps,
                                  cached=False)
            t0 = tok0_of[uid]
            if self.stop_on_eos and t0 == EOS:
                self._finalize(uid, now)
                continue
            self._slots.tok[it.slot] = t0
            state.generated.append(t0)
            self.metrics.on_token(uid, now)           # TTFT: prefill emits

    def _try_admit_eager(self, req: ServeRequest, plan: GuidancePlan,
                         S: int) -> _PrefillItem | None:
        need_c, need_u = stream_page_needs(plan, S, self.page_size)
        if self.pages.n_free < need_c + need_u:
            return None
        self.queue.pop()
        self.pages.alloc(req.uid, "c", need_c)
        if need_u:
            self.pages.alloc(req.uid, "u", need_u)
        slot = self.pool.alloc(req.uid)
        assert slot is not None
        self._states[req.uid] = _RequestState(req, self._cursor_for(plan), slot)
        self.scheduler.admit(req.uid, slot, self._states[req.uid].cursor,
                             arrival=req.arrival, deadline=req.deadline,
                             priority=req.priority)
        key = self._fresh_key()
        self._slots.pos[slot] = S
        self._slots.scale[slot] = req.guidance_scale
        self._slots.temp[slot] = req.temperature
        self._slots.lstep[slot] = 0
        self._slots.key[slot] = key
        return _PrefillItem(req, slot, self._tokenize(req.prompt, S), S, key)

    def _fresh_key(self) -> int:
        key = int(np.random.SeedSequence([self.seed, self._req_seq]).generate_state(1)[0])
        self._req_seq += 1
        return key

    def _prefill_paged_group(self, Sb: int, items: list[_PrefillItem]):
        """Both streams' prefill of one length bucket, padded to a pow2
        count of rows: the forwards, token 0 from each row's last position,
        and the KV scattered through the rows' block tables (padding and
        uncovered positions drop). -> token 0 per row (device)."""
        kb = _bucket(len(items))
        self._seen(("prefill", Sb, kb), step=False)
        nb_pre = pages_for(Sb, self.page_size)
        tokens = np.full((kb, Sb), PAD, np.int32)
        true_len = np.ones(kb, np.int64)
        btc = np.full((kb, nb_pre), self.num_pages, np.int32)
        btu = np.full((kb, nb_pre), self.num_pages, np.int32)
        scales = np.zeros(kb, np.float32)
        temps = np.zeros(kb, np.float32)
        for i, it in enumerate(items):
            tokens[i, :it.true_len] = it.tokens
            true_len[i] = it.true_len
            btc[i] = self.pages.table(it.req.uid, "c", nb_pre)
            btu[i] = self.pages.table(it.req.uid, "u", nb_pre)
            scales[i] = self._eff_scale(it.req.uid, 0)
            temps[i] = it.req.temperature
        model, ps = self.model, self.page_size
        tok = self._dev(tokens, torch.long)
        h_c, caches_c = model(tok, want_caches=True)
        # the null stream: all PAD (== the reference's null_prompt)
        h_u, caches_u = model(torch.full_like(tok, PAD), want_caches=True)
        rows = torch.arange(kb, device=self.device)
        last = self._dev(true_len - 1)
        l_c = model.unembed(h_c[rows, last][:, None])[:, 0].float()
        l_u = model.unembed(h_u[rows, last][:, None])[:, 0].float()
        logits = self._combine(l_u, l_c, self._dev(scales))
        tok0 = self._sample(logits, [it.req.uid for it in items], temps,
                            [it.key for it in items], np.zeros(kb, np.int64))
        col = np.arange(Sb) // ps
        offs = self._dev(np.tile(np.arange(Sb) % ps, kb))
        pages_c = self._dev(btc[:, col].reshape(-1))
        pages_u = self._dev(btu[:, col].reshape(-1))
        for pool, cc, cu in zip(self._pool_p, caches_c, caches_u):
            A.paged_scatter_prefill(pool, cc, pages_c, offs)
            A.paged_scatter_prefill(pool, cu, pages_u, offs)
        return tok0

    def _release_uncond(self, uid: str) -> int:
        """Free a request's unconditional pages at the COND transition."""
        return self.pages.free(uid, "u")

    def _finalize_state(self, uid: str) -> _RequestState:
        """Free the slot and pages and publish the result."""
        state = self._states.pop(uid)
        self.pool.free(state.slot)
        self.pages.free_all(uid)
        self.scheduler.release(uid)
        self.results[uid] = state.generated
        return state

    def _finalize(self, uid: str, now: int) -> None:
        state = self._finalize_state(uid)
        self.metrics.on_complete(uid, now, state.cursor.passes_executed)

    # -- step functions ------------------------------------------------------

    def _dev(self, a, dtype=None):
        """A host array on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, dtype=dtype)

    def _seen(self, key: tuple, *, step: bool) -> None:
        """Note the first use of a step shape: what the reference counts as
        a compile at jit-cache-miss time (``step_compiles`` for steps)."""
        if key not in self._shapes:
            self._shapes.add(key)
            if step:
                self.metrics.on_step_compile(self.tick_count)

    def _paged_step(self, f: dict, c: dict):
        """Mixed-phase decode step for one occupancy signature: the FULL
        group's two streams and the COND group's cond stream through their
        block tables, per-row positions (B9/B10). -> (next tokens of each
        group, FULL divergences), None for an empty group."""
        n_full, n_cond = len(f["tok"]), len(c["tok"])
        self._seen(("pstep", n_full, n_cond), step=True)
        model = self.model
        f_next = c_next = f_div = None
        if n_full:
            emb = model.embed_tokens(self._dev(f["tok"], torch.long)[:, None])
            pos = self._dev(f["pos"])
            h_c, _ = model.decode_step_paged(emb, self._pool_p, self._dev(f["btc"]), pos)
            h_u, _ = model.decode_step_paged(emb, self._pool_p, self._dev(f["btu"]), pos)
            l_c = model.unembed(h_c)[:, 0, :].float()
            l_u = model.unembed(h_u)[:, 0, :].float()
            logits = self._combine(l_u, l_c, self._dev(f["scale"]))
            f_next = self._sample(logits, f["uids"], f["temp"], f["key"], 1 + f["lstep"])
            f_div = torch.sqrt(((l_c - l_u) ** 2).sum(-1))
        if n_cond:
            emb = model.embed_tokens(self._dev(c["tok"], torch.long)[:, None])
            h_c, _ = model.decode_step_paged(emb, self._pool_p, self._dev(c["btc"]),
                                             self._dev(c["pos"]))
            logits = model.unembed(h_c)[:, 0, :].float()
            c_next = self._sample(logits, c["uids"], c["temp"], c["key"], 1 + c["lstep"])
        return f_next, c_next, f_div

    def _ragged_step(self, st: dict, uids: list):
        """One fixed-shape decode step for the whole tick's flat pass list
        (B7/B8). ``u_idx[r]`` names the row carrying row r's unconditional
        logits: the uncond pair row for FULL output rows, r itself
        everywhere else, where the combine returns c exactly."""
        self._seen(("rstep", self.ragged_rows), step=True)
        model, dev, host = self.model, st["dev"], st["host"]
        emb = model.embed_tokens(dev["tok"].long()[:, None])
        h, _ = model.decode_step_paged(emb, self._pool_p, dev["bt"], dev["pos"],
                                       phase=dev["phase"])
        logits = model.unembed(h)[:, 0, :].float()
        u_idx = dev["u_idx"].long()
        combined = self._combine(logits[u_idx], logits, dev["scale"])
        nxt = self._sample(combined, uids, host["temp"], host["rkey"], 1 + host["lstep"])
        # per-output-row divergence; self-paired rows read exactly 0
        div = torch.sqrt(((logits - logits[u_idx]) ** 2).sum(-1))
        return nxt, div

    # -- execution ---------------------------------------------------------

    def _execute(self, plan: TickPlan) -> tuple[list[int], list[float]]:
        """Run one mixed-phase step; returns sampled next-tokens and the
        per-entry cond/uncond divergence norms (0.0 for COND entries), both
        aligned with ``plan.full + plan.cond``."""
        self.metrics.on_step_launch(self.tick_count)
        if self.step_mode == "ragged":
            return self._harvest_ragged(*self._dispatch_ragged(plan))
        nf_b = _bucket(plan.n_full) if self.bucket else plan.n_full
        nc_b = _bucket(plan.n_cond) if self.bucket else plan.n_cond
        f = self._group(plan.full, nf_b, full=True)
        c = self._group(plan.cond, nc_b, full=False)
        f_next, c_next, f_div = self._paged_step(f, c)
        toks = [] if f_next is None else f_next[:plan.n_full].tolist()
        toks += [] if c_next is None else c_next[:plan.n_cond].tolist()
        divs = [] if f_div is None else f_div[:plan.n_full].tolist()
        return toks, divs + [0.0] * plan.n_cond

    def _group(self, entries, n: int, *, full: bool) -> dict:
        """Host rows of one signature group, padded to ``n`` with
        out-of-range tables (reads clamp, writes drop)."""
        slots = np.asarray([e.slot for e in entries], np.int64)
        pad = n - len(slots)

        def take(a):
            return np.concatenate([a[slots], np.zeros(pad, a.dtype)])

        g = {"uids": [e.uid for e in entries], "tok": take(self._slots.tok),
             "pos": take(self._slots.pos), "temp": take(self._slots.temp),
             "key": take(self._slots.key), "lstep": take(self._slots.lstep)}
        if full:
            if self.combine == "interval":
                g["scale"] = np.asarray([self._eff_scale(e.uid) for e in entries] + [0.0] * pad,
                                        np.float32)
            else:
                g["scale"] = take(self._slots.scale)
        for stream in ("c", "u") if full else ("c",):
            bt = np.full((n, self.nb_max), self.num_pages, np.int32)
            for i, e in enumerate(entries):
                bt[i] = self.pages.table(e.uid, stream, self.nb_max)
            g["bt" + stream] = bt
        return g

    def _ragged_staging(self) -> dict:
        """The ragged step's rows: one int32 and one float32 host buffer
        (pinned on a GPU), named views into them, and the sampling keys."""
        if self._staging is None:
            R, nb = self.ragged_rows, self.nb_max
            pin = self.device.type == "cuda"
            ibuf = torch.zeros(R * (nb + len(_RAGGED_INT)), dtype=torch.int32, pin_memory=pin)
            fbuf = torch.zeros(2 * R, dtype=torch.float32, pin_memory=pin)
            host = _ragged_views(ibuf.numpy(), fbuf.numpy(), R, nb)
            host["rkey"] = np.zeros(R, np.uint32)
            self._staging = {"ibuf": ibuf, "fbuf": fbuf, "host": host, "dev": None}
        return self._staging

    def _dispatch_ragged(self, plan: TickPlan) -> tuple:
        """Stage the tick's rows and launch the ragged step. Row layout
        (``plan.pass_rows()``): rows [0, in_flight) are the output rows,
        every entry's cond pass in ``plan.full + plan.cond`` order; rows
        [in_flight, in_flight + n_full) the FULL entries' uncond passes;
        the rest padding (phase 0, out-of-range tables). The rows go to the
        device in two copies; nothing here waits for the device.
        -> (next tokens, divergences, n_out), device tensors unforced."""
        R = self.ragged_rows
        rows = plan.pass_rows()
        assert len(rows) <= R, (len(rows), R)
        n_out = plan.in_flight
        st = self._ragged_staging()
        h = st["host"]
        h["bt"].fill(self.num_pages)
        for name in ("tok", "pos", "lstep", "phase", "scale", "temp", "rkey"):
            h[name].fill(0)
        h["u_idx"][:] = np.arange(R, dtype=np.int32)   # self-pair: Eq. 1 identity
        for r, pr in enumerate(rows):
            slot = pr.entry.slot
            h["bt"][r] = self.pages.table(pr.entry.uid, pr.stream, self.nb_max)
            h["tok"][r] = self._slots.tok[slot]
            h["pos"][r] = self._slots.pos[slot]
            h["scale"][r] = self._eff_scale(pr.entry.uid) \
                if self.combine == "interval" else self._slots.scale[slot]
            h["temp"][r] = self._slots.temp[slot]
            h["rkey"][r] = self._slots.key[slot]
            h["lstep"][r] = self._slots.lstep[slot]
            h["phase"][r] = 1
        h["u_idx"][:plan.n_full] = n_out + np.arange(plan.n_full)
        st["dev"] = _ragged_views(st["ibuf"].to(self.device, non_blocking=True),
                                  st["fbuf"].to(self.device, non_blocking=True),
                                  R, self.nb_max)
        uids = [pr.entry.uid for pr in rows[:n_out]]
        nxt, div = self._ragged_step(st, uids)
        return nxt, div, n_out

    def _harvest_ragged(self, nxt, div, n_out: int) -> tuple:
        """Bring the step's outputs to the host: the only point where the
        host waits for the device in ragged mode."""
        return nxt[:n_out].tolist(), div[:n_out].tolist()
