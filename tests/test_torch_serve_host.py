"""The serve stack's framework-free copies equal the reference's: the arrival
queue, the scheduler (``plan_tick``, ``commit``, ``pass_rows``), the guidance
policies' cursors, the metric folds and histograms, the page allocator with
its share registries, the host tier's bookkeeping and the page prices.
Exact, no tolerance: the copies run the same Python and numpy code on the
same inputs, so every decision, counter and event must be equal."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import registry as jreg
from repro.core import policy as jpol
from repro.core import selective as jsel
from repro.serve import metrics as jmet
from repro.serve import queue as jq
from repro.serve import scheduler as jsch
from repro.serve import state as jstate
from repro.serve.obs import hist as jhist
from repro.serve.obs import trace as jtrace
from repro_torch.configs import registry as treg
from repro_torch.core import policy as tpol
from repro_torch.core import selective as tsel
from repro_torch.serve import metrics as tmet
from repro_torch.serve import queue as tq
from repro_torch.serve import scheduler as tsch
from repro_torch.serve import state as tstate
from repro_torch.serve.obs import hist as thist
from repro_torch.serve.obs import timing as ttiming
from repro_torch.serve.obs import trace as ttrace

SIDES = ((jsel, jq, jsch, jpol), (tsel, tq, tsch, tpol))


def _random_requests(rng, n):
    """(uid, arrival tick, total, fraction, scale, ttl, priority) rows."""
    return [(f"r{i}", int(rng.integers(0, 12)), int(rng.integers(1, 9)),
             float(rng.choice([0.0, 0.25, 0.5, 1.0])), float(rng.choice([1.0, 3.0])),
             None if rng.random() < 0.6 else int(rng.integers(1, 6)),
             int(rng.integers(0, 3))) for i in range(n)]


def _drive(side, rows, *, budget, slots, policy, depth):
    """A host-only serve loop over one side's queue and scheduler: submit at
    arrival, expire, admit up to the quota, plan, commit, release. Returns
    everything it observed, in order."""
    sel, q, sch, _ = side
    queue = q.ArrivalQueue(max_depth=depth)
    sched = sch.Scheduler(budget, policy=policy, starvation_limit=2)
    free = list(range(slots))
    log, i, tick = [], 0, 0
    rows = sorted(rows, key=lambda r: r[1])
    while i < len(rows) or len(queue) or sched.n_active:
        while i < len(rows) and rows[i][1] <= tick:
            uid, _, total, frac, scale, ttl, prio = rows[i]
            req = q.ServeRequest(uid=uid, prompt=[5, 6], max_new_tokens=total,
                                 guidance_scale=scale, ttl=ttl, priority=prio)
            log.append(("push", uid, queue.push(req, tick)))
            i += 1
        log.append(("expire", [r.uid for r in queue.expire(tick)]))
        for _ in range(sched.admission_quota(len(free))):
            req = queue.pop()
            if req is None:
                break
            total = req.max_new_tokens
            frac = next(r[3] for r in rows if r[0] == req.uid)
            cursor = sel.PlanCursor(sel.GuidancePlan.suffix(total, frac, req.guidance_scale))
            sched.admit(req.uid, free.pop(0), cursor, arrival=req.arrival,
                        deadline=req.deadline, priority=req.priority)
        plan = sched.plan_tick()
        log.append(("plan", [e.uid for e in plan.full], [e.uid for e in plan.cond],
                    plan.budget, plan.cost, plan.signature, plan.n_rows,
                    [(r.entry.uid, r.stream) for r in plan.pass_rows()]))
        for ev in sched.commit(plan):
            log.append(("event", ev.uid, ev.mode.value, ev.done))
            if ev.done:
                free.append(next(e.slot for e in sched.active() if e.uid == ev.uid))
                free.sort()
                sched.release(ev.uid)
        tick += 1
        assert tick < 500
    log.append(("stats", vars(queue.stats)))
    return log


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("policy", ["phase", "static"])
def test_queue_and_scheduler_decisions_equal(seed, policy):
    rows = _random_requests(np.random.default_rng(seed), 14)
    kw = dict(budget=4 + seed % 3, slots=3 + seed % 2, policy=policy, depth=6)
    ref = _drive(SIDES[0], rows, **kw)
    assert _drive(SIDES[1], rows, **kw) == ref
    assert any(e[0] == "plan" and e[1] and e[2] for e in ref) or policy == "static"


def test_bucket_pow2_and_admission_cutoff_equal():
    for n in range(0, 40):
        assert tsch.bucket_pow2(n) == jsch.bucket_pow2(n)
    for now in range(5):
        for pipelined in (False, True):
            assert tsch.admission_cutoff(now, pipelined=pipelined) == \
                jsch.admission_cutoff(now, pipelined=pipelined)


@pytest.mark.parametrize("name", ["static", "divergence", "interval"])
@pytest.mark.parametrize("seed", range(3))
def test_policy_cursors_equal(name, seed):
    rng = np.random.default_rng(seed)
    for total in (1, 4, 9):
        for frac in (0.0, 0.3, 1.0):
            kw = dict(threshold=0.5, momentum=0.3, interval=(0.2, 0.7))
            jp = jpol.make_policy(name, jsel.GuidancePlan.suffix(total, frac, 3.0), **kw)
            tp = tpol.make_policy(name, tsel.GuidancePlan.suffix(total, frac, 3.0), **kw)
            jb, tb = jp.bound_plan(), tp.bound_plan()
            assert [m.value for m in tb.modes()] == [m.value for m in jb.modes()]
            assert tb.guidance_scale == jb.guidance_scale
            assert tp.max_full_steps() == jp.max_full_steps()
            jc, tc = jp.cursor(), tp.cursor()
            while not jc.done:
                assert (tc.mode.value, tc.step, tc.passes_executed) == \
                    (jc.mode.value, jc.step, jc.passes_executed)
                if isinstance(jc, jpol.DynamicPlanCursor) and jc.mode is jsel.Mode.FULL:
                    d = float(rng.random())
                    assert tc.observe(d) == jc.observe(d)
                    assert (tc.switch_step, tc.elided_uncond_passes()) == \
                        (jc.switch_step, jc.elided_uncond_passes())
                jc.advance()
                tc.advance()
            assert tc.done and tc.passes_executed == jc.passes_executed


def _metric_calls(rng, n):
    """Interleaved request lifecycles (arrival, admit, tokens, transition,
    reclaim, switch, complete; or arrival then expire or reject) and
    engine-wide calls, ticks non-decreasing."""
    lives = []
    for i in range(n):
        uid, k = f"u{i}", int(rng.integers(1, 6))
        end = rng.choice(["complete", "complete", "expire", "reject"])
        if end != "complete":
            lives.append([("arrival", uid, k), (str(end), uid, k)])
            continue
        life = [("arrival", uid, k), ("admit", uid, k)]
        life += [("token", uid, j) for j in range(k)]
        life += [("transition", uid, k), ("reclaim", uid, k), ("switch", uid, k),
                 ("token", uid, k + 1), ("complete", uid, k)]
        lives.append(life)
    calls, tick = [], 0
    while any(lives):
        tick += int(rng.integers(0, 2))
        if rng.random() < 0.2:
            calls.append((str(rng.choice(["launch", "compile", "pages"])), None, tick,
                          int(rng.integers(1, 6))))
            continue
        life = lives[int(rng.choice([i for i, x in enumerate(lives) if x]))]
        kind, uid, k = life.pop(0)
        calls.append((kind, uid, tick, k))
    return calls


def _replay(met_mod, calls):
    m = met_mod.ServeMetrics()
    m.page_bytes = 4096
    for kind, uid, tick, n in calls:
        if kind == "arrival":
            m.on_arrival(uid, tick)
        elif kind == "admit":
            m.on_admit(uid, tick, total_steps=n + 2, full_steps=n)
        elif kind == "token":
            m.on_token(uid, tick, cond=bool(n % 2))
        elif kind == "reclaim":
            m.on_reclaim(uid, tick, n)
        elif kind == "complete":
            m.on_complete(uid, tick, n)
        elif kind == "launch":
            m.on_step_launch(tick)
        elif kind == "compile":
            m.on_step_compile(tick)
        elif kind == "expire":
            m.on_expire(uid, tick)
        elif kind == "reject":
            m.on_reject(uid, tick)
        elif kind == "transition":
            m.on_phase_transition(uid, tick)
        elif kind == "switch":
            m.on_policy_switch(uid, tick, step=n, elided=n + 1)
        else:
            m.note_pages(n * 3, tick)
            m.record_tick(tick, n_full=n % 3, n_cond=n % 2, budget=4, active=n,
                          queue_depth=n % 4, pages_in_use=n * 3)
    return m


@pytest.mark.parametrize("seed", range(4))
def test_metric_folds_and_summary_equal(seed):
    calls = _metric_calls(np.random.default_rng(seed), 12)
    jm, tm = _replay(jmet, calls), _replay(tmet, calls)
    assert tm.trace.keys() == jm.trace.keys()
    assert ttrace.fold_counters(tm.trace) == jtrace.fold_counters(jm.trace)
    assert tm.summary() == jm.summary()
    assert tm.request_rows() == jm.request_rows()
    assert (tm.peak_pages_in_use, tm.peak_bytes_in_use) == \
        (jm.peak_pages_in_use, jm.peak_bytes_in_use)
    assert ttrace.EVENT_KINDS == jtrace.EVENT_KINDS
    assert ttrace.FOLDED_COUNTERS == jtrace.FOLDED_COUNTERS


def test_log2_histogram_equal():
    rng = np.random.default_rng(3)
    a, b = (thist.Log2Histogram(base=1e-3), jhist.Log2Histogram(base=1e-3))
    a2, b2 = (thist.Log2Histogram(base=1e-3), jhist.Log2Histogram(base=1e-3))
    for v in rng.exponential(0.05, 300):
        a.record(float(v))
        b.record(float(v))
    for v in rng.exponential(0.5, 100):
        a2.record(float(v))
        b2.record(float(v))
    for p in (1, 10, 50, 90, 95, 99, 100):
        assert a.percentile(p) == b.percentile(p)
    assert a.slo_attainment(0.05) == b.slo_attainment(0.05)
    assert a.merge(a2).summary() == b.merge(b2).summary()
    assert sorted(thist.default_histograms()) == sorted(jhist.default_histograms())


def test_tick_timer_segments():
    timer = ttiming.TickTimer(7)
    for name in ttiming.TICK_SEGMENTS:
        with timer.phase(name):
            pass
    t = timer.finish()
    assert t.tick == 7 and [s[0] for s in t.segments] == list(ttiming.TICK_SEGMENTS)
    assert t.duration_s >= sum(t.segment_s().values()) >= 0.0


def _alloc_state(a):
    return (a.n_free, a.n_in_use, sorted(a.owners()),
            {k: list(v) for k, v in sorted(a._owned.items())}, list(a._ref))


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=1, max_value=20), st.sampled_from(["bf16", "int8"]),
       st.lists(st.tuples(st.sampled_from(["alloc", "free", "share", "grow", "cow",
                                           "free_all", "table"]),
                          st.integers(min_value=0, max_value=7),
                          st.integers(min_value=0, max_value=5)),
                min_size=1, max_size=40))
def test_page_allocators_give_equal_grants_tables_and_frees(num_pages, dtype, ops):
    sides = [jstate.PageAllocator(num_pages, 4, kv_dtype=dtype),
             tstate.PageAllocator(num_pages, 4, kv_dtype=dtype)]
    for i, (op, owner, n) in enumerate(ops):
        uid, stream = f"r{owner}", ("c", "u")[n % 2]
        outs = []
        for a in sides:
            try:
                if op == "alloc":
                    out = a.alloc(uid, stream, n)
                elif op == "free":
                    out = a.free(uid, stream)
                elif op == "share":
                    out = a.share(f"s{i}", "c", a.owned(uid, stream))
                elif op == "grow":
                    out = a.grow(uid, stream, n)
                elif op == "cow":
                    out = a.cow(uid, stream, n)
                elif op == "free_all":
                    out = a.free_all(uid)
                else:
                    out = a.table(uid, stream, 6).tolist()
            except (ValueError, KeyError, IndexError) as exc:
                out = type(exc).__name__
            outs.append(out)
        assert outs[1] == outs[0], (op, uid, stream, n)
        assert _alloc_state(sides[1]) == _alloc_state(sides[0])
        sides[1].check()


def test_prefix_registries_and_host_tier_equal():
    def run(state):
        a = state.PageAllocator(16, 4)
        reg = state.PrefixShareRegistry(a)
        out = [a.alloc("a", "u", 3)]
        reg.publish(6, "a")
        out += [reg.lookup(6), reg.acquire(6, "b"), reg.reclaimable(6), reg.release("a"),
                reg.release("b"), a.n_free]
        content = state.ContentPrefixRegistry(a)
        ids = np.asarray([3, 4, 5, 6], np.int32)
        key = state.content_key(ids)
        a.alloc("c", "c", 2)
        content.publish(key, "c", ids=ids, tick=2)
        out += [key, content.matches(key, ids), content.ready(key, 2), content.ready(key, 3),
                content.acquire(key, "d"), content.evict_under_pressure(), a.n_free]
        host = state.HostPagePool(5, page_bytes=100)
        out += [host.put("x", {"c": 2, "u": 1}), host.put("y", {"c": 3}), host.lru_order(),
                host.pages_of("y"), host.drop("y"), host.bytes_in_use]
        host.check()
        out += [state.plan_swap_out(a, host, "c"), state.plan_swap_out(a, None, "c"),
                state.host_pages_for_bytes(1000, 96)]
        for fn in (state.fresh_lazy_needs, state.resume_lazy_needs):
            plan = (jsel if state is jstate else tsel).GuidancePlan.suffix(6, 0.5, 3.0)
            args = (plan, 7, 4) if fn is state.fresh_lazy_needs else (plan, 2, 7, 4)
            out += [fn(*args, shared=True), fn(*args, shared=False)]
        return out

    assert run(tstate) == run(jstate)


def test_state_pool_and_page_needs_equal():
    jp, tp = jstate.StatePool(5), tstate.StatePool(5)
    for op in ["a", "b", "c", -1, "d", -0, "e", "f"]:
        if isinstance(op, str):
            assert tp.alloc(op) == jp.alloc(op)
        else:
            slot = jp.slot_of("b" if op else "a")
            jp.free(slot)
            tp.free(slot)
    assert tp.active() == jp.active() and tp.fragmentation() == jp.fragmentation()
    assert np.array_equal(tp.defrag_plan(), jp.defrag_plan())
    for total in (1, 5, 12):
        for frac in (0.0, 0.5, 1.0):
            for S in (1, 7, 16):
                jplan = jsel.GuidancePlan.suffix(total, frac, 3.0)
                tplan = tsel.GuidancePlan.suffix(total, frac, 3.0)
                assert tstate.stream_page_needs(tplan, S, 4) == \
                    jstate.stream_page_needs(jplan, S, 4)
    for span in range(0, 20):
        assert tstate.pages_for(span, 4) == jstate.pages_for(span, 4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-14b", "yi-9b", "h2o-danube-3-4b"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_kv_page_bytes_equal(arch, kv_dtype):
    for get in ("get_config", "get_smoke_config"):
        jc, tc = getattr(jreg, get)(arch), getattr(treg, get)(arch)
        for ps in (4, 16):
            want = jstate.kv_page_bytes(jc, ps, kv_dtype)
            assert tstate.kv_page_bytes(tc, ps, kv_dtype) == want
            assert tstate.pages_for_pool_bytes(tc, 10 * want + 5, ps, kv_dtype) == \
                jstate.pages_for_pool_bytes(jc, 10 * want + 5, ps, kv_dtype) == 10
