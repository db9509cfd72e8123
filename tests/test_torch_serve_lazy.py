"""Lazy reservation on the port's paged arena (growth on demand, the shared
uncond prompt prefix with copy-on-write, priority preemption and resume by
recompute) against the reference's lazy engine on the same converted
weights, on the CPU at the reduced llama3.2-1b with pages of 4, with
``tests/test_torch_serve.py``'s harness (events and counters equal exactly,
greedy tokens equal up to the first undecided step, logits within its
``LOGIT_TOL``), and against the port's own simulator and eager engine."""

import numpy as np
import pytest
import torch

from repro.core.selective import GuidancePlan as JPlan
from repro_torch.core.selective import GuidancePlan
from repro_torch.serve import ContinuousEngine, ServeRequest, SimRequest, simulate
from test_torch_serve import World, _check, _Recording, _run

LAZY = dict(num_slots=6, pass_budget=6, prompt_len=8, max_new=6, stop_on_eos=False,
            kv="paged", page_size=4, prefills_per_tick=2, num_pages=10, reservation="lazy")
LENS, PRIOS, ARRIVALS = [5, 6, 8, 5, 6, 8], [0, 1, 0, 2, 1, 0], [0, 0, 1, 2, 2, 3]
COUNTERS = ("pages_grown", "preemptions", "shared_page_hits", "cow_copies", "resumes",
            "pages_reclaimed", "peak_pages_in_use", "completed", "denoiser_passes",
            "tokens_emitted")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The engines run thousands of small ops: on a machine shared by
    several test workers, torch's thread pool spends more time waiting than
    computing, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return World()


def _contended(R, plan_cls):
    """``test_serve_growth.py``'s contended trace: mixed lengths and
    priorities in a 10-page pool."""
    plan = plan_cls.suffix(6, 0.5, 4.0)
    return [R(uid=f"r{i}", prompt=f"req {i}", max_new_tokens=6, plan=plan,
              prompt_len=LENS[i], priority=PRIOS[i]) for i in range(6)]


def _sim_counters(kw):
    trace = [SimRequest(f"r{i}", ARRIVALS[i], GuidancePlan.suffix(6, 0.5, 4.0),
                        prompt_len=LENS[i], priority=PRIOS[i]) for i in range(6)]
    rep = simulate(trace, num_slots=6, pass_budget=6, kv="paged", page_size=4,
                   num_pages=kw["num_pages"], reservation="lazy", prefills_per_tick=2,
                   kv_dtype=kw.get("kv_dtype", "bf16"), step_mode=kw.get("step_mode"),
                   on_tick=lambda t, p, s, q: p.check())
    return rep.metrics


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("step_mode", ["ragged", "signature"])
def test_lazy_contended_trace_equals_reference_and_sim(world, kv_dtype, step_mode):
    """Preemption, resume, growth, prefix sharing and copy-on-write, event
    for event with the reference engine; the counters also equal the port
    simulator's on the same trace (``test_serve_growth.py``'s contended
    engine == sim contract)."""
    kw = dict(LAZY, kv_dtype=kv_dtype, step_mode=step_mode)

    def make(R):
        return _contended(R, GuidancePlan if R is ServeRequest else JPlan)

    jeng, jout, teng, tout = _run(world, kw, make, ARRIVALS)
    _check(world, jeng, jout, teng, tout, make(ServeRequest))
    keys = sorted(k for k in teng._shapes if k[0] in ("rstep", "pstep"))
    assert keys == sorted(k for k in jeng._jit if k[0] in ("rstep", "pstep"))
    em, sm = teng.metrics, _sim_counters(kw)
    assert em.preemptions > 0 and em.resumes == em.preemptions
    assert em.cow_copies > 0 and em.pages_grown > 0
    for key in COUNTERS:
        assert getattr(em, key) == getattr(sm, key), key
    assert em.ticks == sm.ticks
    assert em.trace.keys() == sm.trace.keys()


def test_lazy_tokens_equal_eager(world):
    """``test_serve_growth.py``: on a roomy pool lazy reservation grows,
    shares and copies on write, and its tokens are the eager engine's."""
    lens = [5, 8, 6, 5]

    def reqs():
        return [ServeRequest(uid=f"r{i}", prompt=f"trace request {i}", max_new_tokens=6,
                             prompt_len=lens[i]) for i in range(4)]

    kw = dict(LAZY, num_slots=4, pass_budget=4, num_pages=None, prefills_per_tick=2)
    eager = ContinuousEngine(world.model, world.cfg, **dict(kw, reservation="eager"))
    lazy = ContinuousEngine(world.model, world.cfg, **kw)
    out_eager = eager.serve_trace(reqs(), [0, 0, 1, 2])
    assert lazy.serve_trace(reqs(), [0, 0, 1, 2]) == out_eager
    m = lazy.metrics
    assert m.pages_grown > 0 and m.shared_page_hits > 0 and m.cow_copies > 0
    assert m.peak_pages_in_use < eager.metrics.peak_pages_in_use
    lazy.pages.check()
    assert lazy.pages.n_free == lazy.pages.num_pages


@pytest.mark.parametrize("step_mode", ["ragged", "signature"])
def test_preempt_resume_token_identical_to_solo(world, step_mode):
    """A tight pool makes the high-priority late arrival evict the running
    request; the victim's resumed tokens equal its solo run's."""
    plan = GuidancePlan.suffix(6, 0.5, 4.0)

    def mk():
        return [ServeRequest(uid="weak", prompt="weak request", max_new_tokens=6, plan=plan),
                ServeRequest(uid="strong", prompt="strong request", max_new_tokens=6,
                             plan=plan, priority=5)]

    kw = dict(LAZY, num_slots=4, step_mode=step_mode)
    eng = ContinuousEngine(world.model, world.cfg, **dict(kw, num_pages=7))
    out = eng.serve_trace(mk(), [0, 2])
    assert eng.metrics.preemptions >= 1 and eng.metrics.resumes == eng.metrics.preemptions
    for req in mk():
        solo = ContinuousEngine(world.model, world.cfg, **dict(kw, num_pages=None))
        assert solo.serve([req])[req.uid] == out[req.uid], req.uid
    eng.pages.check()
    assert eng.pages.n_free == eng.pages.num_pages


def test_shared_prefix_bitwise_equals_unshared(world):
    """Requests whose uncond prompt prefix comes from the canonical shared
    pages compute the same logits, bit for bit, as with private pages (a
    solo lazy run is the founder and shares nothing)."""
    def req(i, uid):
        return ServeRequest(uid=uid, prompt=f"prefix sharer {i}", max_new_tokens=6,
                            prompt_len=6)

    kw = dict(LAZY, num_slots=4, pass_budget=4, num_pages=None, prefills_per_tick=1)
    eng = _Recording(world.model, world.cfg, **kw)
    out = eng.serve_trace([req(i, f"s{i}") for i in range(3)], [0, 1, 2])
    assert eng.metrics.shared_page_hits > 0 and eng.metrics.cow_copies > 0
    for i in range(3):
        solo = _Recording(world.model, world.cfg, **kw)
        assert solo.serve([req(i, "x")])["x"] == out[f"s{i}"]
        for a, b in zip(eng.logits[f"s{i}"], solo.logits["x"]):
            assert np.array_equal(a, b), f"s{i}"
    eng.pages.check()
    assert eng.pages.n_free == eng.pages.num_pages


def test_int8_copy_on_write_copies_scales(world):
    """The copy behind a copy-on-write detach moves every layer's int8
    values and their float32 scales, and touches no other page."""
    eng = ContinuousEngine(world.model, world.cfg, **dict(LAZY, kv_dtype="int8"))
    eng.serve([ServeRequest(uid="a", prompt="seed the pool", max_new_tokens=2, prompt_len=5)])
    g = torch.Generator().manual_seed(0)
    for pool in eng._pool_p:
        for name, t in pool.items():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8))
            else:
                t.copy_(torch.rand(t.shape, generator=g))
    before = [{n: t.clone() for n, t in pool.items()} for pool in eng._pool_p]
    eng._copy_page(3, 7)
    for pool, old in zip(eng._pool_p, before):
        assert set(pool) == {"k", "v", "k_scale", "v_scale"}
        for name, t in pool.items():
            assert torch.equal(t[7], old[name][3]), name
            keep = [p for p in range(t.shape[0]) if p != 7]
            assert torch.equal(t[keep], old[name][keep]), name


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_lazy_sharing_trace_equals_reference(world, kv_dtype):
    """A roomy pool where a request of an earlier one's length joins while
    that prefix is live: shared uncond pages and copy-on-write, event for
    event with the reference."""
    lens = [5, 8, 6, 5]

    def make(R):
        return [R(uid=f"r{i}", prompt=f"trace request {i}", max_new_tokens=6,
                  prompt_len=lens[i]) for i in range(4)]

    kw = dict(LAZY, num_slots=4, pass_budget=4, num_pages=None, kv_dtype=kv_dtype)
    jeng, jout, teng, tout = _run(world, kw, make, [0, 0, 1, 2])
    _check(world, jeng, jout, teng, tout, make(ServeRequest))
    m = teng.metrics
    assert m.shared_page_hits > 0 and m.cow_copies > 0 and m.pages_grown > 0
