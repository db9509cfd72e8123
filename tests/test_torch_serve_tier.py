"""The port engine's host tier and content prefix cache against the
reference engine on the same converted weights and against the port's
simulator, on the CPU at the reduced llama3.2-1b with pages of 4, with
``tests/test_torch_serve.py``'s harness (events and counters equal
exactly, greedy tokens equal up to the first undecided step, logits within
its ``LOGIT_TOL``); the scenarios are ``tests/test_tier.py``'s.

Host round-trips are bit-exact (bf16 pages; int8 values and their float32
scales through the same slots), and a swap/restore or a content-cache hit
gives the tokens of an uninterrupted or cold run."""

import numpy as np
import pytest
import torch

from repro.core.selective import GuidancePlan as JPlan
from repro_torch.core.selective import GuidancePlan
from repro_torch.models.attention import paged_cache_spec
from repro_torch.serve import (ContinuousEngine, HostPagePool, ServeRequest, SimRequest,
                               simulate)
from repro_torch.serve.state import kv_page_bytes
from test_torch_serve import World, _check, _run

TIER_COUNTERS = ("swap_outs", "swap_ins", "host_evictions", "prefix_hits", "prefix_misses",
                 "recompute_passes_avoided", "pages_grown", "preemptions", "resumes",
                 "shared_page_hits", "cow_copies", "cache_evictions", "completed",
                 "denoiser_passes", "prefill_passes", "tokens_emitted")


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


def _tier_kw(*, num_pages=None, host_pages=16, prefix_cache="length", kv_dtype="bf16",
             prefills=2, num_slots=4, budget=6):
    """``tests/test_tier.py``'s ``_tier_engine`` arguments."""
    from repro_torch.configs.registry import get_smoke_config
    page_bytes = kv_page_bytes(get_smoke_config("llama3.2-1b"), 4, kv_dtype)
    return dict(num_slots=num_slots, pass_budget=budget, prompt_len=8, max_new=6,
                selective_fraction=0.5, stop_on_eos=False, kv="paged", page_size=4,
                num_pages=num_pages, prefills_per_tick=prefills, reservation="lazy",
                kv_dtype=kv_dtype, host_pool_bytes=host_pages * page_bytes,
                prefix_cache=prefix_cache)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_host_roundtrip_bitexact(world, kv_dtype):
    """store -> load is the identity on a pool's page rows: bf16 values, or
    int8 values with their float32 scales through the same slots, into
    slots that are not consecutive, gather padding ignored."""
    pool = [paged_cache_spec(world.cfg, 8, 4, kv_dtype=kv_dtype, device="cpu")
            for _ in range(2)]
    gen = torch.Generator().manual_seed(0)
    for layer in pool:
        for t in layer.values():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int8))
            else:
                t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype) * 3)
    host = HostPagePool(6)
    host.attach(pool)
    assert all(a[n].shape == (6,) + t.shape[1:] and a[n].dtype == t.dtype
               for a, layer in zip(host.arena, pool) for n, t in layer.items())
    host.put("a", {"c": 2})
    host.put("b", {"c": 1})
    host.drop("a")
    placed, _ = host.put("r", {"c": 3})
    slots = placed["c"]
    assert sorted(slots) != list(range(min(slots), min(slots) + 3))   # a broken run
    idx = torch.tensor([2, 0, 7, 0])                                    # padded to 4
    rows = [{n: t.index_select(0, idx) for n, t in layer.items()} for layer in pool]
    host.store(slots, rows)
    back = host.load(slots)
    for got, want in zip(back, rows):
        assert set(got) == set(want) == ({"k", "v"} if kv_dtype == "bf16"
                                         else {"k", "v", "k_scale", "v_scale"})
        for n in want:
            assert got[n].dtype == want[n].dtype
            assert torch.equal(got[n], want[n][:3]), n


def _victim_reqs(R, plan):
    return [R(uid="weak", prompt="weak request", max_new_tokens=6, plan=plan, priority=0),
            R(uid="strong", prompt="strong request", max_new_tokens=6, plan=plan, priority=5)]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_swap_restore_token_identical(world, kv_dtype):
    """``test_tier.py``'s tight-pool preemption: the victim's pages go to
    the host tier and come back; its tokens equal an uninterrupted solo
    run's, with no pass paid on the restore; events and counters equal the
    reference engine's."""
    kw = _tier_kw(num_pages=7, kv_dtype=kv_dtype)

    def make(R):
        return _victim_reqs(R, (GuidancePlan if R is ServeRequest else JPlan).suffix(6, 0.5, 4.0))

    jeng, jout, teng, tout = _run(world, kw, make, [0, 2])
    _check(world, jeng, jout, teng, tout, make(ServeRequest))
    m = teng.metrics
    assert m.preemptions >= 1 and m.swap_outs >= 1 and m.swap_ins == m.resumes >= 1
    assert m.recompute_passes_avoided == 2 * m.swap_ins
    for name in TIER_COUNTERS:
        assert getattr(m, name) == getattr(jeng.metrics, name), name
    for req in make(ServeRequest):
        solo = ContinuousEngine(world.model, world.cfg, **_tier_kw(kv_dtype=kv_dtype))
        assert solo.serve([req])[req.uid] == tout[req.uid], req.uid
    assert teng._host.n_in_use == 0
    teng._host.check()


def _drop_cache(eng):
    """At drain only the content cache's canonical pages stay in use: drop
    them, so that the pool balances."""
    eng.pages.check()
    canon = eng.pages.num_pages - eng.pages.n_free
    assert eng._content.drop_all() == canon
    assert eng.pages.n_free == eng.pages.num_pages


def _popular(R, n):
    return [R(uid=f"h{i}", prompt="popular prompt", max_new_tokens=6) for i in range(n)]


def test_prefix_hit_token_identical_to_cold(world):
    """Repeats of one prompt admit through the content cache (shared cond
    pages, token 0 replayed from the founder's logits) and give a cold solo
    run's tokens; token 0 of each hit equals its founder's; events equal
    the reference engine's."""
    kw = _tier_kw(prefix_cache="content", prefills=1, host_pages=0)
    jeng, jout, teng, tout = _run(world, kw, lambda R: _popular(R, 3), [0, 1, 2])
    _drop_cache(teng)
    _check(world, jeng, jout, teng, tout, _popular(ServeRequest, 3))
    m = teng.metrics
    assert m.prefix_hits == 2 and m.prefix_misses == 1 and m.recompute_passes_avoided == 4
    assert tout["h1"][0] == tout["h2"][0] == tout["h0"][0]
    assert np.array_equal(teng.logits["h1"][0], teng.logits["h0"][0])
    for i in range(3):
        solo = ContinuousEngine(world.model, world.cfg, **kw)
        assert solo.serve([ServeRequest(uid="x", prompt="popular prompt",
                                        max_new_tokens=6)])["x"] == tout[f"h{i}"]


def test_distinct_prompts_miss(world):
    """Different prompts of one length miss: the ids check refuses another
    prompt's KV."""
    eng = ContinuousEngine(world.model, world.cfg,
                           **_tier_kw(prefix_cache="content", prefills=1, host_pages=0))
    out = eng.serve_trace([ServeRequest(uid=f"d{i}", prompt=f"distinct prompt {i}",
                                        max_new_tokens=6) for i in range(3)], [0, 1, 2])
    assert len(out) == 3
    assert eng.metrics.prefix_hits == 0 and eng.metrics.prefix_misses == 3


def test_ttl_expiry_drops_host_checkpoint(world):
    """A swapped-out victim whose deadline passes while it waits is
    expired with its host checkpoint, counted as a host eviction, the tier
    left empty; engine == simulator event for event."""
    plan = GuidancePlan.suffix(8, 0.5, 4.0)
    page_bytes = kv_page_bytes(world.cfg, 4, "bf16")
    eng = ContinuousEngine(world.model, world.cfg, num_slots=2, pass_budget=4, prompt_len=4,
                           max_new=8, stop_on_eos=False, kv="paged", page_size=4, num_pages=6,
                           reservation="lazy", host_pool_bytes=8 * page_bytes)
    eng.serve_trace([ServeRequest(uid="victim", prompt="victim", plan=plan, ttl=3.0,
                                  prompt_len=4),
                     ServeRequest(uid="strong", prompt="strong", plan=plan, prompt_len=4,
                                  priority=5)], [0, 2])
    m = eng.metrics
    assert m.preemptions >= 1 and m.swap_outs >= 1
    assert m.expired == 1 and m.completed == 1 and m.swap_ins == 0
    assert m.host_evictions >= 1 and eng._host.n_in_use == 0
    sm = simulate([SimRequest("victim", 0, plan, ttl=3.0, prompt_len=4),
                   SimRequest("strong", 2, plan, prompt_len=4, priority=5)],
                  num_slots=2, pass_budget=4, kv="paged", page_size=4, num_pages=6,
                  reservation="lazy", host_pages=8,
                  on_tick=lambda t, p, s, q: p.check()).metrics
    assert m.trace.keys() == sm.trace.keys()
    for name in TIER_COUNTERS + ("expired",):
        assert getattr(m, name) == getattr(sm, name), name


def test_lru_eviction_falls_back_to_recompute(world):
    """A host tier of one checkpoint: the second swap-out evicts the first
    victim's checkpoint, and that victim resumes by recompute; engine ==
    simulator event for event, tokens equal solo runs'."""
    plan = GuidancePlan.suffix(6, 0.5, 4.0)
    long_plan = GuidancePlan.suffix(10, 0.5, 4.0)
    page_bytes = kv_page_bytes(world.cfg, 4, "bf16")
    kw = dict(num_slots=4, pass_budget=4, prompt_len=8, max_new=10, stop_on_eos=False,
              kv="paged", page_size=4, reservation="lazy", prefills_per_tick=4)

    def reqs():
        return [ServeRequest(uid=f"w{i}", prompt=f"weak {i}", plan=plan, priority=i)
                for i in range(3)] + [ServeRequest(uid="strong", prompt="strong",
                                                   plan=long_plan, priority=10)]

    eng = ContinuousEngine(world.model, world.cfg, num_pages=12,
                           host_pool_bytes=4 * page_bytes, **kw)
    out = eng.serve_trace(reqs(), [0, 0, 0, 2])
    m = eng.metrics
    assert m.completed == 4 and m.swap_outs >= 2 and m.host_evictions >= 1
    assert m.swap_ins < m.resumes == m.preemptions
    assert eng._host.n_in_use == 0
    trace = [SimRequest(f"w{i}", 0, plan, prompt_len=8, priority=i) for i in range(3)]
    trace.append(SimRequest("strong", 2, long_plan, prompt_len=8, priority=10))
    sm = simulate(trace, num_slots=4, pass_budget=4, kv="paged", page_size=4, num_pages=12,
                  reservation="lazy", host_pages=4, prefills_per_tick=4,
                  on_tick=lambda t, p, s, q: p.check()).metrics
    assert m.trace.keys() == sm.trace.keys()
    for name in TIER_COUNTERS:
        assert getattr(m, name) == getattr(sm, name), name
    solo = ContinuousEngine(world.model, world.cfg, **kw)
    assert solo.serve_trace(reqs(), [0, 0, 0, 200]) == out


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_tiers_equal_reference_and_sim(world, kv_dtype):
    """``test_tier.py``'s contended popular-prompt trace with both tiers
    on: the port engine's counters and full event stream equal the
    reference engine's and the port simulator's (swap_out, swap_in,
    host_evict, prefix_hit and prefix_miss included, in order)."""
    picks, arrivals = [0, 0, 1, 0, 2, 0], [2 * i for i in range(6)]
    kw = _tier_kw(num_pages=10, host_pages=8, prefix_cache="content", prefills=1,
                  num_slots=6, budget=12, kv_dtype=kv_dtype)

    def make(R):
        plan = (GuidancePlan if R is ServeRequest else JPlan).suffix(6, 0.5, 4.0)
        return [R(uid=f"r{i}", prompt=f"popular {picks[i]}", max_new_tokens=6, plan=plan,
                  priority=i) for i in range(6)]

    jeng, jout, teng, tout = _run(world, kw, make, arrivals)
    _drop_cache(teng)
    _check(world, jeng, jout, teng, tout, make(ServeRequest))
    em = teng.metrics
    assert em.preemptions > 0 and em.swap_outs > 0 and em.prefix_hits > 0
    plan = GuidancePlan.suffix(6, 0.5, 4.0)
    sm = simulate([SimRequest(f"r{i}", arrivals[i], plan, prompt_len=8, priority=i,
                              content=f"p{picks[i]}") for i in range(6)],
                  num_slots=6, pass_budget=12, kv="paged", page_size=4, num_pages=10,
                  reservation="lazy", prefills_per_tick=1, host_pages=8,
                  prefix_cache="content", kv_dtype=kv_dtype,
                  on_tick=lambda t, p, s, q: p.check()).metrics
    for name in TIER_COUNTERS:
        assert getattr(em, name) == getattr(sm, name) == getattr(jeng.metrics, name), name
    assert [ev.key() for ev in em.trace] == [ev.key() for ev in sm.trace]
    teng._host.check()
