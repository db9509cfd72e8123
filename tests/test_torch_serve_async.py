"""The port engine's pipelined tick (``tick_mode="async"``) and
``ServeFleet`` against the port's sync engine, the port's simulator and the
reference engine on the same converted weights, on the CPU at the reduced
llama3.2-1b with pages of 4; the scenarios are ``tests/test_fleet.py``'s.
Events and counters equal exactly; greedy tokens are held to the reference
with ``tests/test_torch_serve.py``'s margin guard, and async to sync
exactly (the same port code decides and computes both)."""

import numpy as np
import pytest
import torch

from repro.core.selective import GuidancePlan as JPlan
from repro.serve import ContinuousEngine as JEngine
from repro_torch.core.selective import GuidancePlan
from repro_torch.serve import (ContinuousEngine, ServeFleet, ServeRequest, SimRequest,
                               simulate, simulate_fleet)
from test_torch_serve import World, _check, _run

PROMPTS = ["the red fox", "a calm sea at dawn", "quantum chalk dust"]
TICK = dict(num_slots=4, pass_budget=8, prompt_len=8, max_new=8, stop_on_eos=False,
            kv="paged", page_size=4, num_pages=32, reservation="lazy",
            prefix_cache="content", prefills_per_tick=2, seed=0)
COUNTERS = ("denoiser_passes", "prefill_passes", "completed", "tokens_emitted", "prefix_hits",
            "prefix_misses", "step_launches", "step_compiles", "pages_grown",
            "shared_page_hits", "cow_copies", "pages_reclaimed", "peak_pages_in_use")


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


@pytest.mark.parametrize("kw, match", [
    (dict(kv="slot", tick_mode="async"), "paged"),
    (dict(kv="paged", page_size=4, step_mode="signature", tick_mode="async",
          stop_on_eos=False), "ragged"),
    (dict(kv="paged", page_size=4, stop_on_eos=True, tick_mode="async"), "stop_on_eos"),
    (dict(kv="paged", page_size=4, stop_on_eos=False, tick_mode="async",
          guidance_policy="divergence", divergence_threshold=1.0), "static"),
    (dict(kv="paged", page_size=4, tick_mode="overlapped"), "tick_mode"),
], ids=["slot", "signature", "stop_on_eos", "dynamic_policy", "unknown_mode"])
def test_async_validation(world, kw, match):
    """The reference's async validation, message for message."""
    for eng, model, cfg in ((ContinuousEngine, world.model, world.cfg),
                            (JEngine, world.params, world.jcfg)):
        with pytest.raises(ValueError, match=match):
            eng(model, cfg, num_slots=2, **kw)


def _tick_reqs(temperature: float, n: int = 6):
    """``test_fleet.py``'s mixed trace: three prompts, two lengths, plans
    of 6 to 8 steps."""
    return [ServeRequest(uid=f"a{i}", prompt=PROMPTS[i % 3], max_new_tokens=6 + (i % 3),
                         guidance_scale=3.0, temperature=temperature,
                         prompt_len=6 + 2 * (i % 2)) for i in range(n)]


class _Overlapped(ContinuousEngine):
    """Counts the requests admitted (decided) inside an overlap window."""

    overlap_admits = 0

    def _admit_collect(self, now):
        stash = super()._admit_collect(now)
        if stash is not None and now > self.tick_count:
            self.overlap_admits += len(stash.batch)
        return stash


def _sync_and_async(world, reqs, arrivals):
    runs = {}
    for mode in ("sync", "async"):
        eng = _Overlapped(world.model, world.cfg, tick_mode=mode, **TICK)
        runs[mode] = (eng, eng.serve_trace(reqs(), arrivals))
    return runs["sync"], runs["async"]


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "sampled"])
def test_async_equals_sync(world, temperature):
    """``test_fleet.py``'s trace: async ticks give sync's tokens and pass
    counts (a request arriving at tick t > 0 is decided in tick t's overlap
    window and admitted at t + 1, the pipeline's one tick, so the events'
    ticks differ from sync's there). With the queue backlogged from tick 0
    the admissions are the same in both modes, decided in the overlap
    window, and the event streams and every counter are equal."""
    (se, so), (ae, ao) = _sync_and_async(world, lambda: _tick_reqs(temperature),
                                         [0, 0, 1, 2, 4, 5])
    assert ao == so and len(so) == 6
    for name in ("denoiser_passes", "prefill_passes", "completed", "tokens_emitted",
                 "prefix_hits", "step_launches"):
        assert getattr(ae.metrics, name) == getattr(se.metrics, name), name
    overlap = sum(t.segment_s().get("overlap", 0.0) for t in ae.metrics.tick_timings)
    assert overlap > 0.0
    assert all("overlap" not in t.segment_s() for t in se.metrics.tick_timings)
    (se, so), (ae, ao) = _sync_and_async(world, lambda: _tick_reqs(temperature, 10), [0] * 10)
    assert ao == so and len(so) == 10
    assert ae.metrics.trace.keys() == se.metrics.trace.keys()
    for name in COUNTERS:
        assert getattr(ae.metrics, name) == getattr(se.metrics, name), name
    assert ae.overlap_admits >= 6 and se.overlap_admits == 0
    ae.pages.check()


def test_async_equals_sim_and_reference(world):
    """``test_fleet.py``'s async engine == async simulator trace, and the
    port's async engine == the reference's async engine event for event,
    tokens margin-guarded."""
    arrivals = [0, 1, 1, 3, 6]
    kw = dict(TICK, tick_mode="async")

    def make(R):
        plan = (GuidancePlan if R is ServeRequest else JPlan).suffix(6, 0.5, 4.0)
        return [R(uid=f"s{i}", prompt=PROMPTS[i % 3], max_new_tokens=6, plan=plan,
                  prompt_len=8) for i in range(5)]

    jeng, jout, teng, tout = _run(world, kw, make, arrivals)
    canon = teng.pages.num_pages - teng.pages.n_free
    assert teng._content.drop_all() == canon       # only cache pages stay at drain
    _check(world, jeng, jout, teng, tout, make(ServeRequest))
    plan = GuidancePlan.suffix(6, 0.5, 4.0)
    sm = simulate([SimRequest(f"s{i}", arrivals[i], plan, prompt_len=8, content=f"p{i % 3}")
                   for i in range(5)],
                  num_slots=4, pass_budget=8, kv="paged", page_size=4, num_pages=32,
                  reservation="lazy", prefix_cache="content", prefills_per_tick=2,
                  async_ticks=True).metrics
    m = teng.metrics
    assert m.trace.keys() == sm.trace.keys() == jeng.metrics.trace.keys()
    assert m.summary()["ttft"] == sm.summary()["ttft"]
    assert m.prefix_hits == sm.prefix_hits > 0


def _zipf_picks(seed, n, n_prompts=3):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_prompts + 1) ** 1.5
    return [int(k) for k in rng.choice(n_prompts, size=n, p=p / p.sum())]


FLEET = dict(num_slots=6, pass_budget=12, prompt_len=8, max_new=8, stop_on_eos=False,
             kv="paged", page_size=4, num_pages=64, reservation="lazy",
             prefix_cache="content", prefills_per_tick=2)


def _fleet_reqs(picks, plan):
    return [ServeRequest(uid=f"f{i:02d}", prompt=PROMPTS[picks[i]], max_new_tokens=8,
                         plan=plan, prompt_len=8) for i in range(len(picks))]


def test_fleet_replicas_equal_simulate_fleet(world):
    """``test_fleet.py``: two replicas on one model object behind the
    affinity router; the placement equals ``simulate_fleet``'s from the
    engine's hashed content keys and the simulator's labels, and each
    replica's events and counters equal its simulated replica's."""
    picks, plan = _zipf_picks(0, 16), GuidancePlan.suffix(8, 0.5, 4.0)
    fleet = ServeFleet([ContinuousEngine(world.model, world.cfg, **FLEET) for _ in range(2)],
                       policy="affinity")
    out = fleet.serve_trace(_fleet_reqs(picks, plan), list(range(16)))
    assert len(out) == 16
    sim = simulate_fleet([SimRequest(f"f{i:02d}", i, plan, prompt_len=8,
                                     content=f"p{picks[i]}") for i in range(16)], 2,
                         policy="affinity", page_size=4,
                         **{k: v for k, v in FLEET.items()
                            if k not in ("prompt_len", "max_new", "stop_on_eos", "page_size")})
    assert sim.assignments == fleet.assignments
    for rid in range(2):
        em, sm = fleet.engines[rid].metrics, sim.replicas[rid].metrics
        assert em.trace.keys() == sm.trace.keys(), rid
        for name in ("completed", "denoiser_passes", "prefill_passes", "prefix_hits",
                     "prefix_misses", "tokens_emitted", "shared_page_hits", "pages_grown",
                     "preemptions"):
            assert getattr(em, name) == getattr(sm, name), (rid, name)
    assert fleet.summary()["prefix_hits"] == sim.summary()["prefix_hits"] > 0


def test_fleet_affinity_beats_random_on_engines(world):
    """Affinity routing gives strictly more prefix hits and strictly fewer
    forward passes than random routing on the Zipf trace, and the same
    tokens for every request."""
    picks, plan = _zipf_picks(0, 16), GuidancePlan.suffix(8, 0.5, 4.0)
    out, hits, totals = {}, {}, {}
    for pol in ("affinity", "random"):
        fleet = ServeFleet([ContinuousEngine(world.model, world.cfg, **FLEET)
                            for _ in range(2)], policy=pol, seed=7)
        out[pol] = fleet.serve_trace(_fleet_reqs(picks, plan), list(range(16)))
        s = fleet.summary()
        hits[pol] = s["prefix_hits"]
        totals[pol] = s["prefill_passes"] + s["denoiser_passes"]
    assert out["affinity"] == out["random"]
    assert hits["affinity"] > hits["random"]
    assert totals["affinity"] < totals["random"]
