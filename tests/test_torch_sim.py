"""The port's offline simulator, fleet router and Chrome-trace export
against the reference's and against ``results/golden_serve_trace.json``.

Exact, no tolerance: the copies run the same Python and numpy code on the
same inputs, so every per-tick record, counter, event and exported span
must be equal. The golden file is read, never regenerated: the port builds
the trace of ``tests/golden_serve.py``'s ``SPEC`` from its own types and
replays the five ``CONFIGS`` with ``PARAMS``."""

import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import golden_serve
from repro.core.selective import GuidancePlan as JPlan
from repro.serve import fleet as jfleet
from repro.serve import sim as jsim
from repro.serve.metrics import ServeMetrics as JMetrics
from repro.serve.obs import chrome as jchrome
from repro_torch.core.selective import GuidancePlan as TPlan
from repro_torch.serve import fleet as tfleet
from repro_torch.serve import sim as tsim
from repro_torch.serve.metrics import ServeMetrics as TMetrics
from repro_torch.serve.obs import chrome as tchrome
from repro_torch.serve.state import page_nbytes

SIDES = {"ref": (JPlan, jsim, jfleet), "port": (TPlan, tsim, tfleet)}


@pytest.fixture(scope="module")
def golden():
    with open(golden_serve.GOLDEN_PATH) as f:
        return json.load(f)


def _golden_trace(spec):
    """``golden_serve.build_trace`` on the port's types."""
    arrivals = tsim.poisson_arrivals(spec["seed"], n=spec["n"], rate=spec["rate"])
    plan = TPlan.suffix(spec["total_steps"], spec["fraction"], spec["guidance_scale"])
    lens, prios = spec["prompt_lens"], spec["priorities"]
    return [tsim.SimRequest(f"g{i:02d}", int(t), plan, prompt_len=lens[i % len(lens)],
                            priority=prios[i % len(prios)], content=f"c{i % len(lens)}")
            for i, t in enumerate(arrivals)]


def _golden_run(trace, name, params, spec):
    """``golden_serve.run_config`` through the port's simulator."""
    cfg = golden_serve.CONFIGS[name]
    p = dict(params)
    page_size = p.pop("page_size")
    kw = dict(p, kv=cfg["kv"], reservation=cfg["reservation"])
    if cfg["kv"] == "paged":
        kv_dtype = cfg.get("kv_dtype", "bf16")
        kw.update(page_size=page_size, num_pages=cfg["num_pages"], kv_dtype=kv_dtype,
                  page_bytes=page_nbytes(page_size, spec["kv_heads"], spec["head_dim"],
                                         spec["n_layers"], kv_dtype),
                  host_pages=cfg.get("host_pages", 0),
                  prefix_cache=cfg.get("prefix_cache", "length"))
    rep = tsim.simulate(trace, **kw)
    records = [[r.tick, r.n_full, r.n_cond, r.active, r.queue_depth, r.pages_in_use,
                r.bytes_in_use] for r in rep.metrics.records]
    return {"records": records,
            "summary": {k: rep.metrics.summary()[k] for k in golden_serve.SUMMARY_KEYS}}


@pytest.mark.parametrize("config", list(golden_serve.CONFIGS))
def test_port_sim_replays_golden_trace(golden, config):
    assert set(golden["expected"]) == set(golden_serve.CONFIGS)
    trace = _golden_trace(golden["spec"])
    got = _golden_run(trace, config, golden["params"], golden["spec"])
    exp = golden["expected"][config]
    assert got["summary"] == exp["summary"]
    assert got["records"] == exp["records"]


def _trace(side, items):
    Plan, sim, _ = SIDES[side]
    return [sim.SimRequest(f"r{i:03d}", arrival, Plan.suffix(total, frac, 4.0), ttl=ttl,
                           prompt_len=plen, priority=prio,
                           content=None if label is None else f"c{label}")
            for i, (arrival, total, frac, plen, prio, ttl, label) in enumerate(items)]


def _observe(rep):
    m = rep.metrics
    return (m.trace.keys(), m.summary(), [tuple(vars(r).values()) for r in m.records],
            rep.completions, rep.max_wait)


ITEMS = st.lists(st.tuples(st.integers(0, 10), st.integers(1, 8),
                           st.sampled_from([0.0, 0.25, 0.5, 1.0]), st.integers(1, 8),
                           st.integers(0, 2), st.one_of(st.none(), st.integers(2, 8)),
                           st.one_of(st.none(), st.integers(0, 2))),
                 min_size=1, max_size=10)

MODES = [dict(kv="slot"),
         dict(kv="paged", num_pages=24),
         dict(kv="paged", num_pages=12, reservation="lazy"),
         dict(kv="paged", num_pages=20, reservation="lazy", kv_dtype="int8", page_bytes=640),
         dict(kv="paged", num_pages=12, reservation="lazy", host_pages=3,
              prefix_cache="content"),
         dict(kv="paged", num_pages=24, async_ticks=True, step_mode="ragged"),
         dict(kv="paged", num_pages=24, step_mode="signature", bucket=False)]


@settings(max_examples=25, deadline=None)
@given(ITEMS, st.sampled_from(range(len(MODES))), st.sampled_from(["phase", "static"]))
def test_port_sim_equals_reference_on_random_traces(items, mode, policy):
    """Event keys, counters, per-tick records and completions equal the
    reference simulator's in every mode."""
    kw = dict(num_slots=4, pass_budget=6, page_size=4, prefills_per_tick=2,
              policy=policy, **MODES[mode])
    ref = jsim.simulate(_trace("ref", items), **kw)
    port = tsim.simulate(_trace("port", items), **kw)
    assert _observe(port) == _observe(ref)


def test_poisson_helpers_and_compare_policies():
    for seed in (0, 7, 23):
        assert list(tsim.poisson_arrivals(seed, n=16, rate=1.0)) == \
            list(jsim.poisson_arrivals(seed, n=16, rate=1.0))
    kw = dict(n=24, rate=1.5, total_steps=8, fraction=0.5, ttl=12)
    tt, jt = tsim.poisson_trace(3, **kw), jsim.poisson_trace(3, **kw)
    assert [(r.uid, r.arrival, r.ttl) for r in tt] == [(r.uid, r.arrival, r.ttl) for r in jt]
    ref = jsim.compare_policies(jt, num_slots=4, pass_budget=4)
    port = tsim.compare_policies(tt, num_slots=4, pass_budget=4)
    assert sorted(port) == sorted(ref) == ["phase", "static"]
    for p in ref:
        assert _observe(port[p]) == _observe(ref[p])


def _popular(side, n=16, seed=0):
    import numpy as np
    Plan, sim, _ = SIDES[side]
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, 4) ** 1.5
    picks = rng.choice(3, size=n, p=w / w.sum())
    plan = Plan.suffix(8, 0.5, 4.0)
    return [sim.SimRequest(f"f{i:02d}", i, plan, prompt_len=8, content=f"p{int(k)}")
            for i, k in enumerate(picks)]


@pytest.mark.parametrize("policy", ["affinity", "random"])
def test_fleet_sim_and_summary_equal_reference(policy):
    kw = dict(num_slots=6, pass_budget=12, kv="paged", num_pages=64, reservation="lazy",
              prefix_cache="content", prefills_per_tick=2, page_size=4, page_bytes=512)
    ref = jfleet.simulate_fleet(_popular("ref"), 3, policy=policy, seed=7, **kw)
    port = tfleet.simulate_fleet(_popular("port"), 3, policy=policy, seed=7, **kw)
    assert port.assignments == ref.assignments
    assert [_observe(r) for r in port.replicas] == [_observe(r) for r in ref.replicas]
    slo = {"ttft": 4.0, "tpot": 1.0}
    assert port.summary() == ref.summary()
    assert tfleet.fleet_summary(port.metrics, slo) == jfleet.fleet_summary(ref.metrics, slo)
    assert tfleet.FLEET_COUNTERS == jfleet.FLEET_COUNTERS
    assert tfleet.ROUTE_POLICIES == jfleet.ROUTE_POLICIES


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.one_of(st.none(), st.sampled_from("abcd")),
                          st.integers(0, 4096)), max_size=30),
       st.integers(1, 4), st.sampled_from(["affinity", "random"]), st.integers(0, 9))
def test_fleet_router_equals_reference(calls, n, policy, seed):
    ref = jfleet.FleetRouter(n, policy=policy, seed=seed)
    port = tfleet.FleetRouter(n, policy=policy, seed=seed)
    assert [port.route(k, b) for k, b in calls] == [ref.route(k, b) for k, b in calls]
    assert port.assigned_bytes == ref.assigned_bytes
    assert port.assigned_count == ref.assigned_count


def test_router_validation_kept():
    for side in (jfleet, tfleet):
        for bad in (dict(n_replicas=0), dict(n_replicas=2, policy="nope")):
            with pytest.raises(ValueError):
                side.FleetRouter(**bad)


@pytest.mark.parametrize("mode", [0, 2, 4])
def test_chrome_export_equals_reference(mode, tmp_path):
    """The same simulated run exported by both: equal JSON documents (one
    replica with and without a synthetic tick time; a two-replica fleet)."""
    items = [(0, 6, 0.5, 5, 0, None, 0), (0, 8, 0.25, 8, 1, None, 1),
             (1, 4, 1.0, 3, 2, 6, 0), (2, 8, 0.5, 6, 0, None, 2), (3, 5, 0.0, 8, 1, None, None)]
    kw = dict(num_slots=3, pass_budget=4, page_size=4, prefills_per_tick=2, **MODES[mode])
    ref = jsim.simulate(_trace("ref", items), **kw).metrics
    port = tsim.simulate(_trace("port", items), **kw).metrics
    assert isinstance(ref, JMetrics) and isinstance(port, TMetrics)
    for extra in ({}, {"synthetic_tick_s": 1e-3}):
        assert tchrome.to_chrome_trace(port, **extra) == jchrome.to_chrome_trace(ref, **extra)
    assert tchrome.fleet_chrome_trace([port, port]) == jchrome.fleet_chrome_trace([ref, ref])
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    tchrome.write_chrome_trace(port, str(a))
    jchrome.write_chrome_trace(ref, str(b))
    assert json.loads(a.read_text()) == json.loads(b.read_text())
