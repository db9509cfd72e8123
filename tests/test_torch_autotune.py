"""The port's pass-budget autotuner and its roofline.

``BudgetAutotuner`` is a copy of the reference's that takes roofline
seconds where the reference takes a compiled executable; on injected
per-pass seconds its decisions equal the reference's, except at the edge
the port fixes (ROADMAP C): where ``int(target_tick_s / per_pass)`` rounds
up to a count whose tick exceeds the target, the port steps it down once.
The roofline (``repro_torch.roofline``) counts the engine's decode step
from its geometry; ``pass_budget="auto"`` installs an integer budget from
it (at most R in ragged mode), on the CPU at the reduced llama3.2-1b."""

import math

import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.serve.autotune import BudgetAutotuner as JTuner
from repro_torch import roofline
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.transformer import Transformer
from repro_torch.serve import BudgetAutotuner, ContinuousEngine, ServeRequest, simulate
from repro_torch.serve.state import kv_page_bytes

KEYS = [(1, 0, "bf16"), (0, 1, "bf16"), (1, 0, "int8"), (0, 1, "int8"),
        ("ragged", 8, "bf16"), ("ragged", 8, "int8"), (1, 0)]


def _pair(target, entries, min_budget, max_budget):
    port = BudgetAutotuner(target, min_budget=min_budget, max_budget=max_budget)
    ref = JTuner(target, min_budget=min_budget, max_budget=max_budget)
    for k, v in entries:
        port.per_pass_s[KEYS[k]] = ref.per_pass_s[KEYS[k]] = v
    return port, ref


def _rounds_past_target(target, per_pass) -> bool:
    """The edge the port fixes: the reference's raw count overshoots."""
    return per_pass > 0 and int(target / per_pass) * per_pass > target


@settings(max_examples=300, deadline=None)
@given(st.floats(1e-6, 10.0), st.lists(st.tuples(st.integers(0, len(KEYS) - 1),
                                                st.floats(1e-9, 1.0)), max_size=6),
       st.integers(1, 4), st.one_of(st.none(), st.integers(2, 1 << 24)),
       st.sampled_from([None, "bf16", "int8"]))
@example(0.9999999999999999, [(0, 1e-7)], 2, None, "bf16")
def test_decisions_equal_the_reference_but_at_the_rounding_edge(target, entries, lo, hi,
                                                                dtype):
    port, ref = _pair(target, entries, lo, hi)
    worst = ref.worst_for(dtype)
    assert port.worst_for(dtype) == worst
    assert port.report(dtype)["per_pass_s"] == ref.report(dtype)["per_pass_s"]
    for gbps in (8.0, 64.0):
        for page in (1 << 14, 1 << 20):
            assert port.swap_break_even_pages(page, host_gbps=gbps, kv_dtype=dtype) == \
                ref.swap_break_even_pages(page, host_gbps=gbps, kv_dtype=dtype)
    if worst is None:
        assert port.budget(dtype) is ref.budget(dtype) is None
        return
    if not _rounds_past_target(target, worst):
        for name in ("budget", "predicted_tick_s", "headroom_s", "envelope_violated"):
            assert getattr(port, name)(dtype) == getattr(ref, name)(dtype), name
        return
    # the edge: one pass fewer before the clamps, and the envelope holds
    # unless min_budget binds
    raw = int(target / worst) - 1
    want = max(lo, min(raw, hi) if hi is not None else raw)
    assert port.budget(dtype) == want
    assert port.envelope_violated(dtype) == (want * worst > target)
    assert port.envelope_violated(dtype) <= (lo * worst > target)


def test_rounding_fault_draw_from_the_roadmap():
    """ROADMAP C's draw: the reference installs 10,000,000 passes and
    violates its envelope; the port installs 9,999,999 and does not."""
    port, ref = _pair(0.9999999999999999, [(0, 1e-7)], 2, None)
    assert ref.budget("bf16") == 10_000_000 and ref.envelope_violated("bf16")
    assert port.budget("bf16") == 9_999_999
    assert not port.envelope_violated("bf16")
    assert port.predicted_tick_s("bf16") <= port.target_tick_s


def test_host_link_default_is_the_h100_pcie_constant():
    t = BudgetAutotuner(target_tick_s=1.0)
    t.per_pass_s[(1, 0, "bf16")] = 1e-4
    assert t.swap_break_even_pages(1 << 20) == \
        t.swap_break_even_pages(1 << 20, host_gbps=roofline.H100_HOST_LINK_BYTES_S / 1e9)
    assert roofline.H100_HOST_LINK_BYTES_S == 64e9


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return Transformer.init(get_smoke_config("llama3.2-1b"),
                            torch.Generator().manual_seed(0), device="cpu")


def test_roofline_counts_the_model(model):
    """The matmul weights the roofline counts are the model's parameters but
    its norms (the table tied: counted once, by the unembedding)."""
    cfg = model.cfg
    assert cfg.tie_embeddings
    n = sum(p.numel() for p in model.parameters())
    assert roofline.matmul_params(cfg) == n - (2 * cfg.num_layers + 1) * cfg.d_model
    cost = roofline.decode_step(cfg, forwards=(16,), kv_tokens=640, weight_bytes=2 * n,
                                out_rows=16)
    assert cost.seconds == max(cost.compute_s, cost.memory_s) > 0
    assert cost.memory_s == cost.bytes / roofline.H100_HBM_BYTES_S
    assert cost.compute_s == cost.flops / roofline.H100_BF16_FLOPS


@pytest.mark.parametrize("cfg_name", ["llama3.2-1b", "qwen3-14b", "h2o-danube-3-4b"])
def test_int8_prices_no_higher_than_bf16(cfg_name):
    """An int8 pool's step moves fewer KV bytes (a byte a value, plus a
    float32 scale per position and kv head against two bytes a value), at
    every row count and capacity; the FLOPs are the same."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(cfg_name)
    for rows in (1, 8, 16, 64):
        for tokens in (16, 640, 4096):
            kw = dict(forwards=(rows,), kv_tokens=tokens, weight_bytes=2 * 10 ** 9,
                      out_rows=rows)
            b = roofline.decode_step(cfg, kv_dtype="bf16", **kw)
            i = roofline.decode_step(cfg, kv_dtype="int8", **kw)
            assert i.bytes < b.bytes and i.flops == b.flops
            assert i.seconds <= b.seconds


AUTO = dict(num_slots=4, prompt_len=8, max_new=6, kv="paged", page_size=4,
            pass_budget="auto", stop_on_eos=False)


@pytest.mark.parametrize("step_mode", ["ragged", "signature"])
def test_auto_budget_installs_an_integer_budget(model, step_mode):
    """The first tick prices the step the engine runs (its compile counted,
    as the reference's autotune counts it), installs an integer budget (in
    ragged mode at most R) in the engine and its scheduler, and int8 prices
    a pass no higher than bf16."""
    reports = {}
    for kv_dtype in ("bf16", "int8"):
        eng = ContinuousEngine(model, model.cfg, step_mode=step_mode, kv_dtype=kv_dtype,
                               target_tick_s=50e-3, **AUTO)
        assert eng.ragged_rows == 8 and eng.pass_budget == 4          # provisional
        eng.tick()
        rep = reports[kv_dtype] = eng.autotune_budget()
        b = eng.pass_budget
        assert isinstance(b, int) and b == eng.scheduler.pass_budget == rep["budget"]
        if step_mode == "ragged":
            assert list(rep["per_pass_s"]) == [f"ragged,8,{kv_dtype}"]
            assert b == min(eng._autotuner.budget(kv_dtype), eng.ragged_rows)
            assert eng.metrics.step_compiles == 1
        else:
            assert sorted(rep["per_pass_s"]) == [f"0,1,{kv_dtype}", f"1,0,{kv_dtype}"]
            assert b == eng._autotuner.budget(kv_dtype) >= 2
            assert eng.metrics.step_compiles == 2
        assert [e.kind for e in eng.metrics.trace].count("autotune") == 2
    assert reports["int8"]["worst_per_pass_s"] <= reports["bf16"]["worst_per_pass_s"]


def test_auto_budget_serves_like_the_simulator(model):
    """A trace under ``pass_budget="auto"`` at a tight target (budget 3 of
    R = 8): engine == simulator at that budget, event for event but the
    autotune and the step's compile, which the autotune moves to the first
    tick's admit phase."""
    probe = ContinuousEngine(model, model.cfg, **AUTO)
    per_pass = probe.step_roofline((8,), 8).seconds / 8
    target = 3.5 * per_pass
    eng = ContinuousEngine(model, model.cfg, target_tick_s=target, **AUTO)
    reqs = [ServeRequest(uid=f"r{i}", prompt=f"auto {i}", max_new_tokens=6) for i in range(4)]
    eng.serve_trace(reqs, [0, 0, 1, 2])
    assert eng.pass_budget == 3
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.serve import SimRequest
    sm = simulate([SimRequest(f"r{i}", a, GuidancePlan.suffix(6, 0.2, 4.0), prompt_len=8)
                   for i, a in enumerate([0, 0, 1, 2])], num_slots=4, pass_budget=3,
                  kv="paged", page_size=4, prefills_per_tick=2).metrics
    def keys(m):
        return [k for k in m.trace.keys() if k[0] not in ("autotune", "step_compile")]

    assert keys(eng.metrics) == keys(sm) and eng.metrics.step_compiles == sm.step_compiles
    assert math.isclose(eng._autotuner.worst_for("bf16"), per_pass)


def test_swap_min_pages_auto_installs_the_break_even(model):
    page_bytes = kv_page_bytes(model.cfg, 4, "bf16")
    eng = ContinuousEngine(model, model.cfg, reservation="lazy", swap_min_pages="auto",
                           host_pool_bytes=16 * page_bytes, **AUTO)
    assert eng._swap_min == 0
    eng.autotune_budget()
    assert eng._swap_min == eng._autotuner.swap_break_even_pages(
        page_bytes, host_gbps=roofline.H100_HOST_LINK_BYTES_S / 1e9, kv_dtype="bf16") >= 1
