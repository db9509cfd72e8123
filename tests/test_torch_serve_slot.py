"""The port's slot arena (``kv="slot"``, the engine's default) against the
reference's ``ContinuousEngine(kv="slot")`` on the same converted weights,
on the CPU at the reduced llama3.2-1b, with ``tests/test_torch_serve.py``'s
harness: event streams, ``step_compiles`` and the other counters equal
exactly, greedy tokens equal up to the first step the logits do not decide,
logits within its ``LOGIT_TOL``. Also B5's per-row form (one position and
one cache row a query row) against ``repro/kernels/ref.py``'s oracle, a row
at a time."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.serve import ContinuousEngine as JEngine
from repro.serve import ServeRequest as JRequest
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import decode_attention as KD
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ContinuousEngine, ServeRequest
from test_torch_serve import World, _check, _run, _trace_reqs

SLOT = dict(num_slots=4, pass_budget=4, prompt_len=8, max_new=6, selective_fraction=0.5,
            stop_on_eos=False, prefills_per_tick=2)


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


def _steps(eng):
    return sorted(k for k in eng._shapes if k[0] == "step")


@pytest.mark.parametrize("combine", [dict(combine="cfg"), dict(combine="apg", apg_eta=0.3),
                                     dict(combine="interval", interval=(0.25, 0.75))],
                         ids=["cfg", "apg", "interval"])
def test_slot_trace_each_combine(world, combine):
    """Mid-flight joins (arrivals 0, 0, 1, 3): each row steps at its own
    position, and the signature keys are the reference's."""
    make = _trace_reqs("trace request")
    jeng, jout, teng, tout = _run(world, dict(SLOT, **combine), make, [0, 0, 1, 3])
    _check(world, jeng, jout, teng, tout, make(ServeRequest))
    assert _steps(teng) == sorted(k for k in jeng._jit if k[0] == "step")
    assert teng.metrics.step_compiles == len(_steps(teng)) > 1
    assert teng.kv_hbm_bytes() == jeng.kv_hbm_bytes()


def test_mixed_phases_and_static_policy(world):
    """``test_serve.py``'s half all-FULL, half all-COND workload under both
    packing policies: passes exact, phase packing beats static."""
    def make(R):
        reqs = []
        for i in range(2):
            reqs.append(R(uid=f"f{i}", prompt=f"full phase req {i}", max_new_tokens=6,
                          selective_fraction=0.0))
            reqs.append(R(uid=f"c{i}", prompt=f"cond phase req {i}", max_new_tokens=6,
                          selective_fraction=1.0))
        return reqs

    metrics = {}
    for policy in ("phase", "static"):
        kw = dict(SLOT, policy=policy)
        jeng, jout, teng, tout = _run(world, kw, make, [0] * 4)
        _check(world, jeng, jout, teng, tout, make(ServeRequest))
        for r in teng.metrics.records:
            assert r.passes == 2 * r.n_full + r.n_cond <= 4
        metrics[policy] = teng.metrics
    assert metrics["phase"].mean_in_flight() > metrics["static"].mean_in_flight()


def test_defrag_keeps_live_rows(world):
    """Short requests free low slots while a long one decodes; the pools are
    permuted in place (events equal the reference's, which permutes too) and
    the long request's tokens equal a solo run's."""
    def make(R):
        return [R(uid="s0", prompt="short zero", max_new_tokens=2),
                R(uid="s1", prompt="short one", max_new_tokens=2),
                R(uid="long", prompt="the long request", max_new_tokens=10)]

    kw = dict(num_slots=3, pass_budget=6, prompt_len=8, max_new=10, selective_fraction=0.5,
              stop_on_eos=False, defrag_threshold=0.3, prefills_per_tick=3)
    jeng, jout, teng, tout = _run(world, kw, make, [0, 0, 0])
    _check(world, jeng, jout, teng, tout, make(ServeRequest))
    assert ("defrag",) in teng._shapes and ("defrag",) in jeng._jit
    assert teng.pool.fragmentation() == 0.0
    solo = ContinuousEngine(world.model, world.cfg, **dict(kw, defrag_threshold=0.5))
    assert solo.serve(make(ServeRequest)[2:])["long"] == tout["long"]


def test_default_arguments_serve_a_trace(world):
    """``ContinuousEngine(model, cfg)`` with every default (the slot arena,
    8 slots, prompts of 32, 32 new tokens, EOS stopping), per-request
    guidance scales, against the reference's defaults: events and counters
    equal, and every token equal. (``LOGIT_TOL`` is set for prompts of 8;
    at 32 the bf16 prefill logits already differ by one bf16 step of the
    largest logit, 0.4% of it, so this scenario holds the tokens, all of
    them, instead of the logits.)"""
    def make(R):
        return [R(uid=f"d{i}", prompt=f"default engine request {i}", max_new_tokens=12,
                  guidance_scale=[1.0, 3.0, 6.0][i % 3]) for i in range(5)]

    jeng = JEngine(world.params, world.jcfg)
    jout = jeng.serve_trace(make(JRequest), [0, 0, 1, 2, 2])
    teng = ContinuousEngine(world.model, world.cfg)
    assert teng.kv == "slot" and teng.step_mode == "signature" and not teng.graphs
    tout = teng.serve_trace(make(ServeRequest), [0, 0, 1, 2, 2])
    assert teng.metrics.trace.keys() == jeng.metrics.trace.keys()
    for name in ("step_compiles", "step_launches", "denoiser_passes", "tokens_emitted",
                 "completed"):
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name), name
    assert tout == jout and len(tout) == 5
    assert teng.kv_hbm_bytes() == jeng.kv_hbm_bytes()


def test_slot_validation(world):
    with pytest.raises(ValueError):
        ContinuousEngine(world.model, world.cfg, kv="slot", reservation="lazy")
    with pytest.raises(ValueError):
        ContinuousEngine(world.model, world.cfg, kv="slot", kv_dtype="int8")
    eng = ContinuousEngine(world.model, world.cfg, **SLOT)
    assert not eng.submit(ServeRequest(uid="short", prompt="x", max_new_tokens=4,
                                       prompt_len=5))
    assert eng.metrics.rejected == 1


def test_windowed_model_in_slot_arena_raises():
    """A window under the row's capacity once raised (ROADMAP A4.1); it is
    now served on a ring a row (``tests/test_torch_serve_ring.py`` holds
    its tokens), and no option of the slot arena raises for it."""
    cfg = get_smoke_config("h2o-danube-3-4b")
    model = Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ContinuousEngine(model, cfg, prompt_len=cfg.sliding_window, max_new=4, num_slots=2)
    out = eng.serve([ServeRequest(uid="a", prompt="windowed", max_new_tokens=4)])
    assert len(out["a"]) >= 1
    assert all("slot_pos" in layer for layer in eng._pool_c + eng._pool_u)
    # a window no shorter than the row is a linear cache: served
    eng = ContinuousEngine(model, cfg, prompt_len=8, max_new=4, num_slots=2)
    out = eng.serve([ServeRequest(uid="a", prompt="short", max_new_tokens=4)])
    assert len(out["a"]) >= 1
    assert not any("slot_pos" in layer for layer in eng._pool_c)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [None, 48])
def test_decode_attention_per_row_against_oracle(dtype, tol, window):
    """B5's per-row form (the slot step's: a position and a cache row a
    query row, padding rows on a spare row) equals ``ref_decode_attention``
    run on each row alone at its own position."""
    rng = np.random.default_rng(0)
    N, S, H, K, hd, B = 6, 80, 8, 2, 32, 4
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((N, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((N, S, K, hd)).astype(np.float32)
    rows = np.asarray([3, 0, 5, 5], np.int32)
    pos = np.asarray([79, 0, 40, 3], np.int32)
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    out = KD.decode_attention(t(q), t(k), t(v), torch.from_numpy(pos), window=window,
                              rows=torch.from_numpy(rows))
    assert KD.LAUNCHES["decode_attention"] == 0
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for b in range(B):
        want = ref.ref_decode_attention(jnp.asarray(q[b:b + 1], jdt),
                                        jnp.asarray(k[rows[b]][None], jdt),
                                        jnp.asarray(v[rows[b]][None], jdt), int(pos[b]),
                                        window=window)
        got = out[b:b + 1].float().numpy()
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)
    # one position for the batch is the same as that position on every row
    same = KD.decode_attention(t(q), t(k[:B]), t(v[:B]), torch.full((B,), 40, dtype=torch.int32))
    one = KD.decode_attention(t(q), t(k[:B]), t(v[:B]), torch.full((1,), 40, dtype=torch.int32))
    assert torch.equal(same, one)
    with pytest.raises(ValueError):
        KD.decode_attention(t(q), t(k), t(v), torch.from_numpy(pos))         # N != B, no rows
    with pytest.raises(ValueError):
        KD.decode_attention(t(q), t(k[:B]), t(v[:B]), torch.from_numpy(pos),
                            slot_pos=torch.arange(S, dtype=torch.int32))


def test_per_row_decode_step_equals_rows_alone(world):
    """``Transformer.decode_step`` with a position and a cache row a batch
    row writes and reads each row in place as a batch of one would."""
    cfg, model = world.cfg, world.model
    g = torch.Generator().manual_seed(0)
    N, cap = 5, 16
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    caches = [{"k": torch.randn(N, cap, K, hd, generator=g).to(torch.bfloat16),
               "v": torch.randn(N, cap, K, hd, generator=g).to(torch.bfloat16)}
              for _ in range(cfg.num_layers)]
    solo = [{n: c[n].clone() for n in c} for c in caches]
    rows = torch.tensor([4, 1, 2], dtype=torch.int32)
    pos = torch.tensor([9, 3, 15], dtype=torch.int32)
    emb = model.embed_tokens(torch.tensor([[7], [11], [5]]))
    h, _ = model.decode_step(emb, caches, pos, rows=rows)
    for b in range(3):
        r = int(rows[b])
        one = [{n: c[n][r:r + 1].clone() for n in c} for c in solo]
        hb, one = model.decode_step(emb[b:b + 1], one, int(pos[b]))
        torch.testing.assert_close(h[b:b + 1], hb, atol=2e-2, rtol=2e-2)
        for c, o in zip(caches, one):
            for n in ("k", "v"):
                torch.testing.assert_close(c[n][r], o[n][0], atol=2e-2, rtol=2e-2)
    untouched = [0, 3]
    for c, s in zip(caches, solo):
        assert torch.equal(c["k"][untouched], s["k"][untouched])
