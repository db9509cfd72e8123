"""A windowed model in the slot arena: every layer whose sliding window W is
under the row's capacity keeps a ring of W slots a row, with the row's slot
positions, as the reference's per-row decode caches do.

On the CPU at the reduced h2o-danube-3-4b (2 layers, d_model 256, vocab
512), its window cut to 8 under prompts of 12 (W < prompt_len < capacity),
the port's engine is held against the reference's
``ContinuousEngine(kv="slot")`` on the same converted weights with
``tests/test_torch_serve.py``'s harness (event streams and counters equal,
greedy tokens equal up to the first undecided step), its logits within
``RING_LOGIT_TOL`` per unit of 2s - 1: one bf16 step of the largest logit,
since the logits leave the unembedding in bf16. (The harness's 3e-3 is
set for llama3.2-1b at prompts of 8; here the prefill's logits alone,
before any ring is read, differ from the reference's by up to 3.04e-3 per
unit, and the decode steps' by no more than that.) B5's ring-a-row form (one ring and one position a row, a
padding row on the spare) is held against the reference's
``attn_decode_ring`` vmapped over rows, in float32, within 1e-5 of the
largest value. Where the prompt fills no more than the window (S <= W <
capacity) the reference builds no ring (ROADMAP C), so the port's rings are
held against its own windowed linear cache: the same engine whose rows are
linear caches masked by the window."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_serve as TS

from repro.configs import get_smoke_config as jget_smoke
from repro.core import ar_decode as JAR
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import decode_attention as KD
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ContinuousEngine, ServeRequest

W = 8
RING_LOGIT_TOL = 2.0 ** -8
RING = dict(num_slots=4, pass_budget=4, prompt_len=12, max_new=6, selective_fraction=0.5,
            stop_on_eos=False, prefills_per_tick=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: one torch thread (as the serve tests)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class RingWorld(TS.World):
    """``TS.World`` on the reduced h2o-danube-3-4b with its window cut to
    ``window``, on both sides."""

    def __init__(self, window: int):
        arch = "h2o-danube-3-4b"
        self.jcfg = dataclasses.replace(jget_smoke(arch), sliding_window=window)
        self.cfg = dataclasses.replace(get_smoke_config(arch), sliding_window=window)
        self.params = JT.init_model(self.jcfg, JL.ArrayMaker(jax.random.PRNGKey(0)))
        self.model = Transformer.from_state_dict(
            self.cfg, convert.from_jax_model_params(jax.tree.map(np.asarray, self.params)))
        jcfg = self.jcfg
        self.prefill = jax.jit(lambda p, t: JAR.prefill(p, jcfg, t))
        self.step = jax.jit(lambda p, t, c, pos: JAR.decode_step_cond(p, jcfg, t, c, pos))


@pytest.fixture(scope="module")
def world():
    return RingWorld(W)


def _reqs(prefix):
    return lambda R: [R(uid=f"w{i}", prompt=f"{prefix} windowed request number {i}",
                        max_new_tokens=6, guidance_scale=3.0) for i in range(4)]


@pytest.mark.parametrize("combine", [dict(combine="cfg"), dict(combine="apg", apg_eta=0.3)],
                         ids=["cfg", "apg"])
def test_ring_slot_arena_matches_reference(world, combine, monkeypatch):
    """W < prompt_len < capacity, mid-flight joins: every decode step
    wraps each row's ring; events, counters and the HBM accounting equal
    the reference's, tokens up to the first undecided step."""
    monkeypatch.setattr(TS, "LOGIT_TOL", RING_LOGIT_TOL)
    make = _reqs("ring")
    kw = dict(RING, **combine)
    jeng, jout, teng, tout = TS._run(world, kw, make, [0, 0, 1, 3])
    assert all("slot_pos" in layer and layer["k"].shape[1] == W
               for layer in teng._pool_c + teng._pool_u)
    TS._check(world, jeng, jout, teng, tout, make(ServeRequest))
    assert teng.metrics.step_compiles == len([k for k in jeng._jit if k[0] == "step"]) > 1
    assert teng.kv_hbm_bytes() == jeng.kv_hbm_bytes()


def test_ring_defrag_matches_reference(world, monkeypatch):
    """Short requests free low slots while a long one wraps its ring; the
    defrag permutes the rings' values and slot positions in place (the
    requests of ``tests/test_torch_serve_slot.py``'s defrag scenario): the
    long request's tokens also equal a solo run's."""
    monkeypatch.setattr(TS, "LOGIT_TOL", RING_LOGIT_TOL)
    def make(R):
        return [R(uid="s0", prompt="short zero", max_new_tokens=2),
                R(uid="s1", prompt="short one", max_new_tokens=2),
                R(uid="long", prompt="the long request", max_new_tokens=10)]

    kw = dict(num_slots=3, pass_budget=6, prompt_len=12, max_new=10, selective_fraction=0.5,
              stop_on_eos=False, defrag_threshold=0.3, prefills_per_tick=3)
    jeng, jout, teng, tout = TS._run(world, kw, make, [0, 0, 0])
    assert ("defrag",) in teng._shapes and ("defrag",) in jeng._jit
    TS._check(world, jeng, jout, teng, tout, make(ServeRequest))
    solo = ContinuousEngine(world.model, world.cfg, **dict(kw, defrag_threshold=0.5))
    assert solo.serve(make(ServeRequest)[2:])["long"] == tout["long"]


def _ring_rows(rng, N, pos, rows, K, hd):
    """N rings of W slots: row rows[b] holds positions [pos[b] - W,
    pos[b]) at their slots p % W (fewer at the start), random K/V; rows no
    query names stay empty (slot positions -1)."""
    k = rng.standard_normal((N, W, K, hd)).astype(np.float32)
    v = rng.standard_normal((N, W, K, hd)).astype(np.float32)
    sp = np.full((N, W), -1, np.int32)
    for r, p in zip(rows, pos):
        for q in range(max(0, p - W), p):
            sp[r, q % W] = q
    return k, v, sp


def test_b5_ring_a_row_against_the_reference_vmapped(world):
    """The attention layer's ring-a-row step (B5's plain form underneath)
    against ``repro.models.attention.attn_decode_ring`` vmapped over the
    rows, each with its ring and position, on layer 0's weights: rings
    wrapped several times, one just started, a padding row on the empty
    spare. Outputs and the rings after the write agree."""
    jcfg, cfg = world.jcfg, world.cfg
    K, hd, D = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0], jnp.float32),
                      world.params["segments"][0][0]["attn"])
    tp = world.model.layers[0].attn
    N, rows, pos = 5, np.asarray([3, 0, 4, 1], np.int32), np.asarray([29, 9, 0, 3], np.int32)
    k, v, sp = _ring_rows(rng, N, [29, 9, 3], [3, 0, 1], K, hd)
    x = rng.standard_normal((4, 1, D)).astype(np.float32)

    def one(x, k, v, sp, p):
        out, c = JA.attn_decode_ring(jp, jcfg, x[None], {"k": k[None], "v": v[None],
                                                         "slot_pos": sp}, p, window=W)
        return out[0], c["k"][0], c["v"][0], c["slot_pos"]

    want = jax.vmap(one)(jnp.asarray(x), jnp.asarray(k[rows]), jnp.asarray(v[rows]),
                         jnp.asarray(sp[rows]), jnp.asarray(pos))
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
             "slot_pos": torch.from_numpy(sp.copy())}
    tpos, trows = torch.from_numpy(pos), torch.from_numpy(rows)
    rope = TL.rope_tables(tpos.view(-1, 1), hd, cfg.rope_theta)
    out, cache = TA.attn_decode_ring(tp, cfg, torch.from_numpy(x), cache,
                                     TA.decode_pos(tpos, "cpu", trows), rope, window=W)
    assert KD.LAUNCHES["decode_attention"] == 0
    ref = np.asarray(want[0])
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    for i, name in enumerate(("k", "v", "slot_pos"), start=1):
        got = cache[name][torch.from_numpy(rows).long()].numpy()
        np.testing.assert_allclose(got, np.asarray(want[i]), rtol=0, atol=1e-5)
    untouched = [2]
    assert np.array_equal(cache["slot_pos"][untouched].numpy(), sp[untouched])


@pytest.mark.parametrize("window", [None, 5])
def test_b5_ring_a_row_equals_each_ring_alone(window):
    """B5's ring-a-row form at per-row positions equals its one-ring form
    on each row alone; its shapes are checked."""
    rng = np.random.default_rng(1)
    N, K, hd, H = 6, 2, 16, 4
    rows, pos = np.asarray([5, 2, 0, 5], np.int32), np.asarray([40, 17, 8, 40], np.int32)
    k, v, sp = _ring_rows(rng, N, [41, 18, 9], [5, 2, 0], K, hd)
    q = torch.from_numpy(rng.standard_normal((4, H, hd)).astype(np.float32))
    k, v, sp = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(sp)
    out = KD.decode_attention(q, k, v, torch.from_numpy(pos), window=window, slot_pos=sp,
                              rows=torch.from_numpy(rows))
    for b, (r, p) in enumerate(zip(rows, pos)):
        one = KD.decode_attention(q[b:b + 1], k[r:r + 1], v[r:r + 1], int(p), window=window,
                                  slot_pos=sp[r])
        torch.testing.assert_close(out[b:b + 1], one, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):      # rings a row need (N, W) slot positions
        KD.decode_attention(q, k, v, torch.from_numpy(pos), slot_pos=sp[0],
                            rows=torch.from_numpy(rows))
    with pytest.raises(ValueError):      # positions a row without rows
        KD.decode_attention(q, k[:4], v[:4], torch.from_numpy(pos), slot_pos=sp[0])


class _LinearRows(TS._Recording):
    """The slot arena with every row a linear cache, the window applied as
    a mask: the port's windowed linear cache."""

    def _rings(self):
        return [None] * self.cfg.num_layers


@pytest.mark.parametrize("prompt_len,window", [(8, 10), (10, 10), (12, 8)])
def test_rings_equal_the_windowed_linear_cache(world, prompt_len, window):
    """S < W < capacity, S == W < capacity (where the reference keeps no
    ring: fault C) and W < S: the ring rows serve the trace as linear rows
    under the window's mask do: tokens and events equal, logits within
    one bf16 step of the largest."""
    cfg = dataclasses.replace(world.cfg, sliding_window=window)
    kw = dict(RING, prompt_len=prompt_len)
    make = _reqs("linear")
    runs = []
    for cls in (TS._Recording, _LinearRows):
        eng = cls(world.model, cfg, **kw)
        runs.append((eng, eng.serve_trace(make(ServeRequest), [0, 0, 1, 3])))
    (re, ro), (le, lo) = runs
    assert all("slot_pos" in layer for layer in re._pool_c)
    assert not any("slot_pos" in layer for layer in le._pool_c)
    assert ro == lo and re.metrics.trace.keys() == le.metrics.trace.keys()
    for uid in ro:
        a, b = np.stack(re.logits[uid]), np.stack(le.logits[uid])
        np.testing.assert_allclose(a, b, rtol=0, atol=2.0 ** -8 * np.abs(b).max())


def test_windowed_slot_arena_no_longer_raises(world):
    """The slot arena takes a window under the row's capacity in every
    step form it has: greedy and hot rows, per-row positions, the default
    engine; the rings' slot positions name the last W positions."""
    cfg = world.cfg
    eng = ContinuousEngine(world.model, cfg, **RING)
    out = eng.serve([ServeRequest(uid="a", prompt="a windowed request", max_new_tokens=6),
                     ServeRequest(uid="b", prompt="a hot one", max_new_tokens=6,
                                  temperature=0.7)])
    assert len(out["a"]) == len(out["b"]) == 6
    eng = ContinuousEngine(world.model, cfg, prompt_len=12, max_new=4, num_slots=2)
    eng.submit(ServeRequest(uid="c", prompt="one more", max_new_tokens=4))
    eng.tick()
    slot = eng._states["c"].slot
    sp = eng._pool_c[0]["slot_pos"][slot]     # the prefill's 0-11, the tick's step 12
    assert sorted(sp.tolist()) == list(range(13 - W, 13))
    assert (eng._pool_c[0]["slot_pos"][eng.num_slots] == -1).all()
