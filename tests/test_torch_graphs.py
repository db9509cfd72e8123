"""The pieces of the port's CUDA-graph steps that the CPU can check: B5 with
its position as a tensor (the form the kernel reads on the device), its
launch plan from shapes alone, ``Transformer.decode_step`` at a tensor
position, the decode loop and the serve engine's ragged step driven
through their graphed control flow, and the launch bookkeeping of
``core/graphs.py``.

No CUDA here, so a capture is stood in for by ``_EagerCapture``: the
"capture" runs the step once (as the real capture's warm-up does, and
which is the caller's first step), and each "replay" runs it again and
copies its outputs into the first run's tensors, as a replay rewrites a
graph's static outputs. What that checks is the graphed loops' state: the
static caches, the device position counter and interval scale, the fixed
row buffers, and that no step's output is read after the next one
rewrites it.

Tolerances. The tensor and int positions run the same plain version, and
the graphed and eager loops the same ops: held bit for bit. The plain
version against the reference's Pallas kernel in interpret mode: float32,
2e-5 of max|out| (the same math over the keys in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_ar_decode as TAD
import test_torch_serve as TS
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.decode_attention import decode_attention_pallas
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import ar_decode as AR
from repro_torch.core import graphs as G
from repro_torch.core.selective import GuidancePlan
from repro_torch.kernels import decode_attention as KD
from repro_torch.models import attention as TA
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ContinuousEngine


def _t(*shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)


def _pos(p):
    return torch.tensor([p], dtype=torch.int32)


# -- B5 at a tensor position ---------------------------------------------------------


@pytest.mark.parametrize("S,pos,window", [(72, 0, None), (72, 40, None), (72, 71, 16),
                                          (256, 255, 64), (256, 100, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b5_tensor_position_equals_int_position(S, pos, window, dtype):
    q, k, v = _t(2, 8, 16, seed=pos, dtype=dtype), _t(2, S, 2, 16, seed=pos + 1, dtype=dtype), \
        _t(2, S, 2, 16, seed=pos + 2, dtype=dtype)
    want = KD.decode_attention(q, k, v, pos, window=window)
    assert torch.equal(KD.decode_attention(q, k, v, _pos(pos), window=window), want)
    assert torch.equal(KD.decode_attention_plain(q, k, v, _pos(pos), window=window), want)
    assert KD.LAUNCHES == {"decode_attention": 0}


@pytest.mark.parametrize("W,pos,window", [(64, 20, 64), (64, 200, 16), (48, 47, None)])
def test_b5_ring_tensor_position_equals_int_position(W, pos, window):
    q, k, v = _t(2, 8, 16, seed=W), _t(2, W, 2, 16, seed=W + 1), _t(2, W, 2, 16, seed=W + 2)
    slots = np.arange(W)
    sp = pos - (pos - slots) % W
    sp = torch.from_numpy(np.where(sp < 0, -1, sp).astype(np.int32))
    want = KD.decode_attention(q, k, v, pos, window=window, slot_pos=sp)
    assert torch.equal(KD.decode_attention(q, k, v, _pos(pos), window=window, slot_pos=sp),
                       want)
    assert torch.equal(KD.ring_valid(sp, _pos(pos), window), KD.ring_valid(sp, pos, window))


def test_b5_position_tensor_is_checked():
    q, k = torch.zeros(1, 2, 8), torch.zeros(1, 16, 1, 8)
    with pytest.raises(ValueError):
        KD.decode_attention(q, k, k, torch.tensor([3, 4], dtype=torch.int32))
    with pytest.raises(ValueError):
        KD.decode_attention(q, k, k, torch.tensor([3], dtype=torch.int64))


@pytest.mark.parametrize("S,pos,window,bk", [(256, 0, None, 128), (256, 130, None, 128),
                                             (256, 255, 64, 64), (512, 300, 100, 128)])
def test_b5_tensor_position_against_the_pallas_kernel(S, pos, window, bk):
    """The reference's kernel reads its position from a scalar-prefetch
    array; here it is traced under ``jit``, as inside its ``lax.scan``."""
    rng = np.random.default_rng(S + pos)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((2, 8, 32), (2, S, 2, 32), (2, S, 2, 32)))
    pallas = jax.jit(lambda q, k, v, p: decode_attention_pallas(q, k, v, p, window=window,
                                                                bk=bk, interpret=True))
    want = np.asarray(pallas(q, k, v, jnp.asarray([pos], jnp.int32)))
    out = KD.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)), _pos(pos),
                              window=window)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())


def _kernel_tiles(launch, pos, window, ring, tile):
    """Each block's tiles, as ``block_split`` in ``csrc/decode_attention.cu``
    computes them on the device from ``pos`` (a line-by-line transcription)."""
    lo = max(0, pos - window + 1) if window else 0
    t0, n = 0, launch.span
    if not ring:
        t0 = lo // tile
        n = min(max(pos, 0) // tile - t0 + 1, launch.span)
    per = -(-n // launch.cluster)
    return [range(t0 + r * per, min(t0 + n, t0 + r * per + per)) for r in range(launch.cluster)]


@settings(max_examples=300, deadline=None)
@given(S=st.integers(1, 8192), data=st.data(), window=st.one_of(st.none(), st.integers(1, 5000)),
       tile=st.sampled_from([32, 64]))
def test_capacity_plan_covers_exactly_the_attended_keys(S, data, window, tile):
    """One launch from shapes alone; at every position its blocks visit
    tiles inside the cache whose keys cover [lo, pos] exactly once, no
    more tiles than ``span``; ``decode_split_plan`` mirrors the split."""
    pos = data.draw(st.integers(0, S - 1))
    launch = KD.decode_launch_plan(S, window, tile=tile)
    assert 1 <= launch.cluster <= min(KD.MAX_CLUSTER, launch.span)
    blocks = _kernel_tiles(launch, pos, window, False, tile)
    tiles = [t for b in blocks for t in b]
    assert len(tiles) == len(set(tiles)) <= launch.span
    assert all(0 <= t < -(-S // tile) for t in tiles)
    lo = max(0, pos - window + 1) if window else 0
    keys = sorted(k for t in tiles for k in range(t * tile, (t + 1) * tile) if lo <= k <= pos)
    assert keys == list(range(lo, pos + 1))
    plan = KD.decode_split_plan(S, pos, window, tile=tile)
    live = [b for b in blocks if len(b)]
    assert (plan.first_key, plan.tiles, plan.cluster) == (live[0][0] * tile, len(tiles), len(live))


@settings(max_examples=100, deadline=None)
@given(S=st.integers(1, 4096), pos=st.integers(0, 100_000),
       window=st.one_of(st.none(), st.integers(1, 5000)), tile=st.sampled_from([32, 64]))
def test_capacity_plan_of_a_ring_visits_every_slot_once(S, pos, window, tile):
    launch = KD.decode_launch_plan(S, window, ring=True, tile=tile)
    tiles = [t for b in _kernel_tiles(launch, pos, window, True, tile) for t in b]
    assert tiles == list(range(-(-S // tile)))


def test_launch_plan_depends_on_shapes_alone():
    assert KD.decode_launch_plan(768) == (12, 6)
    assert KD.decode_launch_plan(4096) == (64, 8)
    assert KD.decode_launch_plan(4096, window=128) == (3, 3)
    assert KD.decode_launch_plan(4096, window=128, tile=32) == (5, 5)
    assert KD.decode_launch_plan(256, window=4096, ring=True) == (4, 4)


# -- decode_step at a tensor position -------------------------------------------------


def _prefilled(arch, S, cap, seed):
    cfg = get_smoke_config(arch)
    model = Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, S)))
    _, caches, _ = model(toks, want_caches=True)
    return model, model.prepare_decode_caches(caches, seq_len=S, capacity=cap), cfg


@pytest.mark.parametrize("arch,S,cap", [("llama3.2-1b", 12, 20), ("h2o-danube-3-4b", 70, 80)])
def test_decode_step_at_a_tensor_position_equals_the_int_form(arch, S, cap):
    """llama3.2-1b on a linear cache; h2o-danube-3-4b's prompt is past its
    reduced window (64), so it decodes on ring caches."""
    model, caches, cfg = _prefilled(arch, S, cap, seed=3)
    assert ("slot_pos" in caches[0]) == (arch == "h2o-danube-3-4b")
    twin = [{n: t.clone() for n, t in c.items()} for c in caches]
    emb = model.embed_tokens(torch.tensor([[5], [7]]))
    with torch.no_grad():
        for pos in range(S, S + 4):
            a, _ = model.decode_step(emb, caches, pos)
            p = torch.tensor(pos, dtype=torch.int32) if pos % 2 else _pos(pos)
            b, _ = model.decode_step(emb, twin, p)
            assert torch.equal(a, b)
            emb = model.embed_tokens(a.float().abs().argmax(-1) % cfg.vocab_size)
    for c, d in zip(caches, twin):
        for n in c:
            assert torch.equal(c[n], d[n]), n


# -- the graphed loops, through an eager stand-in for capture ------------------------


class _EagerCapture:
    """``graphs.capture`` on the CPU: runs the step (the first, real step),
    and each replay runs it again and copies its outputs into the first
    run's tensors."""

    def __init__(self):
        self.captures = 0
        self.replays = 0

    def __call__(self, step, mempool=None):
        self.captures += 1
        first = step()
        outer = self

        class Replayable:
            outputs = _map(torch.empty_like, first)

            def replay(self):
                outer.replays += 1
                for dst, src in zip(_flat(self.outputs), _flat(step())):
                    dst.copy_(src)
                return self.outputs

        return Replayable(), first


def _map(fn, out):
    return tuple(None if t is None else fn(t) for t in out) if isinstance(out, tuple) \
        else fn(out)


def _flat(out):
    return [t for t in (out if isinstance(out, tuple) else (out,)) if t is not None]


@pytest.fixture
def eager_graphs(monkeypatch):
    cap = _EagerCapture()
    monkeypatch.setattr(G, "capture", cap)
    monkeypatch.setattr(G, "pool", lambda: None)
    monkeypatch.setattr(AR, "_use_graphs", lambda graphs, tokens: bool(graphs))
    return cap


@pytest.mark.parametrize("combine,kw", [("cfg", {}), ("apg", dict(apg_eta=0.3)),
                                        ("interval", dict(interval=(0.25, 0.75)))])
def test_graphed_decode_loop_equals_the_eager_loop(eager_graphs, combine, kw):
    """Two generates of different prompt lengths and plans on one model:
    the second reuses the first's static caches and graphs; tokens and
    teacher-forced logits equal the eager loop's bit for bit."""
    cfg = get_smoke_config("llama3.2-1b")
    model = Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for S, frac in ((12, 0.25), (9, 0.5)):
        toks = torch.from_numpy(np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S)))
        plan = GuidancePlan.suffix(8, frac, 3.0)
        run = dict(combine=combine, capacity=24, **kw)
        want, end = AR.guided_decode(model, toks, plan, graphs=False, **run)
        got, end2 = AR.guided_decode(model, toks, plan, graphs=True, **run)
        assert end == end2 and torch.equal(got, want)
        tf = AR.teacher_forced_logits(model, toks, plan, want, graphs=True, **run)
        assert torch.equal(tf, AR.teacher_forced_logits(model, toks, plan, want, graphs=False,
                                                        **run))
    assert len(model._decode_loops) == 1
    assert eager_graphs.captures == 2      # one FULL and one COND step, captured once


@pytest.mark.parametrize("combine,kw,seed,frac", [
    ("cfg", {}, TAD.SEEDS["llama3.2-1b"], 0.5),
    ("apg", dict(apg_eta=0.3), TAD.SEEDS["apg"], 0.25),
    ("interval", dict(interval=(0.25, 0.75)), TAD.SEEDS["interval"], 0.25)])
def test_graphs_none_on_the_cpu_matches_the_reference(zoo, combine, kw, seed, frac):
    """``graphs=None`` (the default) on CPU tensors is the eager loop: the
    reference's tokens up to the first undecided step (the guard of
    ``tests/test_torch_ar_decode.py``), and ``graphs=False``'s tokens."""
    pair = zoo("llama3.2-1b")
    toks = pair.prompt(2, 16, seed=seed)
    TAD._assert_decode_matches(pair, toks, 8, frac, combine=combine, **kw)
    t = torch.from_numpy(toks).long()
    plan = GuidancePlan.suffix(8, frac, 3.0)
    assert torch.equal(
        AR.guided_decode(pair.model, t, plan, combine=combine, graphs=None, **kw)[0],
        AR.guided_decode(pair.model, t, plan, combine=combine, graphs=False, **kw)[0])


@pytest.fixture(scope="module")
def zoo():
    pairs = {}

    def get(arch):
        if arch not in pairs:
            pairs[arch] = TAD.Pair(arch)
        return pairs[arch]

    return get


def test_graphs_true_on_the_cpu_raises():
    cfg = get_smoke_config("llama3.2-1b")
    model = Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA"):
        AR.guided_decode(model, toks, GuidancePlan.suffix(2, 0.5, 3.0), graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        ContinuousEngine(model, cfg, kv="paged", graphs=True)
    assert not ContinuousEngine(model, cfg, kv="paged").graphs


@pytest.fixture(scope="module")
def world():
    return TS.World()


class _PointerRecording(TS._Recording):
    """Records the device row buffers' addresses at every ragged step, and
    the logits of a graphed step (which samples through ``_draw`` alone)."""

    ptrs: list
    graphed_step = False

    def _ragged_step(self, st, uids):
        self.ptrs = getattr(self, "ptrs", [])
        self.ptrs.append(tuple(t.data_ptr() for t in st["dev"].values()))
        self.graphed_step = self.graphs
        try:
            return super()._ragged_step(st, uids)
        finally:
            self.graphed_step = False

    def _draw(self, nxt, logits, uids, temps, keys, steps):
        if self.graphed_step:      # a copy: the next replay rewrites the static logits
            for i, uid in enumerate(uids):
                self.logits.setdefault(uid, []).append(logits[i].float().numpy().copy())
        return super()._draw(nxt, logits, uids, temps, keys, steps)


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_ragged_rows_stay_in_fixed_buffers_and_events_match(world, eager_graphs, graphed,
                                                            kv_dtype):
    """The ragged step's device rows keep their addresses from tick to tick
    (a captured step reads them there); the event stream, counters and
    tokens hold the reference engine's contract, eager and graphed."""
    kw = dict(TS.BASE, step_mode="ragged", kv_dtype=kv_dtype)
    make = TS._trace_reqs("graphs")
    arrivals = [0, 0, 1, 2]
    jeng = TS.JEngine(world.params, world.jcfg, **kw)
    jout = jeng.serve_trace(make(TS.JRequest), arrivals)
    teng = _PointerRecording(world.model, world.cfg, **kw)
    teng.graphs = graphed
    tout = teng.serve_trace(make(TS.ServeRequest), arrivals)
    assert len(teng.ptrs) > 3 and len(set(teng.ptrs)) == 1
    TS._check(world, jeng, jout, teng, tout, make(TS.ServeRequest))
    assert eager_graphs.captures == int(graphed)
    assert eager_graphs.replays == (len(teng.ptrs) - 1 if graphed else 0)
    assert teng.metrics.step_compiles == 1


def test_graphed_ragged_step_draws_hot_rows_after_the_replay(world, eager_graphs):
    """Rows at temperature > 0 are drawn eagerly from their per-request
    generators after the replay: the graphed engine's tokens equal the
    eager engine's."""
    kw = dict(TS.BASE, step_mode="ragged")
    reqs = lambda: [TS.ServeRequest(uid=f"h{i}", prompt=f"hot {i}", max_new_tokens=6,  # noqa: E731
                                    temperature=0.8 if i % 2 else 0.0) for i in range(4)]
    outs = []
    for graphed in (False, True):
        eng = ContinuousEngine(world.model, world.cfg, **kw)
        eng.graphs = graphed
        outs.append(eng.serve_trace(reqs(), [0, 0, 1, 2]))
    assert outs[0] == outs[1]


# -- launch bookkeeping ---------------------------------------------------------------


def test_launch_bookkeeping_counts_each_replay_once():
    """A capture's change of the counters, restored, then added once a
    replay: the counts end where an eager run's would."""
    counters = ({"a": 2, "b": 0}, {(4, 8): 1})
    before = G.snapshot(counters)
    counters[0]["a"] += 3                       # the capture's wrapper calls
    counters[0]["b"] += 1
    counters[1][(4, 8)] += 2
    counters[1][(16, 8)] = 1
    delta = G.launch_delta(before, G.snapshot(counters))
    assert delta == ({"a": 3, "b": 1}, {(4, 8): 2, (16, 8): 1})
    G.restore(counters, before)
    assert counters == ({"a": 2, "b": 0}, {(4, 8): 1})
    for _ in range(5):
        G.add_launches(counters, delta)
    G.add_launches(counters, delta, times=2)
    assert counters == ({"a": 23, "b": 7}, {(4, 8): 15, (16, 8): 7})
    assert G.launch_delta(before, before) == ({}, {})


def test_bookkeeping_tracks_every_kernel_counter():
    from repro_torch.kernels import cfg_combine, flash_attention, paged_decode_attention, rmsnorm
    tracked = {id(c) for c in G.COUNTERS}
    for m in (cfg_combine, KD, flash_attention, paged_decode_attention, rmsnorm):
        assert id(m.LAUNCHES) in tracked
    assert id(rmsnorm.LAUNCH_SHAPES) in tracked
    rmsnorm.reset_launches()
    assert G.COUNTERS[-1] is rmsnorm.LAUNCH_SHAPES


def test_decode_pos_forms():
    dp = TA.decode_pos(7, "cpu")
    assert dp.pos.dtype == torch.int32 and dp.index.dtype == torch.int64
    assert dp.pos.tolist() == dp.index.tolist() == [7]
    assert TA.decode_pos(dp, "cpu") is dp
    t = torch.tensor(9, dtype=torch.int32)
    assert TA.decode_pos(t, "cpu").pos.data_ptr() == t.data_ptr()
