"""The other decoder families in the port's serve engine, slot arena: the
reduced deepseek-v2-lite-16b (MLA + MoE), mixtral-8x7b (MoE, windowed
GQA), recurrentgemma-9b (RG-LRU + local attention), xlstm-350m (mLSTM /
sLSTM) and chameleon-34b (GQA with qk-norm), each against the reference's
``ContinuousEngine(kv="slot")`` on the same weights (drawn from a seed with
numpy, converted) and the same trace: joins mid-flight, FULL -> COND
transitions at f = 0.25 and 0.5, and a defrag, at guidance scale 3.
recurrentgemma serves prompts of 66 under its reduced window of 64, so
that its local attention keeps a ring a row (B5's ring-a-row form
underneath). recurrentgemma and xlstm are cut to one block of each kind
(``CUT``): the reference's steps compile in proportion to depth.

Each family's reference run happens once (a module-scoped cache). The run
contract:

* the event streams and the counters are equal exactly, and so are the
  signature keys and ``kv_hbm_bytes()`` (the sum of a slot row's leaves:
  latents, rings, float32 recurrent states);
* greedy tokens are equal up to the first step the port's logits do not
  decide: a step whose top logit beats every other by no more than
  ``2 * TOL[arch] * (2s - 1)`` of the row's largest logit. ``TOL`` is the
  largest difference per unit of 2s - 1 between the port engine's logits
  and the reference's teacher-forced ones, measured on these traces with
  ``tests/test_torch_serve.py``'s harness (deepseek 3.1e-3, mixtral
  2.7e-3, chameleon 2.4e-3, recurrentgemma 7.1e-3, xlstm 3.1e-3), rounded
  up. At least 75% of the tokens must come before that step;
* MoE stacks route every live token with a top-k margin of at least
  ``ROUTER_MARGIN`` (``tests/test_torch_families.py``'s rule), so that the
  two sides route alike; padding rows of a step route nothing live.

Port-only checks beside it: each family's per-row decode (a slot arena's
step) equals its decode of each row alone within 1e-5 (float32), a defrag
permutes every leaf, padding rows never feed a live row, the graphed
control flow (``tests/test_torch_graphs.py``'s eager stand-in) equals the
eager engine bit for bit, ``pass_budget="auto"`` installs a budget, and
the roofline prices each family's step by hand arithmetic.

The cases run in one child interpreter with one torch thread (``in_child``),
and each test reads its case's verdict, the child's traceback on a failure.
"""

import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import traceback
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graphs import _EagerCapture

from repro.configs import get_smoke_config as jget_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import ContinuousEngine as JEngine
from repro.serve import ServeRequest as JRequest
from repro_torch import convert, roofline
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import ar_decode as AR
from repro_torch.core import graphs as G
from repro_torch.models import moe as TM
from repro_torch.models.transformer import Transformer, cache_specs
from repro_torch.serve import ContinuousEngine, ServeRequest

FAMILIES = ("deepseek-v2-lite-16b", "mixtral-8x7b", "recurrentgemma-9b", "xlstm-350m",
            "chameleon-34b")
TOL = {"deepseek-v2-lite-16b": 4e-3, "mixtral-8x7b": 3e-3, "chameleon-34b": 3e-3,
       "recurrentgemma-9b": 8e-3, "xlstm-350m": 4e-3}
ROUTER_MARGIN = 0.03
WEIGHT_SEED = 35
# one block of each kind: the reference's steps compile in proportion to depth
CUT = {"xlstm-350m": dict(block_pattern=("mlstm", "slstm"), num_layers=2),
       "recurrentgemma-9b": dict(block_pattern=("rglru", "swa"), num_layers=2)}
COUNTERS = ("step_compiles", "step_launches", "denoiser_passes", "prefill_passes",
            "tokens_emitted", "completed", "uncond_ticks_elided", "pages_reclaimed",
            "peak_pages_in_use", "peak_bytes_in_use", "pages_grown", "preemptions", "resumes",
            "shared_page_hits", "cow_copies", "cache_evictions", "swap_outs", "swap_ins",
            "host_evictions", "prefix_hits", "prefix_misses")


class NumpyMaker(JL.Maker):
    """The reference's parameter maker with numpy draws from ``seed``: its
    scales (fan-in by default), float32 unless asked."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def __call__(self, shape, axes, *, init="normal", scale=None, dtype=None):
        dtype = dtype or jnp.float32
        if init == "zeros":
            return jnp.zeros(shape, dtype)
        if init == "ones":
            return jnp.ones(shape, dtype)
        if scale is None:
            scale = 1.0 / math.sqrt(max(1, math.prod(shape[:-1])))
        return jnp.asarray(self.rng.standard_normal(shape, np.float32) * scale).astype(dtype)


@functools.lru_cache(maxsize=None)
def world(arch: str, seed: int = WEIGHT_SEED):
    """-> (reference config, port config, reference params, port model on
    the same weights, drawn from ``seed``)."""
    cut = CUT.get(arch, {})
    jcfg = dataclasses.replace(jget_smoke(arch), **cut)
    cfg = dataclasses.replace(get_smoke_config(arch), **cut)
    params = JT.init_model(jcfg, NumpyMaker(seed))
    model = Transformer.from_state_dict(
        cfg, convert.from_jax_model_params(jax.tree.map(np.asarray, params)))
    return jcfg, cfg, params, model


class Margins:
    """The smallest top-k router margin (the k-th minus the (k+1)-th router
    log-probability) over the live rows each MoE layer routes while
    ``recording``: ``live`` rows of the batch, all of them when None."""

    def __init__(self):
        self.live = None
        self.smallest = math.inf

    def recording(self):
        route = TM.route

        def recorded(p, cfg, x, C):
            r = route(p, cfg, x, C)
            lp = torch.log(r.probs.detach()).sort(dim=-1, descending=True).values
            k = cfg.moe.top_k
            gap = (lp[..., k - 1] - lp[..., k])[:self.live]
            if gap.numel():
                self.smallest = min(self.smallest, float(gap.min()))
            return r

        return mock.patch.object(TM, "route", recorded)


class Recording(ContinuousEngine):
    """The port engine, keeping the logits each token came from, and
    telling ``margins`` how many rows of each forward are live: a slot
    prefill's one, a signature group's requests, a paged prefill's
    admissions, the ragged step's pass rows."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.logits: dict[str, list] = {}
        self.margins = Margins()
        self._live: dict = {}

    def _sample(self, logits, uids, temps, keys, steps):
        for i, uid in enumerate(uids):
            self.logits.setdefault(uid, []).append(logits[i].float().numpy())
        return super()._sample(logits, uids, temps, keys, steps)

    def _prefill_slot(self, req, slot, key):
        self.margins.live = None
        return super()._prefill_slot(req, slot, key)

    def _prefill_paged_group(self, Sb, items):
        self.margins.live = len(items)
        return super()._prefill_paged_group(Sb, items)

    def _signature_step(self, f, c):
        self._live = {"f": len(f["uids"]), "c": len(c["uids"])}
        return super()._signature_step(f, c)

    def _decode_rows(self, emb, dev, group, stream):
        self.margins.live = self._live[group]
        return super()._decode_rows(emb, dev, group, stream)

    def _stage_ragged(self, rows, n_full):
        self.margins.live = len(rows)
        return super()._stage_ragged(rows, n_full)


def run(arch: str, kw: dict, make, arrivals, seed: int = WEIGHT_SEED):
    """The reference engine and the recording port engine over one trace,
    on ``world(arch, seed)``. -> (reference engine, its tokens, port
    engine, its tokens)."""
    jcfg, cfg, params, model = world(arch, seed)
    jeng = JEngine(params, jcfg, **kw)
    jout = jeng.serve_trace(make(JRequest), arrivals)
    teng = Recording(model, cfg, **kw)
    with teng.margins.recording():
        tout = teng.serve_trace(make(ServeRequest), arrivals)
    return jeng, jout, teng, tout


def check(arch: str, jeng, jout, teng, tout, reqs) -> None:
    """The run contract of the module docstring."""
    jm, tm = jeng.metrics, teng.metrics
    assert tm.trace.keys() == jm.trace.keys()
    for name in COUNTERS:
        assert getattr(tm, name) == getattr(jm, name), name
    assert teng.kv_hbm_bytes() == jeng.kv_hbm_bytes()
    if teng.pages is not None:
        assert teng.pages.n_free == teng.pages.num_pages
        teng.pages.check()
    if teng.cfg.moe is not None:
        assert teng.margins.smallest >= ROUTER_MARGIN, \
            f"a router near-tie ({teng.margins.smallest:.4f}): the data do not decide the routing"
    assert sorted(tout) == sorted(jout)
    compared = total = 0
    for req in reqs:
        jt, pt = jout[req.uid], tout[req.uid]
        n = min(len(jt), len(pt))
        got = np.stack(teng.logits[req.uid][:n])
        top2 = np.sort(got, axis=-1)[:, -2:]
        slack = 2 * TOL[arch] * (2 * req.guidance_scale - 1) * np.abs(got).max(-1)
        decided = top2[:, 1] - top2[:, 0] > slack
        mismatch = next((i for i in range(n) if jt[i] != pt[i]), n)
        if mismatch < n:
            assert not decided[mismatch], (req.uid, mismatch, jt, pt)
        compared += mismatch
        total += n
    assert compared >= 0.75 * total, (compared, total)


def steps(eng) -> list:
    return sorted(k for k in eng._shapes if k[0] in ("step", "pstep", "rstep"))


# -- the cases run in one child process ---------------------------------------------------
#
# Under the tier-1 run's pytest-xdist workers each worker's torch thread pool
# fights the others' for the cores, and these engines' thousands of small bf16
# ops run ten times slower; a thread count set in the worker would be
# process-wide state. So a module's cases run, in order, in one child
# interpreter with one torch thread, and each test reads its case's verdict.


@contextlib.contextmanager
def eager_capture():
    """``tests/test_torch_graphs.py``'s eager stand-in for a capture, for
    the duration of the block. -> its counts of captures and replays"""
    cap = _EagerCapture()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(G, "capture", cap)
        mp.setattr(G, "pool", lambda: None)
        mp.setattr(AR, "_use_graphs", lambda graphs, tokens: bool(graphs))
        yield cap


def run_cases(cases: dict) -> dict:
    """In the child: each case of ``cases`` (id -> (function, args)). -> id
    -> None, or the traceback of its failure."""
    torch.set_num_threads(1)
    out = {}
    for cid, (fn, args) in cases.items():
        try:
            fn(*args)
            out[cid] = None
        except Exception:
            out[cid] = traceback.format_exc()
    return out


def in_child(module: str, tmp_path_factory) -> dict:
    """``module``'s ``CASES`` run in a child interpreter (``run_cases``).
    -> their verdicts"""
    path = tmp_path_factory.mktemp("verdicts") / f"{module}.json"
    tests = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(tests), "src")
    code = (f"import sys, json; sys.path[:0] = [{tests!r}, {src!r}]; import repro.dist; "
            f"import {module} as M; "
            f"json.dump(M.run_cases(M.CASES), open({str(path)!r}, 'w'))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-8000:]
    return json.loads(path.read_text())


def verdict(verdicts: dict, cid: str) -> None:
    if verdicts[cid] is not None:
        pytest.fail(f"{cid} failed in the child process:\n{verdicts[cid]}", pytrace=False)


# -- the slot arena against the reference ------------------------------------------------

SLOT = dict(num_slots=2, pass_budget=4, prompt_len=8, max_new=6, stop_on_eos=False,
            defrag_threshold=0.3, prefills_per_tick=2)
PROMPT_LEN = {"recurrentgemma-9b": 66}
ARRIVALS = [0, 0, 3]


def slot_kw(arch: str) -> dict:
    return dict(SLOT, prompt_len=PROMPT_LEN.get(arch, SLOT["prompt_len"]))


def trace(R):
    """Two requests at tick 0, the short one (f = 0.25) leaving the long one
    (f = 0.5) in the higher slot, so that the pools are defragmented; a
    third (f = 0.5) joining mid-flight: three signature buckets."""
    return [R(uid=uid, prompt=f"serve {uid}", max_new_tokens=n, selective_fraction=f,
              guidance_scale=3.0) for uid, n, f in (("a", 2, 0.25), ("b", 5, 0.5),
                                                    ("c", 4, 0.5))]


@functools.lru_cache(maxsize=None)
def slot_run(arch: str):
    return run(arch, slot_kw(arch), trace, ARRIVALS)


def _case_slot_arena_matches_reference(arch):
    jeng, jout, teng, tout = slot_run(arch)
    check(arch, jeng, jout, teng, tout, trace(ServeRequest))
    assert steps(teng) == sorted(k for k in jeng._jit if k[0] == "step")
    assert ("defrag",) in teng._shapes and ("defrag",) in jeng._jit
    ring = [layer for layer in teng._pool_c if "slot_pos" in layer]
    if arch == "recurrentgemma-9b":
        assert ring and all(layer["k"].shape[1] == 64 for layer in ring)
    else:
        assert not ring


# -- the port alone ---------------------------------------------------------------------

def _random_pools(cfg, N: int, capacity: int, gen) -> list:
    """``cache_specs`` pools of N rows in float32, random floating leaves."""
    pools = cache_specs(cfg, N, capacity, dtype=torch.float32, device="cpu")
    for layer in pools:
        for t in layer.values():
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
    return pools


def _case_per_row_decode_equals_each_row_alone(arch):
    """A slot arena's step (``decode_step`` with rows: latents written by
    index, recurrent states gathered, stepped and scattered back) equals
    the decode of each row alone on a batch of one, in float32 within 1e-5
    of the largest value; rows no query names are untouched; two padding
    rows on the spare row leave the live rows alone."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    model = Transformer.init(cfg, gen, device="cpu")
    pools = _random_pools(cfg, 6, 12, gen)
    before = [{n: t.clone() for n, t in layer.items()} for layer in pools]
    rows = torch.tensor([3, 0, 4, 1, 5, 5], dtype=torch.int32)
    pos = torch.tensor([7, 2, 0, 5, 0, 0], dtype=torch.int32)
    x = torch.randn(6, 1, cfg.d_model, generator=gen)
    h, _ = model.decode_step(x, pools, pos, rows=rows)
    for b in range(4):
        one = [{n: t[rows[b]:rows[b] + 1].clone() for n, t in layer.items()} for layer in before]
        hb, one = model.decode_step(x[b:b + 1], one, int(pos[b]))
        torch.testing.assert_close(h[b:b + 1], hb, rtol=0, atol=1e-5 * float(hb.abs().max()))
        for layer, alone in zip(pools, one):
            for n, t in alone.items():
                torch.testing.assert_close(layer[n][rows[b]], t[0], rtol=0,
                                           atol=1e-5 * max(1.0, float(t.abs().max())))
    for layer, old in zip(pools, before):
        for n, t in layer.items():
            assert torch.equal(t[2], old[n][2]), n


class _Defrags(ContinuousEngine):
    """Checks every defrag: each active row of every pool leaf (latents,
    rings and their slot positions, float32 states) moves to its request's
    new slot bit for bit."""

    moved = 0

    def _maybe_defrag(self):
        if self._pool_c is None:
            return super()._maybe_defrag()
        old = [{n: t.clone() for n, t in layer.items()} for layer in self._pool_c + self._pool_u]
        slots = {uid: st.slot for uid, st in self._states.items()}
        super()._maybe_defrag()
        for uid, st in self._states.items():
            if st.slot == slots[uid]:
                continue
            self.moved += 1
            for layer, was in zip(self._pool_c + self._pool_u, old):
                for n, t in layer.items():
                    assert torch.equal(t[st.slot], was[n][slots[uid]]), (uid, n)


def _case_defrag_permutes_every_leaf(arch):
    _, cfg, _, model = world(arch)
    eng = _Defrags(model, cfg, **slot_kw(arch))
    eng.serve_trace(trace(ServeRequest), ARRIVALS)
    assert ("defrag",) in eng._shapes and eng.moved > 0
    assert {n for layer in eng._pool_c for n in layer} >= (
        {"c", "k_rope"} if arch.startswith("deepseek") else
        {"conv", "h", "slot_pos"} if arch.startswith("recurrent") else {"C", "c", "h"})


class _PoisonedSpare(Recording):
    """The spare row of every floating pool leaf set to NaN: padding rows
    read and write only it."""

    def _init_pools(self):
        super()._init_pools()
        for layer in self._pool_c + self._pool_u:
            for t in layer.values():
                if t.is_floating_point():
                    t[self.num_slots] = float("nan")


def _case_padding_rows_never_feed_a_live_row(arch):
    """Three requests at once pad their groups to four rows: with NaN in
    the spare row the live rows' logits are those of a clean engine, bit
    for bit."""
    _, cfg, _, model = world(arch)
    kw = dict(slot_kw(arch), num_slots=4, pass_budget=6, prefills_per_tick=3)
    reqs = trace(ServeRequest)
    clean, dirty = Recording(model, cfg, **kw), _PoisonedSpare(model, cfg, **kw)
    assert clean.serve_trace(reqs, [0, 0, 0]) == dirty.serve_trace(reqs, [0, 0, 0])
    assert ("step", 4, 0) in dirty._shapes
    for uid, rows in clean.logits.items():
        for a, b in zip(rows, dirty.logits[uid]):
            assert np.array_equal(a, b), uid


class Drawn(ContinuousEngine):
    """Keeps a copy of the logits of every sample, eager or after a
    replay (which rewrites the graph's logits)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.logits: dict = {}

    def _draw(self, nxt, logits, uids, temps, keys, steps):
        for i, uid in enumerate(uids):
            self.logits.setdefault(uid, []).append(logits[i].clone())
        return super()._draw(nxt, logits, uids, temps, keys, steps)


def _case_graphed_slot_steps_equal_eager(arch):
    """The signature steps through their graphed control flow (one capture
    per bucket at its counted compile, replays after, pools written in
    place, a defrag between them) equal the eager engine bit for bit."""
    _, cfg, _, model = world(arch)
    runs = []
    with eager_capture() as eager_graphs:
        for graphed in (False, True):
            eng = Drawn(model, cfg, **slot_kw(arch))
            eng.graphs = graphed
            runs.append((eng, eng.serve_trace(trace(ServeRequest), ARRIVALS)))
    (ee, eo), (ge, go) = runs
    assert go == eo and ge.metrics.trace.keys() == ee.metrics.trace.keys()
    assert ("defrag",) in ge._shapes
    assert sorted(ge._sig_graphs) == steps(ge) and eager_graphs.captures == len(steps(ge))
    assert eager_graphs.replays == ge.metrics.step_launches - len(steps(ge)) > 0
    for uid in ee.logits:
        assert all(torch.equal(a, b) for a, b in zip(ge.logits[uid], ee.logits[uid]))


def _case_auto_budget_prices_the_family(arch):
    """``pass_budget="auto"`` runs its signature steps on padding rows and
    installs a budget of at least 2 from the family's roofline."""
    _, cfg, _, model = world(arch)
    eng = ContinuousEngine(model, cfg, **dict(SLOT, pass_budget="auto"))
    rep = eng.autotune_budget()
    assert eng.pass_budget == eng.scheduler.pass_budget == rep["budget"] >= 2
    assert eng.metrics.step_compiles == 2
    out = eng.serve(trace(ServeRequest)[:2])
    assert [len(v) for v in out.values()] == [2, 5]


def _case_encoder_raises_and_roofline_counts_each_family():
    """The roofline by hand: the weights a decode row multiplies by (MLA's
    absorbed projections, every expert at C = top_k slots, the recurrent
    blocks'), each layer's cache bytes (MLA's r + dr latent values a key,
    windowed keys capped at W, a recurrent state read and written once,
    no keys)."""
    enc = get_smoke_config("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder"):
        ContinuousEngine(Transformer.init(enc, torch.Generator().manual_seed(0), device="cpu"),
                         enc)
    ds = get_smoke_config("deepseek-v2-lite-16b")       # d 256, H 4, r 64, dn 32, dr 16, dv 32
    D, H, V = 256, 4, 512
    mla = D * H * 48 + D * 80 + 64 * H * 32 * 2 + H * 32 * D
    dense, moe = 3 * D * ds.d_ff, D * 4 + 2 * 4 * 3 * D * 128 + 3 * D * 128
    assert roofline.matmul_params(ds) == 2 * mla + dense + moe + D * V
    for tokens in (16, 640):
        cost = roofline.decode_step(ds, forwards=(3,), kv_tokens=tokens, weight_bytes=10 ** 6,
                                    out_rows=3)
        per_row = 2 * (2 * H * 80 + 2 * H * 64) * tokens
        assert cost.flops == (2 * roofline.matmul_params(ds) + per_row) * 3 + 5 * V * 3
        assert cost.bytes == 10 ** 6 + 2 * 80 * 2 * tokens * 3 + 4 * V * 6
    xl = get_smoke_config("xlstm-350m")                 # 3 mLSTM, 1 sLSTM, d 256, H 4
    dh = 2 * D // H
    mstate, sstate = H * dh * dh + H * dh + H, 4 * D
    cost = roofline.decode_step(xl, forwards=(1,), kv_tokens=10 ** 6, weight_bytes=0,
                                out_rows=1)
    assert cost.bytes == (3 * 2 * 4 * mstate + 2 * 4 * sstate) + 4 * V * 2    # no keys
    mlstm = 2 * D * 2 * D + 3 * (2 * D) ** 2 + 2 * 2 * D * H + 2 * D * D
    slstm = 4 * D * D + 4 * D * (D // H) + 4 * D * D
    assert roofline.matmul_params(xl) == 3 * mlstm + slstm + D * V
    mx = get_smoke_config("mixtral-8x7b")               # swa, W 64
    at = {t: roofline.decode_step(mx, forwards=(1,), kv_tokens=t, weight_bytes=0, out_rows=1)
          for t in (64, 4096)}
    assert at[64].bytes == at[4096].bytes and at[64].flops == at[4096].flops


# -- the tests: each case's verdict ------------------------------------------------------

ROW_ARCHS = ["deepseek-v2-lite-16b", "mixtral-8x7b", "recurrentgemma-9b", "xlstm-350m"]
STATE_ARCHS = ["deepseek-v2-lite-16b", "recurrentgemma-9b", "xlstm-350m"]
GRAPH_ARCHS = ["deepseek-v2-lite-16b", "xlstm-350m"]
CASES = {f"{fn.__name__[6:]}[{arch}]": (fn, (arch,)) for fn, archs in (
    (_case_slot_arena_matches_reference, FAMILIES),
    (_case_per_row_decode_equals_each_row_alone, ROW_ARCHS),
    (_case_defrag_permutes_every_leaf, STATE_ARCHS),
    (_case_padding_rows_never_feed_a_live_row, STATE_ARCHS),
    (_case_graphed_slot_steps_equal_eager, GRAPH_ARCHS),
    (_case_auto_budget_prices_the_family, GRAPH_ARCHS)) for arch in archs}
CASES["encoder_raises_and_roofline_counts_each_family"] = (
    _case_encoder_raises_and_roofline_counts_each_family, ())


@pytest.fixture(scope="module")
def verdicts(tmp_path_factory):
    return in_child(__name__, tmp_path_factory)


@pytest.mark.parametrize("arch", FAMILIES)
def test_slot_arena_matches_reference(verdicts, arch):
    verdict(verdicts, f"slot_arena_matches_reference[{arch}]")


@pytest.mark.parametrize("arch", ROW_ARCHS)
def test_per_row_decode_equals_each_row_alone(verdicts, arch):
    verdict(verdicts, f"per_row_decode_equals_each_row_alone[{arch}]")


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_defrag_permutes_every_leaf(verdicts, arch):
    verdict(verdicts, f"defrag_permutes_every_leaf[{arch}]")


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_padding_rows_never_feed_a_live_row(verdicts, arch):
    verdict(verdicts, f"padding_rows_never_feed_a_live_row[{arch}]")


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graphed_slot_steps_equal_eager(verdicts, arch):
    verdict(verdicts, f"graphed_slot_steps_equal_eager[{arch}]")


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_auto_budget_prices_the_family(verdicts, arch):
    verdict(verdicts, f"auto_budget_prices_the_family[{arch}]")


def test_encoder_raises_and_roofline_counts_each_family(verdicts):
    verdict(verdicts, "encoder_raises_and_roofline_counts_each_family")
