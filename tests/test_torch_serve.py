"""The port's ``ContinuousEngine`` against the reference's on the same
weights (converted from ``init_model``), the same requests and the same
arrival traces, on the CPU, at the reduced llama3.2-1b (2 layers, d_model
256, vocab 512) with pages of 4 and prompts of up to 8.

For every scenario: the event streams (``metrics.trace.keys()``) are equal
exactly, and so are ``step_compiles``, ``step_launches``,
``pages_reclaimed`` and the peak pages; the pool is balanced at drain.

Greedy tokens are held equal up to the first step the logits do not decide,
the guard of ``tests/test_torch_ar_decode.py``: the port engine's logits
for each emitted token are recorded, the reference's for the same tokens
are computed by teacher forcing through its own prefill and decode steps
(FULL or COND as the port's token events say), and a step is undecided
where, for some token j, the reference's margin of its top token over j is
no larger than the two logits' differences. The first token that differs
from the reference engine's must come at an undecided step; every token
before it is equal, and at least 75% of all tokens must come before it.

The logits must agree within LOGIT_TOL per unit of 2s - 1 (the combine
multiplies the streams' differences by it; s = 3 gives
``tests/test_torch_ar_decode.py``'s 1.5e-2) of the largest logit, and
half as much again for int8 pools, where a K/V value one bf16 step off
can round to the next int8 step, about two bf16 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import ar_decode as JAR
from repro.core.guidance import apg_combine as japg
from repro.core.guidance import cfg_combine as jcfg_combine
from repro.core.selective import Mode as JMode
from repro.core.selective import round_half_up
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import ContinuousEngine as JEngine
from repro.serve import ServeRequest as JRequest
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_config
from repro_torch.dist import MeshShape
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ContinuousEngine, ServeRequest
from repro_torch.serve.state import kv_page_bytes, pages_for

LOGIT_TOL = 3e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The engines run thousands of small ops: on a machine shared by
    several test workers, torch's thread pool spends more time waiting than
    computing, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recording(ContinuousEngine):
    """The port engine, keeping the logits each request's tokens came from."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.logits: dict[str, list] = {}

    def _sample(self, logits, uids, temps, keys, steps):
        for i, uid in enumerate(uids):
            self.logits.setdefault(uid, []).append(logits[i].float().numpy())
        return super()._sample(logits, uids, temps, keys, steps)


class World:
    """Reference params, the port model on the same weights, and the
    reference's jitted prefill and one-stream decode step."""

    def __init__(self):
        self.jcfg, self.cfg = jget_smoke("llama3.2-1b"), get_smoke_config("llama3.2-1b")
        self.params = JT.init_model(self.jcfg, JL.ArrayMaker(jax.random.PRNGKey(0)))
        self.model = Transformer.from_state_dict(
            self.cfg, convert.from_jax_model_params(jax.tree.map(np.asarray, self.params)))
        jcfg = self.jcfg
        self.prefill = jax.jit(lambda p, t: JAR.prefill(p, jcfg, t))
        self.step = jax.jit(lambda p, t, c, pos: JAR.decode_step_cond(p, jcfg, t, c, pos))

    def teacher_forced(self, jeng, req, tokens, modes):
        """The reference's float32 logits that choose each of ``tokens`` for
        ``req``, fed ``tokens``, with the engine's plan, prompt and combine;
        ``modes[i]`` is the mode of the step that chose token i + 1."""
        plan = jeng._plan_for(req)
        S = jeng._prompt_len_for(req)
        ids = jnp.asarray(jeng._tokenize(req.prompt, S))
        cap = jeng.capacity
        lc, cc = self.prefill(self.params, ids)
        lu, cu = self.prefill(self.params, JAR.null_prompt(ids))
        cc = JT.prepare_decode_caches(self.jcfg, cc, seq_len=S, capacity=cap)
        cu = JT.prepare_decode_caches(self.jcfg, cu, seq_len=S, capacity=cap)
        n, s = plan.total_steps, plan.guidance_scale
        a, b = (round_half_up(n * jeng.interval[0]), round_half_up(n * jeng.interval[1]))

        def comb(l_u, l_c, i):
            if jeng.combine == "apg":
                return japg(l_u, l_c, jnp.float32(s), eta=jeng.apg_eta,
                            threshold=jeng.apg_threshold)
            sc = s if jeng.combine != "interval" or a <= i < b else 1.0
            return jcfg_combine(l_u, l_c, jnp.float32(sc))

        out = [comb(lu, lc, 0)]
        for i in range(len(tokens) - 1):
            tok = jnp.asarray([tokens[i]], jnp.int32)
            lc, cc = self.step(self.params, tok, cc, S + i)
            if modes[i] is JMode.FULL:
                lu, cu = self.step(self.params, tok, cu, S + i)
                out.append(comb(lu, lc, i))
            else:
                out.append(lc)
        return np.stack([np.asarray(x, np.float32)[0] for x in out])


@pytest.fixture(scope="module")
def world():
    return World()


def _run(world, kw, make_reqs, arrivals):
    jeng = JEngine(world.params, world.jcfg, **kw)
    jout = jeng.serve_trace(make_reqs(JRequest), arrivals)
    teng = _Recording(world.model, world.cfg, **kw)
    tout = teng.serve_trace(make_reqs(ServeRequest), arrivals)
    return jeng, jout, teng, tout


def _check(world, jeng, jout, teng, tout, reqs):
    """The scenario contract: events and counters equal, the pool balanced,
    tokens equal up to the first undecided step. -> (compared, total)."""
    jm, tm = jeng.metrics, teng.metrics
    assert tm.trace.keys() == jm.trace.keys()
    for name in ("step_compiles", "step_launches", "pages_reclaimed", "peak_pages_in_use",
                 "peak_bytes_in_use", "denoiser_passes", "tokens_emitted"):
        assert getattr(tm, name) == getattr(jm, name), name
    if teng.pages is not None:
        assert teng.pages.n_free == teng.pages.num_pages
        teng.pages.check()
    assert sorted(tout) == sorted(jout)
    tol = LOGIT_TOL * (1.5 if teng.kv_dtype == "int8" else 1.0)
    compared = total = 0
    for req in reqs:
        jt, pt = jout[req.uid], tout[req.uid]
        n = min(len(jt), len(pt))
        mismatch = next((i for i in range(n) if jt[i] != pt[i]), n)
        upto = min(mismatch + 1, len(pt))
        conds = [ev.get("cond") for ev in tm.trace if ev.kind == "token" and ev.uid == req.uid]
        modes = [JMode.COND if c else JMode.FULL for c in conds[1:]]
        ref = world.teacher_forced(jeng, req, pt[:upto], modes)
        got = np.stack(teng.logits[req.uid][:upto])
        big = np.abs(ref).max()
        err = np.abs(got - ref)
        scale = 2 * req.guidance_scale - 1
        assert err.max() <= tol * scale * big, (req.uid, err.max() / big / scale)
        top = ref.argmax(-1)[:, None]
        gap = np.take_along_axis(ref, top, -1) - ref
        slack = np.take_along_axis(err, top, -1) + err
        other = np.arange(ref.shape[-1])[None] != top
        undecided = ((gap <= slack) & other).any(-1)
        if mismatch < n:
            assert undecided[mismatch], (req.uid, mismatch, jt, pt)
        compared += mismatch
        total += n
    assert compared >= 0.75 * total, (compared, total)
    return compared, total


def _trace_reqs(prefix):
    return lambda R: [R(uid=f"r{i}", prompt=f"{prefix} {i}", max_new_tokens=6)
                      for i in range(4)]


BASE = dict(num_slots=4, pass_budget=4, prompt_len=8, max_new=6, selective_fraction=0.5,
            stop_on_eos=False, kv="paged", page_size=4, prefills_per_tick=2)


@pytest.mark.parametrize("combine", [dict(combine="cfg"), dict(combine="apg", apg_eta=0.3),
                                     dict(combine="interval", interval=(0.25, 0.75))],
                         ids=["cfg", "apg", "interval"])
def test_paged_trace_each_combine(world, combine):
    """``test_paged.py``'s mid-flight trace (batched k > 1 prefills)."""
    make = _trace_reqs("trace request")
    jeng, jout, teng, tout = _run(world, dict(BASE, **combine), make, [0, 0, 1, 3])
    _check(world, jeng, jout, teng, tout, make(ServeRequest))
    assert teng.metrics.pages_reclaimed > 0


def test_mixed_lengths_one_pool(world):
    """``test_paged.py``'s mixed prompt lengths in one pool; prefills keyed
    on pow2 length buckets."""
    lens = [3, 5, 8, 6]

    def make(R):
        return [R(uid=f"m{i}", prompt=f"mixed len request {i}", max_new_tokens=5,
                  prompt_len=n) for i, n in enumerate(lens)]

    kw = dict(BASE, pass_budget=6, max_new=5, selective_fraction=0.4, prefills_per_tick=4)
    jeng, jout, teng, tout = _run(world, kw, make, [0, 0, 1, 2])
    _check(world, jeng, jout, teng, tout, make(ServeRequest))
    assert {k[1] for k in teng._shapes if k[0] == "prefill"} == {4, 8}
    assert teng.metrics.peak_pages_in_use >= max(r.pages_in_use for r in teng.metrics.records)


def test_all_cond_plan_never_allocates_uncond(world):
    kw = dict(BASE, num_slots=2, pass_budget=2, max_new=4, selective_fraction=1.0)
    eng = ContinuousEngine(world.model, world.cfg, **kw)
    eng.submit(ServeRequest(uid="a", prompt="cond only", max_new_tokens=4))
    eng.tick()
    assert eng.pages.owned("a", "u") == []
    assert len(eng.pages.owned("a", "c")) == pages_for(8 + 4, 4)
    eng.drain()
    assert len(eng.results["a"]) == 4 and eng.metrics.pages_reclaimed == 0
    make = lambda R: [R(uid="a", prompt="cond only", max_new_tokens=4)]  # noqa: E731
    _check(world, *_run(world, kw, make, [0]), make(ServeRequest))


def _mixed_reqs(R):
    """``test_ragged.py``'s mixed prompt lengths and default suffix plans."""
    return [R(f"r{i}", prompt=[3 + i, 5, 7], max_new_tokens=6, guidance_scale=3.0,
              temperature=0.0, prompt_len=4 + (i % 2) * 2) for i in range(5)]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("step_mode", ["signature", "ragged"])
def test_ragged_and_signature_steps(world, kv_dtype, step_mode):
    """``test_ragged.py``'s scenario, both pool dtypes, both step modes:
    the ragged step counts one compile, the signature step one per pow2
    phase-mix bucket, exactly as the reference counts them."""
    kw = dict(num_slots=4, prompt_len=8, max_new=8, kv="paged", page_size=4,
              kv_dtype=kv_dtype, step_mode=step_mode, seed=0)
    jeng, jout, teng, tout = _run(world, kw, _mixed_reqs, [0] * 5)
    _check(world, jeng, jout, teng, tout, _mixed_reqs(ServeRequest))
    keys = sorted(k for k in teng._shapes if k[0] in ("rstep", "pstep"))
    assert keys == sorted(k for k in jeng._jit if k[0] in ("rstep", "pstep"))
    if step_mode == "ragged":
        assert keys == [("rstep", teng.ragged_rows)] and teng.metrics.step_compiles == 1
    else:
        assert teng.metrics.step_compiles == len(keys) > 1


def test_int8_eager_trace_prices_bytes(world):
    """``test_quant.py``'s int8 trace: bytes priced at the int8 page."""
    make = _trace_reqs("the quick brown fox")
    kw = dict(BASE, kv_dtype="int8")
    jeng, jout, teng, tout = _run(world, kw, make, [0, 0, 1, 3])
    _check(world, jeng, jout, teng, tout, make(ServeRequest))
    m = teng.metrics
    assert m.page_bytes == kv_page_bytes(world.cfg, 4, "int8")
    assert m.peak_bytes_in_use == m.peak_pages_in_use * m.page_bytes > 0
    assert teng.kv_hbm_bytes() == {**jeng.kv_hbm_bytes()}


def test_divergence_policy_switches_like_the_reference(world):
    """With a threshold no divergence reaches, every request switches to
    COND after its first FULL step, in both engines, event for event."""
    make = _trace_reqs("trace request")
    kw = dict(BASE, guidance_policy="divergence", divergence_threshold=1e9)
    jeng, jout, teng, tout = _run(world, kw, make, [0, 0, 1, 3])
    _check(world, jeng, jout, teng, tout, make(ServeRequest))
    assert teng.metrics.policy_switches == jeng.metrics.policy_switches > 0


@pytest.mark.parametrize("kw", [dict(kv="paged", mesh=MeshShape((2, 1), ("data", "model")))],
                         ids=["mesh"])
def test_out_of_slice_options_raise(world, kw):
    """A ``MeshShape`` (sizes without devices) holds its sizes (the page
    rounding reads them) and raises when the pools are placed; what raises
    on a ``DeviceMesh`` of several devices is held by
    ``tests/test_torch_serve_mesh.py``."""
    eng = ContinuousEngine(world.model, world.cfg, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng._init_paged_pool()


@pytest.mark.parametrize("kw", [dict(kv="paged", reservation="lazy", host_pool_bytes=1 << 20),
                                dict(kv="paged", reservation="lazy", prefix_cache="content"),
                                dict(kv="paged", tick_mode="async", stop_on_eos=False),
                                dict(kv="paged", pass_budget="auto")],
                         ids=["host_tier", "content_cache", "async", "auto_budget"])
def test_a5_options_run_one_tick(world, kw):
    """The host tier, the content cache, async ticks and the autotuned
    budget, which raised before they were ported, build and run a tick."""
    eng = ContinuousEngine(world.model, world.cfg, **dict(BASE, **kw))
    eng.submit(ServeRequest(uid="a", prompt="one tick", max_new_tokens=4))
    plan = eng.tick()
    assert eng.tick_count == 1 and plan.in_flight == 1
    assert len(eng._states["a"].generated) >= 1


def test_reference_validation_kept(world):
    for kw in (dict(kv="paged", kv_dtype="fp8"), dict(kv="slot", step_mode="ragged"),
               dict(kv="paged", combine="nope"), dict(kv="paged", interval=(0.5, 0.2)),
               dict(kv="paged", guidance_policy="divergence")):
        with pytest.raises(ValueError):
            ContinuousEngine(world.model, world.cfg, **kw)
    eng = ContinuousEngine(world.model, world.cfg, **dict(BASE, num_slots=2, max_new=4))
    assert not eng.submit(ServeRequest(uid="big", prompt="x", max_new_tokens=4,
                                       prompt_len=9))
    assert eng.metrics.rejected == 1


def test_sampling_is_seeded_per_request(world):
    """Temperature > 0 draws from the request's own seeded generator: two
    engines with one seed give the same tokens."""
    make = lambda: [ServeRequest(uid=f"t{i}", prompt=f"warm {i}", max_new_tokens=5,  # noqa: E731
                                 temperature=1.0) for i in range(3)]
    runs = [ContinuousEngine(world.model, world.cfg, **dict(BASE, seed=3)).serve(make())
            for _ in range(2)]
    assert runs[0] == runs[1] and all(len(v) == 5 for v in runs[0].values())
    assert all(0 <= t < world.cfg.vocab_size for v in runs[0].values() for t in v)
