"""The port's dense decoder and guided AR decode against the reference's, on
the same weights (converted from ``init_model``) and the same numpy prompts,
at the reduced configs (2 layers, d_model 256, vocab 512).

Tolerances. The stacks run in bf16. One eager decoder layer agrees to one
bf16 step (2^-8) of its largest value. The reference scans its layers and
XLA keeps some of the fused body's bf16 intermediates in float32; the
logits come out of the unembedding in bf16 (2^-8 relative steps), and the
combine multiplies their differences by 2s - 1 = 5. So the teacher-forced
logits of whole stacks are held to LOGIT_TOL of the largest logit.

Greedy tokens are held equal up to the first step that the logits do not
decide: where, for some token j, the reference's teacher-forced margin of
its top token over j is no larger than the two logits' measured
differences between port and reference (only there can the argmax swap).
At least 75% of the tokens must be compared; the prompt seeds (SEEDS) are
ones whose decodes have few such near-ties at this vocabulary of 512.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import ar_decode as JAR
from repro.core.guidance import apg_combine as japg
from repro.core.guidance import cfg_combine as jcfg_combine
from repro.core.selective import GuidancePlan as JPlan
from repro.core.selective import Mode as JMode
from repro.core.selective import round_half_up
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import ar_decode as AR
from repro_torch.core.selective import GuidancePlan
from repro_torch.kernels import cfg_combine as KC
from repro_torch.kernels import decode_attention as KD
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import rmsnorm as KR
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

LOGIT_TOL = 1.5e-2
BF16 = 2.0 ** -8
ARCHS = ["llama3.2-1b", "qwen3-14b", "yi-9b", "h2o-danube-3-4b"]
SEEDS = {"llama3.2-1b": 5, "qwen3-14b": 5, "yi-9b": 6, "h2o-danube-3-4b": 8, "apg": 7,
         "interval": 6}


class Pair:
    """The reference's params and the port's model on the same weights, and
    the reference's jitted prefill and one-stream decode step."""

    def __init__(self, arch):
        self.jcfg, self.cfg = jget_smoke(arch), get_smoke_config(arch)
        self.params = JT.init_model(self.jcfg, JL.ArrayMaker(jax.random.PRNGKey(0)))
        tree = jax.tree.map(np.asarray, self.params)
        self.model = TT.Transformer.from_state_dict(self.cfg, convert.from_jax_model_params(tree))
        jcfg = self.jcfg
        self.prefill = jax.jit(lambda p, t: JAR.prefill(p, jcfg, t))
        self.step = jax.jit(lambda p, t, c, pos: JAR.decode_step_cond(p, jcfg, t, c, pos))

    def prompt(self, B, S, seed=1):
        return np.random.default_rng(seed).integers(0, self.cfg.vocab_size, (B, S)).astype(
            np.int32)

    def ref_teacher_forced(self, toks, plan, tokens, combine="cfg", apg_eta=0.0,
                           interval=None):
        """The reference's logits (B, n, V) that choose each of ``tokens``,
        fed ``tokens``: its own step functions in an eager loop."""
        S, n, s = toks.shape[1], plan.total_steps, plan.guidance_scale
        lc, cc = self.prefill(self.params, jnp.asarray(toks))
        lu, cu = self.prefill(self.params, JAR.null_prompt(jnp.asarray(toks)))
        cc = JT.prepare_decode_caches(self.jcfg, cc, seq_len=S, capacity=S + n)
        cu = JT.prepare_decode_caches(self.jcfg, cu, seq_len=S, capacity=S + n)
        if combine == "interval":
            iv = (0.0, 1.0) if interval is None else interval
            a, b = round_half_up(n * iv[0]), round_half_up(n * iv[1])

        def comb(l_u, l_c, i):
            if combine == "apg":
                return japg(l_u, l_c, s, eta=apg_eta)
            if combine == "interval":
                return jcfg_combine(l_u, l_c, jnp.float32(s if a <= i < b else 1.0))
            return jcfg_combine(l_u, l_c, s)

        out = [comb(lu, lc, 0)]
        for i, mode in enumerate(plan.modes()[:-1]):
            tok = jnp.asarray(tokens[:, i])
            lc, cc = self.step(self.params, tok, cc, S + i)
            if mode is JMode.FULL:
                lu, cu = self.step(self.params, tok, cu, S + i)
                out.append(comb(lu, lc, i))
            else:
                out.append(lc)
        return np.stack([np.asarray(x) for x in out], axis=1)


@pytest.fixture(scope="module")
def zoo():
    pairs = {}

    def get(arch):
        if arch not in pairs:
            pairs[arch] = Pair(arch)
        return pairs[arch]

    return get


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_decode_matches(pair, toks, n, frac, *, tol=LOGIT_TOL, **kw):
    jplan, plan = JPlan.suffix(n, frac, 3.0), GuidancePlan.suffix(n, frac, 3.0)
    ref, ref_end = JAR.guided_decode(pair.params, pair.jcfg, jnp.asarray(toks), jplan, **kw)
    ref = np.array(ref)
    out, end = AR.guided_decode(pair.model, torch.from_numpy(toks).long(), plan, **kw)
    assert end == ref_end == toks.shape[1] + n and tuple(out.shape) == ref.shape
    ref_logits = pair.ref_teacher_forced(toks, jplan, ref, **kw)
    logits = AR.teacher_forced_logits(pair.model, torch.from_numpy(toks).long(), plan,
                                      torch.from_numpy(ref).long(), **kw).numpy()
    np.testing.assert_allclose(logits, ref_logits, rtol=0,
                               atol=tol * np.abs(ref_logits).max())
    err = np.abs(logits - ref_logits)
    top = ref_logits.argmax(-1)[..., None]
    gap = np.take_along_axis(ref_logits, top, -1) - ref_logits
    slack = np.take_along_axis(err, top, -1) + err
    undecided = ((gap <= slack) & (np.arange(ref_logits.shape[-1]) != top)).any(-1)
    compared = 0
    for r in range(ref.shape[0]):
        low = np.nonzero(undecided[r])[0]
        upto = int(low[0]) if len(low) else n
        np.testing.assert_array_equal(out[r, :upto].numpy(), ref[r, :upto])
        compared += upto
    assert compared >= 0.75 * ref.size, (compared, ref.size)


# -- conversion and one layer ---------------------------------------------------------


def test_convert_unstacks_layers_and_keeps_bf16():
    jcfg, cfg = jget_smoke("qwen3-14b"), get_smoke_config("qwen3-14b")
    params = JT.init_model(jcfg, JL.ArrayMaker(jax.random.PRNGKey(2), jnp.bfloat16))
    tree = jax.tree.map(np.asarray, params)
    model = TT.Transformer.from_state_dict(cfg, convert.from_jax_model_params(tree))
    state = model.state_dict()
    assert len(model.layers) == cfg.num_layers
    assert all(t.dtype == torch.bfloat16 for t in state.values())
    seg = tree["segments"][0][0]
    for i in range(cfg.num_layers):
        for key, leaf in (("attn.wq", seg["attn"]["wq"]), ("attn.q_norm", seg["attn"]["q_norm"]),
                          ("mlp.w_down", seg["mlp"]["w_down"])):
            got = state[f"layers.{i}.{key}"].view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(got, leaf[i].view(np.uint16))
    assert set(state) == {k for k, _ in convert.model_items(tree)}
    assert "lm_head" in state and "embed.table" in state


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-14b"])
def test_decoder_layer_matches_reference(zoo, arch):
    """One eager block, prefill then one decode token, within one bf16 step
    of the largest value."""
    pair = zoo(arch)
    jcfg, cfg = pair.jcfg, pair.cfg
    toks = pair.prompt(2, 12)
    xj = JL.embed(pair.params["embed"], jnp.asarray(toks), dtype=jnp.bfloat16)
    xt = TL.embed(pair.model.embed.table, torch.from_numpy(toks).long(), dtype=torch.bfloat16)
    np.testing.assert_array_equal(_f32(xt), _f32(xj))
    bp = jax.tree.map(lambda a: a[0], pair.params["segments"][0][0])
    pos = jnp.arange(12)[None]
    yj, kv, _ = JT.block_forward(bp, jcfg, "attn", xj, pos, moe_layer=False, want_cache=True)
    rope = TL.rope_tables(torch.arange(12)[None], cfg.resolved_head_dim, cfg.rope_theta)
    yt, tkv, _ = TT.block_forward(pair.model.layers[0], cfg, "attn", xt, rope, window=None)
    np.testing.assert_allclose(_f32(yt), _f32(yj), rtol=0, atol=BF16 * np.abs(_f32(yj)).max())
    cache = JT.prepare_decode_caches(jcfg, [[jax.tree.map(lambda a: a[None], kv)]],
                                     seq_len=12, capacity=16)[0][0]
    cache = jax.tree.map(lambda a: a[0], cache)
    tcache = pair.model.prepare_decode_caches([tkv], seq_len=12, capacity=16)[0]
    dj, _ = JT.block_decode(bp, jcfg, "attn", yj[:, -1:], cache, 12, moe_layer=False)
    rope = TL.rope_tables(torch.full((1, 1), 12), cfg.resolved_head_dim, cfg.rope_theta)
    dt, _ = TT.block_decode(pair.model.layers[0], cfg, "attn", yt[:, -1:].contiguous(), tcache,
                            12, rope, window=None)
    np.testing.assert_allclose(_f32(dt), _f32(dj), rtol=0, atol=BF16 * np.abs(_f32(dj)).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_step_logits(zoo, arch):
    """Prefill logits, then three decode steps fed the same tokens."""
    pair = zoo(arch)
    S = 80 if arch == "h2o-danube-3-4b" else 16     # danube: past its window of 64
    toks = pair.prompt(2, S, seed=3)
    lj, cj = pair.prefill(pair.params, jnp.asarray(toks))
    lt, ct = AR.prefill(pair.model, torch.from_numpy(toks).long())
    ref, out = [np.asarray(lj)], [lt.numpy()]
    cj = JT.prepare_decode_caches(pair.jcfg, cj, seq_len=S, capacity=S + 3)
    ct = pair.model.prepare_decode_caches(ct, seq_len=S, capacity=S + 3)
    for i in range(3):
        tok = np.argmax(ref[-1], axis=-1)
        lj, cj = pair.step(pair.params, jnp.asarray(tok), cj, S + i)
        lt, ct = AR.decode_step_cond(pair.model, torch.from_numpy(tok).long(), ct, S + i)
        ref.append(np.asarray(lj))
        out.append(lt.numpy())
    ref, out = np.stack(ref), np.stack(out)
    np.testing.assert_allclose(out, ref, rtol=0, atol=LOGIT_TOL * np.abs(ref).max())


# -- guided decode -------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_guided_decode_matches_reference(zoo, arch):
    """``combine="cfg"``. The danube prompt (80 tokens) is longer than its
    reduced window (64), so both sides decode through ring caches."""
    pair = zoo(arch)
    S = 80 if arch == "h2o-danube-3-4b" else 16
    _assert_decode_matches(pair, pair.prompt(2, S, seed=SEEDS[arch]), 8, 0.5)


@pytest.mark.parametrize("combine,kw", [("apg", dict(apg_eta=0.3)),
                                        ("interval", dict(interval=(0.25, 0.75)))])
def test_guided_decode_combines_match_reference(zoo, combine, kw):
    pair = zoo("llama3.2-1b")
    _assert_decode_matches(pair, pair.prompt(2, 16, seed=SEEDS[combine]), 8, 0.25,
                           combine=combine, **kw)


@pytest.mark.parametrize("S", [40, 64, 80])
def test_ring_cache_equals_windowed_linear_cache(S):
    """A ring of W = 64 slots from a prefill of S tokens decodes as a linear
    cache with the window mask does, for S < W, S == W and S > W. (The
    reference returns the unpadded prefill cache for S <= W; ROADMAP C.)"""
    cfg = get_smoke_config("h2o-danube-3-4b")
    W, n = cfg.sliding_window, 12
    model = TT.Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    p = model.layers[0].attn
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.standard_normal((2, S + n, cfg.d_model), dtype=np.float32))
    rope = TL.rope_tables(torch.arange(S)[None], cfg.resolved_head_dim, cfg.rope_theta)
    _, kv = TA.attn_forward_auto(p, cfg, x[:, :S], rope, window=W)
    ring = TA.cache_from_prefill(kv, window=W, seq_len=S)
    assert tuple(ring["k"].shape[:2]) == (2, W) and tuple(ring["slot_pos"].shape) == (W,)
    lin = TA.cache_spec(cfg, 2, S + n, dtype=torch.float32, device="cpu")
    lin["k"][:, :S], lin["v"][:, :S] = kv["k"], kv["v"]
    for pos in range(S, S + n):
        rope = TL.rope_tables(torch.full((1, 1), pos), cfg.resolved_head_dim, cfg.rope_theta)
        a, ring = TA.attn_decode_ring(p, cfg, x[:, pos:pos + 1], ring, pos, rope, window=W)
        b, lin = TA.attn_decode(p, cfg, x[:, pos:pos + 1], lin, pos, rope, window=W)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


# -- the reference's invariants (tests/test_ar_decode.py), on the port -----------------


@pytest.fixture(scope="module")
def llama(zoo):
    pair = zoo("llama3.2-1b")
    return pair.model, torch.from_numpy(pair.prompt(2, 10, seed=1)).long()


def test_scale1_selective_identical(llama):
    model, toks = llama
    g_full, _ = AR.guided_decode(model, toks, GuidancePlan.full(8, 1.0))
    g_sel, _ = AR.guided_decode(model, toks, GuidancePlan.suffix(8, 0.75, 1.0))
    assert torch.equal(g_full, g_sel)


def test_f0_identity(llama):
    model, toks = llama
    g0, _ = AR.guided_decode(model, toks, GuidancePlan.suffix(8, 0.0, 4.0))
    gb, _ = AR.guided_decode(model, toks, GuidancePlan.full(8, 4.0))
    assert torch.equal(g0, gb)


def test_prefix_preserved(llama):
    model, toks = llama
    n, frac = 12, 0.5
    g_base, _ = AR.guided_decode(model, toks, GuidancePlan.full(n, 5.0))
    g_sel, _ = AR.guided_decode(model, toks, GuidancePlan.suffix(n, frac, 5.0))
    n_full = n - round_half_up(n * frac)
    assert torch.equal(g_base[:, :n_full], g_sel[:, :n_full])


def test_greedy_teacher_forced_logits_are_the_decodes(llama):
    """``tokens=None`` gives the greedy decode's own logits: their argmax is
    ``guided_decode``'s tokens, and they equal the logits teacher-forced on
    those tokens bit for bit."""
    model, toks = llama
    plan = GuidancePlan.suffix(8, 0.25, 3.0)
    tokens, _ = AR.guided_decode(model, toks, plan)
    logits = AR.teacher_forced_logits(model, toks, plan, None)
    assert torch.equal(logits.argmax(-1), tokens)
    assert torch.equal(logits, AR.teacher_forced_logits(model, toks, plan, tokens))


def test_window_plan_rejected(llama):
    model, toks = llama
    with pytest.raises(ValueError, match="suffix"):
        AR.guided_decode(model, toks, GuidancePlan.window(8, 0.25, 0.5))
    with pytest.raises(ValueError, match="combine"):
        AR.guided_decode(model, toks, GuidancePlan.full(4), combine="nope")


def test_guidance_scale_changes_output(llama):
    model, toks = llama
    g1, _ = AR.guided_decode(model, toks, GuidancePlan.full(10, 1.5))
    g2, _ = AR.guided_decode(model, toks, GuidancePlan.full(10, 9.0))
    assert not torch.equal(g1, g2)


def test_temperature_sampling_deterministic_with_generator(llama):
    model, toks = llama
    plan = GuidancePlan.suffix(6, 0.5, 3.0)
    a, _ = AR.guided_decode(model, toks, plan, temperature=1.0,
                            generator=torch.Generator().manual_seed(42))
    b, _ = AR.guided_decode(model, toks, plan, temperature=1.0,
                            generator=torch.Generator().manual_seed(42))
    assert torch.equal(a, b)
    assert bool(((a >= 0) & (a < model.cfg.vocab_size)).all())


def test_no_kernel_launches_on_the_cpu(llama):
    model, toks = llama
    for m in (KC, KF, KD, KR):
        m.reset_launches()
    for combine in ("cfg", "apg", "interval"):
        AR.guided_decode(model, toks, GuidancePlan.suffix(4, 0.5, 3.0), combine=combine)
    assert sum(v for m in (KC, KF, KD, KR) for v in m.LAUNCHES.values()) == 0


def test_unported_families_raise():
    """The serve engine takes every decoder stack the decoder takes: a MoE
    and an RG-LRU variant of the reduced llama3.2-1b construct and serve a
    request in the slot arena; an encoder, which has no decode step,
    raises ``ValueError`` at construction."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.serve import ContinuousEngine, ServeRequest
    cfg = get_smoke_config("llama3.2-1b")
    for variant in (dict(moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=64)),
                    dict(block_pattern=("rglru",))):
        vcfg = dataclasses.replace(cfg, **variant)
        model = TT.Transformer.init(vcfg, torch.Generator().manual_seed(0), device="cpu")
        eng = ContinuousEngine(model, vcfg, num_slots=2, prompt_len=8, max_new=4)
        out = eng.serve([ServeRequest(uid="a", prompt="one request", max_new_tokens=4)])
        assert len(out["a"]) >= 1 and eng.metrics.completed == 1
    ecfg = dataclasses.replace(cfg, is_encoder=True)
    model = TT.Transformer.init(ecfg, device="cpu")
    with pytest.raises(ValueError, match="encoder has no decode step"):
        ContinuousEngine(model, ecfg)
