"""The port's MoE dispatch and MLA against the reference's, beyond the
stacks (the analogue of ``test_moe_mla.py``): the MoE layer against a dense
oracle and the reference's, the dropped (token, expert) pairs equal to the
reference's, the capacity invariant under hypothesis, the compressed MLA
cache, and the absorbed decode against the naive prefill.

Tolerances. Everything runs in float32 on equal inputs and weights:
* the MoE layer against the reference's: 1e-5 of the largest output, the
  aux loss 1e-5 relative (the same sums in another order);
* against the dense oracle (every expert on every token): 2e-4, the
  reference test's bound;
* MLA prefill, blocked prefill and absorbed decode against the reference's
  functions: 1e-5 of the largest output; the absorbed decode against the
  naive prefill: 1e-4 of the largest (the products reassociated through
  the latent).
Routing is compared exactly where the top-k margin (the k-th minus the
(k+1)-th router probability) exceeds 1e-3: the tests assert that every
token's margin does, so that float32 rounding cannot decide a choice.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_smoke_config as jget_smoke
from repro.models import layers as JL
from repro.models import mla as JMLA
from repro.models import moe as JMOE
from repro_torch import convert
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models import layers as TL
from repro_torch.models import mla as TMLA
from repro_torch.models import moe as TMOE
from repro_torch.models.transformer import Transformer, cache_specs

MARGIN = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module(tree):
    return TL.tree_module(jax.tree.map(lambda a: convert.to_tensor(np.asarray(a)), tree))


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _moe(arch, **moe_kw):
    """-> (reference config, port config, reference params, port module)."""
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    params = JMOE.init_moe(jcfg, JL.ArrayMaker(jax.random.PRNGKey(0)))
    return jcfg, cfg, params, _module(params)


def _assert_margins(r, k):
    top = r.probs.sort(dim=-1, descending=True).values
    assert float((top[..., k - 1] - top[..., k]).min()) > MARGIN


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_moe_matches_dense_oracle_and_reference(arch):
    """Ample capacity: the sort-based dispatch equals every expert run on
    every token and weighted by its renormalised top-k gates (plus the
    shared experts), and the reference's layer, output and aux loss."""
    jcfg, cfg, params, p = _moe(arch)
    m = cfg.moe
    x = _x((2, 8, cfg.d_model), 1, 0.5)
    out, aux = TMOE.moe_forward(p, cfg, torch.from_numpy(x))
    ref, ref_aux = JMOE.moe_forward(params, jcfg, jnp.asarray(x))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    assert float(aux) > 0

    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ p.router, -1)
    gates, ids = torch.topk(probs, m.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    y_all = torch.stack([(torch.nn.functional.silu(xf @ p.w_gate[e]) * (xf @ p.w_up[e]))
                         @ p.w_down[e] for e in range(m.num_experts)], dim=1)
    expect = (gates[..., None] * y_all.gather(1, ids[..., None].expand(-1, -1, cfg.d_model))
              ).sum(1)
    if m.num_shared_experts:
        expect = expect + TL.swiglu(p.shared, xf)
    np.testing.assert_allclose(out.reshape(-1, cfg.d_model).numpy(), expect.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch,factor", [("mixtral-8x7b", 0.5), ("deepseek-v2-lite-16b", 0.3)])
def test_dropped_pairs_equal_the_reference(arch, factor):
    """Under a tight capacity the (token, expert) pairs over an expert's C
    slots are dropped in token order: the port drops exactly the
    reference's pairs, and its outputs agree."""
    jcfg, cfg, params, p = _moe(arch, capacity_factor=factor)
    B, S = 2, 48
    x = _x((B, S, cfg.d_model), 1)     # a seed whose top-k margins all exceed MARGIN
    C = TMOE._capacity(S, cfg)
    r = TMOE.route(p, cfg, torch.from_numpy(x), C)
    _assert_margins(r, cfg.moe.top_k)
    for b in range(B):
        xf = jnp.asarray(x[b])
        _, (dest, keep, s_tok, _), _ = JMOE._dispatch_group(params, jcfg, xf, C)
        probs = jax.nn.softmax((xf @ params["router"]).astype(jnp.float32), -1)
        _, ids = jax.lax.top_k(probs, cfg.moe.top_k)
        ids, dest, keep, s_tok = (np.asarray(a) for a in (ids, dest, keep, s_tok))
        kept = {(int(t), int(d) // C) for t, d, k in zip(s_tok, dest, keep) if k}
        every = {(t, int(e)) for t in range(S) for e in ids[t]}
        ref_dropped = every - kept
        got = {(t, int(r.ids[b, t, j])) for t in range(S) for j in range(cfg.moe.top_k)
               if not bool(r.keep[b, t, j])}
        assert got == ref_dropped and got, (b, sorted(got), sorted(ref_dropped))
        np.testing.assert_array_equal(r.ids[b].numpy(), ids)
    out, _ = TMOE.moe_forward(p, cfg, torch.from_numpy(x))
    ref, _ = JMOE.moe_forward(params, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())


def test_capacity_drops_shrink_the_output():
    """``test_moe_capacity_drops_tokens``: with capacity_factor near 0 most
    pairs drop, and the output's norm falls below the ample capacity's."""
    _, cfg, _, p = _moe("mixtral-8x7b", capacity_factor=0.01)
    _, cfg2, _, p2 = _moe("mixtral-8x7b")
    x = torch.from_numpy(_x((1, 64, cfg.d_model), 1))
    out, _ = TMOE.moe_forward(p, cfg, x)
    out2, _ = TMOE.moe_forward(p2, cfg2, x)
    assert float(out.norm()) < float(out2.norm())


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 3), st.integers(4, 32), st.sampled_from([0.3, 1.25, 8.0]))
def test_capacity_invariant(b, s, factor):
    """Every buffer slot holds at most one pair, an expert keeps
    min(count, C) pairs, each kept pair's slot holds its own token, and the
    output and aux are finite, for any (B, S, capacity)."""
    _, cfg, _, p = _moe("deepseek-v2-lite-16b", capacity_factor=factor)
    x = _x((b, s, cfg.d_model), b * 100 + s)
    C = TMOE._capacity(s, cfg)
    r = TMOE.route(p, cfg, torch.from_numpy(x), C)
    k, E = cfg.moe.top_k, cfg.moe.num_experts
    for g in range(b):
        slots = r.slot[g][r.keep[g]]
        assert len(set(slots.tolist())) == len(slots)
        counts = torch.bincount(r.ids[g].reshape(-1), minlength=E)
        kept = torch.bincount(r.ids[g][r.keep[g]], minlength=E)
        assert torch.equal(kept, torch.clamp(counts, max=C))
        tok = torch.arange(s)[:, None].expand(s, k)[r.keep[g]]
        assert torch.equal(r.token[g][slots], tok) and bool(r.filled[g][slots].all())
        assert int(r.filled[g].sum()) == len(slots)
    out, aux = TMOE.moe_forward(p, cfg, torch.from_numpy(x))
    assert out.shape == x.shape and bool(torch.isfinite(out).all()) and np.isfinite(float(aux))


# -- MLA -----------------------------------------------------------------------------


def test_mla_cache_is_compressed():
    """The decode cache holds r + dr numbers a position, for all heads, not
    H x hd, at deepseek-v2-lite-16b's full config (on the meta device):
    every layer's, through the stack's ``cache_specs``."""
    cfg = get_config("deepseek-v2-lite-16b")
    a = cfg.mla
    specs = cache_specs(cfg, 2, 16, device="meta")
    assert len(specs) == cfg.num_layers
    for c in specs:
        assert set(c) == {"c", "k_rope"}
        assert tuple(c["c"].shape) == (2, 16, a.kv_lora_rank)
        assert tuple(c["k_rope"].shape) == (2, 16, a.qk_rope_head_dim)
    full_kv = cfg.num_heads * (a.qk_nope_head_dim + a.v_head_dim)
    assert (a.kv_lora_rank + a.qk_rope_head_dim) * 7 < full_kv      # 576 against 4096


@pytest.fixture(scope="module")
def mla():
    jcfg, cfg = jget_smoke("deepseek-v2-lite-16b"), get_smoke_config("deepseek-v2-lite-16b")
    params = JMLA.init_mla(jcfg, JL.ArrayMaker(jax.random.PRNGKey(0)))
    return jcfg, cfg, params, _module(params)


def _rope(cfg, positions):
    return TL.rope_tables(positions, cfg.mla.qk_rope_head_dim, cfg.rope_theta)


def test_mla_prefill_and_blocked_prefill_match_reference(mla):
    jcfg, cfg, params, p = mla
    B, S = 2, 16
    x = _x((B, S, cfg.d_model), 1, 0.3)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    ref, ref_cache = JMLA.mla_forward(params, jcfg, jnp.asarray(x), pos)
    ref_b, _ = JMLA.mla_forward_blocked(params, jcfg, jnp.asarray(x), pos, q_chunk=8)
    rope = _rope(cfg, torch.arange(S)[None])
    out, cache = TMLA.mla_forward(p, cfg, torch.from_numpy(x), rope)
    out_b, _ = TMLA.mla_forward_blocked(p, cfg, torch.from_numpy(x), rope, q_chunk=8)
    tol = 1e-5 * np.abs(np.asarray(ref)).max()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=tol)
    np.testing.assert_allclose(out_b.numpy(), np.asarray(ref_b), rtol=0, atol=tol)
    for name in ("c", "k_rope"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(ref_cache[name]), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(ref_cache[name])).max())


def test_mla_absorbed_decode_equals_naive_and_reference(mla):
    """Prefill S, then one absorbed step at position S written in place:
    equal to the naive prefill's row S, and to the reference's decode."""
    jcfg, cfg, params, p = mla
    B, S = 2, 9
    x = _x((B, S + 1, cfg.d_model), 1, 0.3)
    out_full, _ = TMLA.mla_forward(p, cfg, torch.from_numpy(x), _rope(cfg, torch.arange(S + 1)[None]))
    _, cache = TMLA.mla_forward(p, cfg, torch.from_numpy(x[:, :S]), _rope(cfg, torch.arange(S)[None]))
    model = Transformer.init(cfg, device="cpu")
    cache = model.prepare_decode_caches([cache] * cfg.num_layers, seq_len=S, capacity=S + 1)[0]
    assert tuple(cache["c"].shape) == (B, S + 1, cfg.mla.kv_lora_rank)
    pos = torch.tensor([S], dtype=torch.int32)
    out_dec, cache = TMLA.mla_decode(p, cfg, torch.from_numpy(x[:, S:S + 1]), cache, pos,
                                     _rope(cfg, pos.view(1, 1)))
    full = out_full[:, S].numpy()
    np.testing.assert_allclose(out_dec[:, 0].numpy(), full, rtol=0,
                               atol=1e-4 * np.abs(full).max())
    pj = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    _, jcache = JMLA.mla_forward(params, jcfg, jnp.asarray(x[:, :S]), pj)
    jcache = {k: jnp.pad(v, ((0, 0), (0, 1), (0, 0))) for k, v in jcache.items()}
    ref, ref_cache = JMLA.mla_decode(params, jcfg, jnp.asarray(x[:, S:S + 1]), jcache, S)
    np.testing.assert_allclose(out_dec.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(cache["c"].numpy(), np.asarray(ref_cache["c"]), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref_cache["c"])).max())
