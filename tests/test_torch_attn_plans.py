"""The launch plans of the flash-prefill (B4) and flash-decode (B5) kernels,
as the pure functions the wrappers call, and the flash-decode ring form
(the sliding-window decode cache) on the CPU: its plain version against the
reference's oracle and its routing from ``attn_decode_ring``. No kernel
launches: CPU tensors take the plain versions.

Tolerances. The ring form on CPU tensors is the plain version with the ring
mask, so it is held bit for bit; against the reference's linear-cache
oracle, float32 2e-5 of max|out| (the same math over the keys in another
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref
from repro_torch import convert
from repro_torch.configs.registry import ARCHS, get_smoke_config
from repro_torch.kernels import decode_attention as KD
from repro_torch.kernels import flash_attention as KF
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.transformer import Transformer


def _tiles(plan, tile):
    """Each block's key range [first, end) of the plan, in block order."""
    out = []
    for r in range(plan.cluster):
        t0 = r * plan.per_block
        t1 = min(plan.tiles, t0 + plan.per_block)
        out.append((plan.first_key + t0 * tile, plan.first_key + t1 * tile))
    return out


@settings(max_examples=300, deadline=None)
@given(S=st.integers(1, 8192), data=st.data(), window=st.one_of(st.none(), st.integers(1, 5000)),
       tile=st.sampled_from([32, 64]))
def test_decode_split_partitions_the_valid_keys(S, data, window, tile):
    """A linear cache's blocks cover [lo, pos] exactly once, each block at
    least one valid key; 1 to ``MAX_CLUSTER`` (8) blocks a cluster."""
    pos = data.draw(st.integers(0, S - 1))
    plan = KD.decode_split_plan(S, pos, window, tile=tile)
    lo = max(0, pos - window + 1) if window else 0
    assert plan.lo == lo
    assert 1 <= plan.cluster <= KD.MAX_CLUSTER and plan.per_block >= 1
    ranges = _tiles(plan, tile)
    covered = [k for a, b in ranges for k in range(max(a, lo), min(b, pos + 1))]
    assert covered == list(range(lo, pos + 1))
    assert all(min(b, pos + 1) > max(a, lo) for a, b in ranges)
    assert plan.first_key % tile == 0 and plan.first_key <= lo


@settings(max_examples=200, deadline=None)
@given(S=st.integers(1, 8192), pos=st.integers(0, 100_000),
       window=st.one_of(st.none(), st.integers(1, 5000)), tile=st.sampled_from([32, 64]))
def test_decode_split_of_a_ring_visits_every_slot(S, pos, window, tile):
    plan = KD.decode_split_plan(S, pos, window, ring=True, tile=tile)
    assert 1 <= plan.cluster <= KD.MAX_CLUSTER and plan.first_key == 0
    slots = [s for a, b in _tiles(plan, tile) for s in range(a, min(b, S))]
    assert slots == list(range(S))


@pytest.mark.parametrize("pos,tiles,per_block,cluster", [
    (0, 1, 1, 1), (63, 1, 1, 1), (64, 2, 1, 2), (511, 8, 1, 8), (767, 12, 2, 6), (4095, 64, 8, 8)])
def test_decode_split_sizes_the_cluster_from_the_keys(pos, tiles, per_block, cluster):
    """pos 0 runs one block; up to 8 tiles, one tile a block; past that the
    fewest tiles a block that keep the cluster at 8, spread evenly."""
    plan = KD.decode_split_plan(4096, pos)
    assert (plan.tiles, plan.per_block, plan.cluster) == (tiles, per_block, cluster)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_flash_tile_plan_fits_every_dense_config(arch):
    cfg = ARCHS[arch]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    plan = KF.flash_tile_plan(512, H, K, hd)
    assert plan.rows == plan.positions * (H // K) <= KF.ROWS
    assert plan.hd_pad % 16 == 0 and hd <= plan.hd_pad < hd + KF.PAD
    assert plan.q_tiles * plan.positions >= 512 > (plan.q_tiles - 1) * plan.positions


@settings(max_examples=200, deadline=None)
@given(K=st.integers(1, 16), rep=st.integers(1, 32), hd=st.integers(1, 32).map(lambda n: 8 * n),
       S=st.integers(1, 5000))
def test_flash_tile_plan_properties(K, rep, hd, S):
    plan = KF.flash_tile_plan(S, K * rep, K, hd)
    assert 1 <= plan.positions and plan.rows == plan.positions * rep <= KF.ROWS
    assert plan.rows > KF.ROWS - rep                  # no whole position left out
    assert plan.hd_pad % 16 == 0 and hd <= plan.hd_pad < hd + KF.PAD
    assert (plan.q_tiles - 1) * plan.positions < S <= plan.q_tiles * plan.positions


def test_flash_tile_plan_refuses_groups_past_the_tile():
    with pytest.raises(ValueError):
        KF.flash_tile_plan(128, 66, 1, 64)
    with pytest.raises(ValueError):
        KF.flash_tile_plan(128, 9, 2, 64)


# -- the ring form --------------------------------------------------------------------


def _ring(W, pos, holes, seed):
    """A ring's slot positions: position p at slot p % W for the last W
    positions up to ``pos``, -1 before position 0 and at ``holes`` random
    slots (never the current position's)."""
    slots = np.arange(W)
    sp = pos - (pos - slots) % W
    sp[sp < 0] = -1
    rng = np.random.default_rng(seed)
    for s in rng.choice(W, holes, replace=False):
        if s != pos % W:
            sp[s] = -1
    return torch.from_numpy(sp.astype(np.int32))


@pytest.mark.parametrize("W,pos,window,holes", [(64, 20, 64, 0), (64, 200, 64, 5),
                                                (64, 200, 16, 3), (48, 47, None, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_form_on_cpu_is_the_plain_version_with_the_ring_mask(W, pos, window, holes, dtype):
    rng = np.random.default_rng(pos + W)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype)
               for s in ((2, 8, 16), (2, W, 2, 16), (2, W, 2, 16)))
    sp = _ring(W, pos, holes, pos)
    out = KD.decode_attention(q, k, v, pos, window=window, slot_pos=sp)
    valid = (sp >= 0) & (sp <= pos)
    if window is not None:
        valid = valid & (sp > pos - window)
    assert torch.equal(out, KD.decode_attention_plain(q, k, v, pos, valid=valid))
    assert KD.LAUNCHES == {"decode_attention": 0}


@pytest.mark.parametrize("W,pos", [(32, 31), (32, 100), (40, 77)])
def test_full_ring_matches_the_oracle_on_a_linear_cache(W, pos):
    """A full ring of the last W positions equals the reference's oracle on
    the linear cache of those positions with window W, float32."""
    rng = np.random.default_rng(W + pos)
    q = rng.standard_normal((2, 6, 16), dtype=np.float32)
    k = rng.standard_normal((2, pos + 1, 3, 16), dtype=np.float32)
    v = rng.standard_normal((2, pos + 1, 3, 16), dtype=np.float32)
    sp = _ring(W, pos, 0, 0)
    idx = sp.clamp(min=0).long().numpy()
    out = KD.decode_attention(convert.to_tensor(q), convert.to_tensor(k[:, idx]),
                              convert.to_tensor(v[:, idx]), pos, window=W, slot_pos=sp)
    expect = np.asarray(ref.ref_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v), pos, window=W))
    np.testing.assert_allclose(out.numpy(), expect, rtol=0, atol=2e-5 * np.abs(expect).max())


def test_slot_pos_is_checked():
    q, k = torch.zeros(1, 2, 8), torch.zeros(1, 16, 1, 8)
    with pytest.raises(ValueError):
        KD.decode_attention(q, k, k, 3, slot_pos=torch.zeros(15, dtype=torch.int32))
    with pytest.raises(ValueError):
        KD.decode_attention(q, k, k, 3, slot_pos=torch.zeros(16, dtype=torch.int64))


def test_attn_decode_ring_goes_through_the_decode_kernel_wrapper(monkeypatch):
    """The ring decode calls ``decode_attention`` with the ring's
    ``slot_pos`` (on the card that is the kernel), never the plain version
    directly."""
    cfg = get_smoke_config("h2o-danube-3-4b")
    W = cfg.sliding_window
    model = Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    p = model.layers[0].attn
    S = W + 8
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, S + 1, cfg.d_model),
                                                                  dtype=np.float32))
    rope = TL.rope_tables(torch.arange(S)[None], cfg.resolved_head_dim, cfg.rope_theta)
    _, kv = TA.attn_forward_auto(p, cfg, x[:, :S], rope, window=W)
    ring = TA.cache_from_prefill(kv, window=W, seq_len=S)
    seen = []
    wrapper = KD.decode_attention

    def spy(q, k, v, pos, **kw):
        seen.append(kw)
        return wrapper(q, k, v, pos, **kw)

    monkeypatch.setattr(KD, "decode_attention", spy)
    rope = TL.rope_tables(torch.full((1, 1), S), cfg.resolved_head_dim, cfg.rope_theta)
    out, _ = TA.attn_decode_ring(p, cfg, x[:, S:S + 1], ring, S, rope, window=W)
    assert len(seen) == 1 and seen[0]["window"] == W
    assert seen[0]["slot_pos"] is ring["slot_pos"]
    assert out.shape == (2, 1, cfg.d_model) and bool(torch.isfinite(out).all())
