"""The launch plan of the split-K paged decode kernel (B7-B10, with a bf16
q in 64-key tiles and a float32 q in 32-key tiles) and the numeric rules it
rests on, on the CPU: the blocks' key ranges as the kernel computes them on
the device (mirrored here from ``csrc/paged_decode_attention.cu``), its
shared memory, a float32 emulation of its split-then-merge at either tile
against the plain version and the reference's oracles, and the exact int8
-> bf16 widening and bf16 hi + lo split its bf16-q int8 path takes. No
kernel launches.

Tolerances. The float32 emulation within 1e-6 of each row's max|out| of
the plain version run in float64 (the plain version's own float32 run is
up to 8.7e-7 off it here, and the two float32 orders, dequantizing before
or scaling after the dot product, differ by up to 1.3e-6 at int8 pages)
and of the reference's float32 oracle; phase-0 rows and rows without a
valid key are exact zeros. The int8 widening is exact; the hi + lo pair is
within 2^-16 of its float32 value (two bf16 roundings, 2^-8 each)."""

import inspect
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import paged_decode_attention as KP

SMEM_LIMIT = 232_448      # bytes of shared memory a block may take on an H100
WARPS = 4                 # warps a block
BF16, F32 = torch.bfloat16, torch.float32
DTYPES = pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])


def block_tiles(plan, pos, window, nb, ps, rank):
    """The kernel's range arithmetic: block ``rank``'s tiles [t_begin,
    t_end) of its row's keys [lo, hi], counted from lo, and (lo, hi)."""
    hi = min(pos, nb * ps - 1)
    lo = max(0, pos - window + 1) if window else 0
    ntiles = (hi - lo + plan.tile) // plan.tile if hi >= lo else 0
    per = -(-ntiles // plan.cluster)
    t_begin = min(ntiles, rank * per)
    return t_begin, min(ntiles, t_begin + per), lo, hi


def block_keys(plan, pos, window, nb, ps, rank):
    t0, t1, lo, hi = block_tiles(plan, pos, window, nb, ps, rank)
    return [k for k in range(lo + t0 * plan.tile, lo + t1 * plan.tile) if k <= hi]


@DTYPES
@settings(max_examples=300, deadline=None)
@given(nb=st.integers(1, 300), ps=st.sampled_from([1, 2, 4, 8, 16, 32, 64]),
       window=st.one_of(st.none(), st.integers(1, 5000)), data=st.data())
def test_blocks_cover_each_valid_key_once(dtype, nb, ps, window, data):
    """For every position up to two past the table's span, the cluster's
    blocks take each key of [lo, min(pos, nb*ps - 1)] exactly once and no
    key outside it; no block takes more than ``per_block`` tiles. At either
    q dtype's tile."""
    plan = KP.paged_split_plan(nb, ps, window, 4, 64, dtype=dtype)
    pos = data.draw(st.integers(0, nb * ps + 1))
    lo = max(0, pos - window + 1) if window else 0
    hi = min(pos, nb * ps - 1)
    taken = []
    for rank in range(plan.cluster):
        t0, t1, _, _ = block_tiles(plan, pos, window, nb, ps, rank)
        assert 0 <= t1 - t0 <= plan.per_block
        taken += block_keys(plan, pos, window, nb, ps, rank)
    assert taken == list(range(lo, hi + 1))


@DTYPES
@settings(max_examples=300, deadline=None)
@given(nb=st.integers(1, 5000), ps=st.sampled_from([1, 2, 4, 8, 16, 32, 64]),
       window=st.one_of(st.none(), st.integers(1, 100_000)), rep=st.integers(1, 8),
       hd=st.integers(1, 16).map(lambda n: 8 * n), int8=st.booleans())
def test_plan_invariants_the_launch_checks(dtype, nb, ps, window, rep, hd, int8):
    """The tile of q's dtype, at most 8 blocks, none idle at the longest
    row, and the ring's depth: what ``dispatch_split`` refuses a plan for
    breaking."""
    plan = KP.paged_split_plan(nb, ps, window, rep, hd, int8, dtype)
    reach = nb * ps if window is None else min(nb * ps, window)
    tiles = -(-reach // plan.tile)
    assert plan.tile == KP.TILE[dtype] == (64 if dtype == BF16 else 32)
    assert 1 <= plan.cluster <= KP.MAX_CLUSTER == 8 and plan.per_block >= 1
    assert (plan.cluster - 1) * plan.per_block < tiles <= plan.cluster * plan.per_block
    assert plan.stages == min(plan.per_block, KP.MAX_STAGES)
    assert plan.smem_bytes <= SMEM_LIMIT


def test_plan_depends_on_shapes_only():
    """The plan never sees a position: its arguments are shapes, and the
    same shapes give the same plan (positions live on the device)."""
    assert list(inspect.signature(KP.paged_split_plan).parameters) == [
        "nb", "page_size", "window", "rep", "hd", "int8", "dtype"]
    a = KP.paged_split_plan(40, 16, None, 4, 64)
    assert a == KP.paged_split_plan(40, 16, None, 4, 64)
    assert (a.cluster, a.per_block, a.stages) == (5, 2, 2)     # the serve shape
    assert KP.paged_split_plan(40, 16, 64, 4, 64).cluster == 1
    f = KP.paged_split_plan(40, 16, None, 4, 64, dtype=F32)   # 20 tiles of 32 keys
    assert (f.tile, f.cluster, f.per_block, f.stages) == (32, 7, 3, 3)
    assert KP.paged_split_plan(40, 16, 64, 4, 64, dtype=F32).cluster == 2


def _smem(int8, dtype, hd, rep, stages):
    """Shared memory laid out by hand: 64-key tiles for a bf16 q, 32 for a
    float32 q; K and V rows of hd padded to 64 or 128, bf16 at 2D + 16
    bytes, float32 at 4D + 16, int8 at D + 8 with two float32 scales a key;
    a bf16 q over int8 pages adds the warps' 32 bf16 rows, a float32 q its
    rep x hd values; the merge reuses it all."""
    D = 64 if hd <= 64 else 128
    if dtype == F32:
        stage = 2 * 32 * ((D + 8) + 4) if int8 else 2 * 32 * (4 * D + 16)
        loop = stages * stage + 4 * rep * hd
    else:
        stage = 2 * 64 * ((D + 8) + 4) if int8 else 2 * 64 * (2 * D + 16)
        loop = stages * stage + (WARPS * 32 * (2 * D + 16) if int8 else 0)
    return max(loop, 4 * (WARPS + 1) * rep * (hd + 2))


@DTYPES
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shared_memory_fits_every_dense_config(arch, int8, dtype):
    cfg = ARCHS[arch]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for nb in (1, 8, 40, 256, 4096):
        for window in (None, 64, cfg.sliding_window):
            plan = KP.paged_split_plan(nb, 16, window, H // K, hd, int8, dtype)
            assert plan.smem_bytes == _smem(int8, dtype, hd, H // K, plan.stages) <= SMEM_LIMIT


# -- the split-then-merge, emulated ---------------------------------------------------


def _merge(states):
    """Merge (m, l, acc) partial softmax states: (rep,), (rep,), (rep, hd)."""
    m = torch.stack([s[0] for s in states]).amax(0)
    l = sum(s[1] * torch.exp(s[0] - m) for s in states)
    acc = sum(s[2] * torch.exp(s[0] - m)[:, None] for s in states)
    return m, l, acc


def emulate(q, k, v, bt, pos, phase=None, window=None, ks=None, vs=None, dtype=BF16):
    """The split kernel's arithmetic in float32, at the tile of a q of
    ``dtype``: per (row, kv head), the plan's blocks take their tiles. With
    a bf16 q each of a block's four warps takes 16 keys of a 64-key tile
    with its own online softmax, and the warps merge in the block; with a
    float32 q the block takes each 32-key tile whole into one online
    softmax a head. The blocks merge in the cluster; out = acc / max(l,
    1e-20)."""
    R, H, hd = q.shape
    P, ps, K = k.shape[:3]
    rep, nb = H // K, bt.shape[1]
    plan = KP.paged_split_plan(nb, ps, window, rep, hd, ks is not None, dtype)
    width = plan.tile if dtype == F32 else plan.tile // WARPS   # keys of one softmax stream
    out = torch.zeros(R, H, hd)
    empty = (torch.full((rep,), -1e30), torch.zeros(rep), torch.zeros(rep, hd))
    for r in range(R):
        if phase is not None and int(phase[r]) == 0:
            continue
        for g in range(K):
            qg = q[r, g * rep:(g + 1) * rep].float()
            blocks = []
            for rank in range(plan.cluster):
                t0, t1, lo, hi = block_tiles(plan, int(pos[r]), window, nb, ps, rank)
                warps = [empty] * (plan.tile // width)
                for t in range(t0, t1):
                    for w in range(len(warps)):
                        first = lo + t * plan.tile + width * w
                        keys = [kp for kp in range(first, first + width) if kp <= hi]
                        if not keys:
                            continue
                        page = bt[r, [kp // ps for kp in keys]].long().clamp(0, P - 1)
                        off = torch.tensor([kp % ps for kp in keys])
                        kk, vv = k[page, off, g].float(), v[page, off, g].float()
                        s = (qg @ kk.T) / np.sqrt(hd)
                        if ks is not None:
                            s = s * ks[page, off, g, 0]
                            vv = vv * vs[page, off, g, 0][:, None]
                        m, l, acc = warps[w]
                        mn = torch.maximum(m, s.amax(-1))
                        p = torch.exp(s - mn[:, None])
                        c = torch.exp(m - mn)
                        warps[w] = (mn, l * c + p.sum(-1), acc * c[:, None] + p @ vv)
                blocks.append(_merge(warps))
            _, l, acc = _merge(blocks)
            out[r, g * rep:(g + 1) * rep] = acc / l.clamp_min(1e-20)[:, None]
    return out


def _case(seed, R, nb, ps, K, rep, hd, int8=False, span_extra=0):
    """Positions over the table's span (and ``span_extra`` past it), table
    entries in [0, P + 2) (the clamp), every third row at phase 0."""
    rng = np.random.default_rng(seed)
    P = R * nb + 2
    c = {"q": torch.from_numpy(rng.standard_normal((R, K * rep, hd), dtype=np.float32)),
         "bt": torch.from_numpy(rng.integers(0, P + 2, (R, nb)).astype(np.int32)),
         "pos": torch.from_numpy(rng.integers(0, nb * ps + span_extra, R).astype(np.int32)),
         "phase": torch.from_numpy((np.arange(R) % 3 != 0).astype(np.int32))}
    c["pos"][-1] = nb * ps - 1                                 # the longest row
    if int8:
        for n in ("k", "v"):
            c[n] = torch.from_numpy(rng.integers(-127, 128, (P, ps, K, hd)).astype(np.int8))
            c[n + "s"] = torch.from_numpy(
                (rng.random((P, ps, K, 1)) * 0.05 + 1e-3).astype(np.float32))
    else:
        for n in ("k", "v"):
            c[n] = torch.from_numpy(rng.standard_normal((P, ps, K, hd), dtype=np.float32))
    return c


def _rows_close(out, want, rel=1e-6):
    yard = want.abs().amax(-1, keepdim=True)
    assert bool(((out - want).abs() <= rel * yard).all()), \
        ((out - want).abs() / yard.clamp_min(1e-30)).max()


@DTYPES
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [None, 50, 200])
@pytest.mark.parametrize("nb,ps,rep,hd", [(40, 16, 4, 16), (13, 8, 8, 24), (3, 4, 1, 8)])
def test_emulated_split_matches_the_plain_version(nb, ps, rep, hd, window, int8, dtype):
    """Float32: the blocks' partial softmaxes, merged, give the plain
    version (run in float64) row by row at either tile, within 1e-6 of each
    row's max|out|; phase-0 rows are exact zeros."""
    c = _case(nb + ps + rep, R=4, nb=nb, ps=ps, K=2, rep=rep, hd=hd, int8=int8)
    scales = dict(ks=c["ks"], vs=c["vs"]) if int8 else {}
    out = emulate(c["q"], c["k"], c["v"], c["bt"], c["pos"], c["phase"], window, **scales,
                  dtype=dtype)
    if int8:
        pages = dict(k_scales=c["ks"].double(), v_scales=c["vs"].double())
        k, v = c["k"], c["v"]
    else:
        pages, k, v = {}, c["k"].double(), c["v"].double()
    want = KP.paged_attention_plain(c["q"].double(), k, v, c["bt"], c["pos"], window=window,
                                    phase=c["phase"], **pages).float()
    dead = c["phase"] == 0
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))
    _rows_close(out[~dead], want[~dead])


def test_rows_without_a_valid_key_are_zeros():
    """Positions past the table with a short window leave a row no valid
    key: every block's range is empty, and the merge gives zeros."""
    c = _case(3, R=3, nb=2, ps=4, K=1, rep=2, hd=8)
    pos = torch.tensor([8, 9, 3], dtype=torch.int32)      # keys 0-7; window 1
    out = emulate(c["q"], c["k"], c["v"], c["bt"], pos, window=1)
    assert torch.equal(out[:2], torch.zeros_like(out[:2]))
    assert bool(out[2].abs().sum() > 0)


def _jnp(c, *names):
    return [jnp.asarray(c[n].numpy()) for n in names]


@DTYPES
@pytest.mark.parametrize("window", [None, 37])
def test_emulated_split_matches_the_reference_oracle(window, dtype):
    """Float32 ragged rows against ``ref.ref_ragged_paged_decode_attention``
    (the JAX package's oracle) on the same numpy inputs, within 1e-6 of each
    row's max|out|."""
    c = _case(11, R=5, nb=12, ps=8, K=2, rep=4, hd=16)
    out = emulate(c["q"], c["k"], c["v"], c["bt"], c["pos"], c["phase"], window, dtype=dtype)
    want = torch.from_numpy(np.array(ref.ref_ragged_paged_decode_attention(
        *_jnp(c, "q", "k", "v", "bt", "pos", "phase"), window=window)))
    _rows_close(out, want)


@DTYPES
@pytest.mark.parametrize("window", [None, 37])
def test_emulated_split_without_phase_matches_the_reference_oracle(window, dtype):
    """The per-row-pos form (no phase: every row live) against
    ``ref.ref_paged_decode_attention`` on the same numpy inputs, within 1e-6
    of each row's max|out|."""
    c = _case(12, R=5, nb=12, ps=8, K=2, rep=4, hd=16)
    out = emulate(c["q"], c["k"], c["v"], c["bt"], c["pos"], None, window, dtype=dtype)
    want = torch.from_numpy(np.array(ref.ref_paged_decode_attention(
        *_jnp(c, "q", "k", "v", "bt", "pos"), window=window)))
    _rows_close(out, want)


@DTYPES
@pytest.mark.parametrize("window", [None, 37])
def test_emulated_split_int8_with_phase_matches_the_reference_oracle(window, dtype):
    """Int8 pages with a phase (the ragged int8 form) against
    ``ref.ref_ragged_paged_decode_attention_int8``, whose float32 form the
    kernel keeps, on the same numpy inputs, within 1e-6 of each row's
    max|out|; phase-0 rows exact zeros."""
    c = _case(13, R=5, nb=12, ps=8, K=2, rep=4, hd=16, int8=True)
    out = emulate(c["q"], c["k"], c["v"], c["bt"], c["pos"], c["phase"], window,
                  ks=c["ks"], vs=c["vs"], dtype=dtype)
    want = torch.from_numpy(np.array(ref.ref_ragged_paged_decode_attention_int8(
        *_jnp(c, "q", "k", "ks", "v", "vs", "bt", "pos", "phase"), window=window)))
    dead = c["phase"] == 0
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))
    _rows_close(out[~dead], want[~dead])


# -- the int8 path's numeric rules ---------------------------------------------------


def test_every_int8_value_is_exact_in_bf16():
    x = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    assert torch.equal(x.to(torch.bfloat16).float(), x.float())


def _byte_perm(x, y, s):
    b = struct.pack("<II", x, y)
    return struct.unpack("<I", bytes(b[(s >> (4 * i)) & 7] for i in range(4)))[0]


def _bf16(bits):
    return torch.tensor([bits], dtype=torch.int32).to(torch.int16).view(torch.bfloat16)


def _int8x2_to_bf16x2(p):
    """``int8x2_to_bf16x2`` of the kernel on bytes 0x00 b1 00 b0: 0x4300 | m
    (128 + m) plus 0xC300 | (b & 0x80) (-128 - 128 s), added in bf16."""
    x, o = (p & 0x007F007F) | 0x43004300, (p & 0x00800080) | 0xC300C300
    return [(_bf16((x >> sh) & 0xFFFF) + _bf16((o >> sh) & 0xFFFF)).float().item()
            for sh in (0, 16)]


def _int8x4_to_bf16x4(w):
    return (_int8x2_to_bf16x2(_byte_perm(w, 0, 0x4140))
            + _int8x2_to_bf16x2(_byte_perm(w, 0, 0x4342)))


def test_the_kernels_int8_widening_is_exact():
    """Every byte value in every place of a word comes out as its value."""
    vals = np.arange(-128, 128, dtype=np.int8)
    for shift in range(4):
        words = np.roll(np.stack([vals, vals[::-1], np.roll(vals, 7), np.roll(vals, 91)]),
                        shift, axis=0).T.copy()
        for row in words:
            assert _int8x4_to_bf16x4(int(row.view(np.uint32)[0])) == row.astype(float).tolist()


def _hi_lo(w):
    hi = w.to(torch.bfloat16)
    return hi, (w - hi.float()).to(torch.bfloat16)


def test_hi_lo_split_reconstructs_p_times_scale():
    """w = p * v_scale over p in [0, 1] and scales over twelve decades: hi +
    lo is within 2^-16 of w; hi alone is not (2^-8)."""
    rng = np.random.default_rng(0)
    p = rng.random(200_000, dtype=np.float32)
    scale = (10.0 ** rng.uniform(-8, 4, 200_000)).astype(np.float32)
    w = torch.from_numpy(p * scale)
    hi, lo = _hi_lo(w)
    err = (w.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -16 * w.double().abs()).all())
    assert float(((w.double() - hi.double()).abs() / w.double().clamp_min(1e-30)).max()) > 2.0 ** -12


@settings(max_examples=300, deadline=None)
@given(w=st.floats(float(np.float32(1e-30)), float(np.float32(1e30)), width=32))
def test_hi_lo_split_bound_holds_at_any_magnitude(w):
    t = torch.tensor([w], dtype=torch.float32)
    hi, lo = _hi_lo(t)
    assert abs(float(t.double() - hi.double() - lo.double())) <= 2.0 ** -16 * abs(float(t))
