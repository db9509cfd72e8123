"""The launch plans of the RMSNorm kernel (B6, ``rmsnorm_plan``), of the
Eq. 1 combines (B1/B3, ``combine_plan``) and of APG (B2, ``apg_plan``), as
the pure functions the wrappers call. Each plan is walked here in Python
with the kernel's own index arithmetic (``csrc/rmsnorm.cu`` and
``csrc/cfg_combine.cu``): every element, or every row's every vector, is
reached exactly once. B2's split-then-merge arithmetic is emulated in
float32 and held against the plain version and the reference's oracles
(1e-5 + 1e-5 |ref|: the sums are taken in another order; u == c rows bit
for bit). No kernel launches: these are plain Python and numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import cfg_combine as JC
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import build
from repro_torch.kernels import cfg_combine as KC
from repro_torch.kernels import rmsnorm as KR

DTYPES = [torch.bfloat16, torch.float32]


def _walk_rmsnorm(plan, rows, dim, dtype):
    """(row, vector) of every live access of the kernel's grid, in launch
    order: block b, thread (x, y), vector v -> row b * rows_per_block + y,
    vector x + v * threads."""
    b, y, x, v = np.meshgrid(np.arange(plan.blocks), np.arange(plan.rows_per_block),
                             np.arange(plan.threads), np.arange(plan.vecs), indexing="ij")
    row = (b * plan.rows_per_block + y).ravel()
    vec = (x + v * plan.threads).ravel()
    nvec = dim // build.VEC[dtype]
    live = (row < rows) & (vec < nvec)
    return row[live], vec[live]


def _block_ok(plan, dim):
    """The invariants ``plan_ok`` in ``csrc/rmsnorm.cu`` checks."""
    block = plan.threads * plan.rows_per_block
    sub_warp = plan.threads < 32 and plan.threads & (plan.threads - 1) == 0
    assert plan.threads % 32 == 0 or (sub_warp and plan.route == "many_rows" and dim <= 256)
    assert block % 32 == 0                                  # whole warps, sub-warp rows too
    assert block <= (1024 if plan.vecs <= 2 else 512)
    assert 1 <= plan.vecs <= KR.MAX_VECS


@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 300), dim=st.integers(1, KR.MAX_DIM // 8).map(lambda k: 8 * k),
       dtype=st.sampled_from(DTYPES))
def test_rmsnorm_plan_walk_reaches_every_vector_of_every_row_once(rows, dim, dtype):
    plan = KR.rmsnorm_plan(rows, dim, dtype)
    _block_ok(plan, dim)
    row, vec = _walk_rmsnorm(plan, rows, dim, dtype)
    nvec = dim // build.VEC[dtype]
    assert len(row) == rows * nvec
    counts = np.bincount(row * nvec + vec, minlength=rows * nvec)
    assert (counts == 1).all()


@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 1 << 20), dim=st.integers(1, KR.MAX_DIM // 8).map(lambda k: 8 * k),
       dtype=st.sampled_from(DTYPES))
def test_rmsnorm_plan_blocks_cover_the_rows_at_any_count(rows, dim, dtype):
    plan = KR.rmsnorm_plan(rows, dim, dtype)
    _block_ok(plan, dim)
    assert plan.threads * plan.vecs >= dim // build.VEC[dtype]
    assert plan.blocks == -(-rows // plan.rows_per_block)
    assert plan.route == ("few_rows" if rows < build.NUM_SMS and dim > 256 else "many_rows")
    # every thread has a vector to load: no warp of a row is idle
    assert (plan.threads - 32) * plan.vecs < dim // build.VEC[dtype] or plan.threads <= 32


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [4, 8, 16])
def test_rmsnorm_few_rows_spread_a_row_over_a_block(rows, dtype):
    """Decode (4-8 rows) and a serve tick (16): one block a row, 8 elements
    a thread, so each thread issues one x and one scale load at entry."""
    plan = KR.rmsnorm_plan(rows, 2048, dtype)
    assert plan == KR.RmsPlan("few_rows", 256, 8 // build.VEC[dtype], 1, rows)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,dim", [(2048, 2048), (256, 2048), (4 * 32, 64), (4 * 32, 120),
                                      (4 * 40, 128), (2048 * 32, 64), (2048 * 40, 128)])
def test_rmsnorm_many_rows_route(rows, dim, dtype):
    """The decode prefill, a serve prefill bucket and qk-norm head rows take
    the many-row route; head rows a power-of-two sub-warp of 8 elements a
    thread (hd 64: 8 lanes)."""
    plan = KR.rmsnorm_plan(rows, dim, dtype)
    assert plan.route == "many_rows"
    if dim <= 256:
        assert plan.threads == 1 << (dim // 8 - 1).bit_length()
        assert plan.vecs == 8 // build.VEC[dtype]
    else:
        assert plan.threads * plan.vecs * build.VEC[dtype] >= dim
        assert plan.vecs == 16 // build.VEC[dtype]
    if dim == 64:
        assert plan.threads == 8


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rmsnorm_plan_takes_every_dense_config(arch):
    cfg = ARCHS[arch]
    for dim in (cfg.d_model, cfg.resolved_head_dim, KR.MAX_DIM):
        for rows in (1, 4, 16, 131, 132, 2048, 4097):
            for dtype in DTYPES:
                plan = KR.rmsnorm_plan(rows, dim, dtype)
                _block_ok(plan, dim)
                assert plan.threads * plan.vecs * build.VEC[dtype] >= dim


@pytest.mark.parametrize("dim", [0, 4, 12, KR.MAX_DIM + 8])
def test_rmsnorm_plan_refuses_what_the_kernel_does_not_take(dim):
    with pytest.raises(ValueError):
        KR.rmsnorm_plan(4, dim, torch.bfloat16)


def _walk_combine(plan, n):
    """Element counts of the kernel's grid: access a = b * threads * vecs +
    v * threads + t; whole accesses (a < n // width) write width elements,
    the one partial access (a == n // width) its remaining elements. Also
    checks that only the last block holds accesses past the whole ones."""
    per = plan.threads * plan.vecs
    b, v, t = np.meshgrid(np.arange(plan.blocks), np.arange(plan.vecs),
                          np.arange(plan.threads), indexing="ij")
    a = (b * per + v * plan.threads + t).ravel()
    blk = b.ravel()
    full = n // plan.width
    assert (a[blk < plan.blocks - 1] < full).all()
    counts = np.zeros(n, dtype=np.int64)
    whole = a[a < full]
    np.add.at(counts, (whole[:, None] * plan.width + np.arange(plan.width)).ravel(), 1)
    if full * plan.width < n:
        assert (a == full).sum() == 1 and blk[a == full][0] == plan.blocks - 1
        counts[full * plan.width:] += 1
    return counts


@settings(max_examples=300, deadline=None)
@given(n=st.integers(1, 600_000), dtype=st.sampled_from(DTYPES), aligned=st.booleans(),
       rowscale=st.booleans(), data=st.data())
def test_combine_plan_walk_reaches_every_element_once(n, dtype, aligned, rowscale, data):
    feat = None
    if rowscale:
        rows = data.draw(st.integers(1, 8))
        feat = max(1, n // rows)
        n = rows * feat
    plan = KC.combine_plan(n, feat, dtype, aligned)
    V = build.VEC[dtype]
    assert plan.width == (V if aligned and (feat is None or feat % V == 0) else 1)
    assert plan.threads in (64, 128) and plan.threads <= 1024 and plan.threads % 32 == 0
    assert 2 <= plan.vecs <= 4
    assert (_walk_combine(plan, n) == 1).all()


@settings(max_examples=300, deadline=None)
@given(n=st.integers(1, 1 << 22), dtype=st.sampled_from(DTYPES))
def test_combine_plan_spreads_and_stays_one_wave(n, dtype):
    """Blocks reach min(132, accesses / 256); up to 132 x 2048 x 2 accesses
    (2048 resident threads an SM, two accesses each) they fit one wave."""
    plan = KC.combine_plan(n, None, dtype)
    acc = -(-n // plan.width)
    assert plan.blocks == -(-acc // (plan.threads * plan.vecs))
    assert plan.blocks >= min(build.NUM_SMS, -(-acc // 256))
    if acc <= build.NUM_SMS * 2048 * plan.vecs:
        assert plan.blocks <= build.NUM_SMS * (2048 // plan.threads)


@pytest.mark.parametrize("shape,threads,blocks", [
    ((1, 64, 64, 4), 64, 32), ((2, 64, 64, 4), 64, 64), ((8, 64, 64, 4), 128, 128),
    ((4, 128256), 128, 501)])
def test_combine_plan_at_the_main_paths_shapes(shape, threads, blocks):
    """The SD latent at B 1, 2 and 8 and the decode logits, float32: 16-byte
    accesses, two a thread, one wave."""
    n = int(np.prod(shape))
    for feat in (None, n // shape[0]):
        plan = KC.combine_plan(n, feat, torch.float32)
        assert plan == KC.CombinePlan(4, threads, 2, blocks)
        assert plan.blocks <= build.NUM_SMS * (2048 // plan.threads)


# -- B2: APG ----------------------------------------------------------------------

SMEM_MAX = 232_448          # shared memory a block may opt into on an H100


def _slice(plan, feat):
    """Accesses a block of a row takes (the last block of a row the rest):
    ``slice`` in ``apg_combine`` of ``csrc/cfg_combine.cu``."""
    return -(-(feat // plan.width) // plan.cluster)


def _walk_apg(plan, feat):
    """Element counts of one row under the kernel's index arithmetic: block
    rank r takes accesses [r * slice, min(acc, (r + 1) * slice)) of the row;
    thread t holds accesses v * threads + t (v < held) of its slice and, on
    the re-read route, takes held * threads + t + i * threads below the
    slice's end. Checks that no block is empty and every block's elements
    lie in its row."""
    acc, sl = feat // plan.width, _slice(plan, feat)
    counts = np.zeros(feat, dtype=np.int64)
    t = np.arange(plan.threads)
    for r in range(plan.cluster):
        n = min(sl, acc - r * sl)
        assert n >= 1
        held = (np.arange(plan.held)[:, None] * plan.threads + t).ravel()
        rounds = max(0, -(-(n - plan.held * plan.threads) // plan.threads))
        rest = (plan.held * plan.threads + t + np.arange(rounds)[:, None] * plan.threads).ravel()
        assert (rest < n).any() == (plan.route == "reread")
        j = np.concatenate([held[held < n], rest[rest < n]])
        e = ((r * sl + j)[:, None] * plan.width + np.arange(plan.width)).ravel()
        assert e.min() >= 0 and e.max() < feat
        np.add.at(counts, e, 1)
    return counts


def _apg_ok(plan, feat, dtype, has_diff, aligned):
    """The invariants ``apg_combine`` in ``csrc/cfg_combine.cu`` checks."""
    V = build.VEC[dtype]
    assert plan.width == (V if aligned and feat % V == 0 else 1)
    assert 1 <= plan.cluster <= KC.APG_MAX_CLUSTER <= 8
    assert (plan.cluster - 1) * _slice(plan, feat) < feat // plan.width
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= KC.APG_MAX_THREADS
    assert plan.held in KC.APG_HELD
    assert plan.held <= KC.apg_max_held(dtype, plan.width)
    assert plan.route == ("reread" if plan.threads * plan.held < _slice(plan, feat)
                          else "on_chip")
    assert plan.smem == 4 * (3 * (plan.threads // 32) + 3 * 8) <= SMEM_MAX


@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 200), feat=st.integers(1, 300_000), dtype=st.sampled_from(DTYPES),
       has_diff=st.booleans(), aligned=st.booleans())
def test_apg_plan_walk_reaches_every_element_of_every_row_once(rows, feat, dtype, has_diff,
                                                                aligned):
    plan = KC.apg_plan(rows, feat, dtype, has_diff, aligned)
    _apg_ok(plan, feat, dtype, has_diff, aligned)
    assert (_walk_apg(plan, feat) == 1).all()
    # the launch stays one wave of one-block-an-SM clusters; diff changes nothing
    assert plan.cluster == 1 or rows * plan.cluster <= KC.APG_WAVE_BLOCKS
    assert plan == KC.apg_plan(rows, feat, dtype, not has_diff, aligned)


@pytest.mark.parametrize("rows", [1, 4, 16, 65535, 65536, 70000, 65535 * 3 + 1])
def test_apg_grid_takes_each_row_once(rows):
    """Rows lie over grid y (at most 65535) and z, row = z * ry + y; the
    clusters past the last row exit at entry."""
    ry = min(rows, KC.APG_MAX_GRID)
    rz = -(-rows // ry)
    assert rz <= KC.APG_MAX_GRID
    row = (np.arange(rz)[:, None] * ry + np.arange(ry)).ravel()
    assert np.array_equal(np.sort(row[row < rows]), np.arange(rows))
    KC.apg_plan(rows, 64, torch.float32, False)


@pytest.mark.parametrize("rows,feat,cluster,threads,held,route", [
    (1, 64 * 64 * 4, 8, 128, 4, "on_chip"),   # the SD latent
    (8, 64 * 64 * 4, 8, 128, 4, "on_chip"),
    (4, 128256, 8, 512, 8, "on_chip"),        # guided_decode's logits
    (16, 128256, 4, 512, 8, "reread"),        # the serve engine's R = 16 combine
    (1, 151936, 8, 512, 8, "reread"),         # qwen3-14b's vocab
    (1, 256000, 8, 512, 8, "reread")])        # recurrentgemma-9b's vocab
def test_apg_plan_at_the_main_paths_shapes(rows, feat, cluster, threads, held, route):
    """Float32, 16-byte accesses; the decode logits' rows held whole in
    registers by clusters of 8, the longer vocabularies past 131072
    elements re-read, and 16 rows in clusters of 4 (one wave) re-read."""
    for has_diff in (False, True):
        plan = KC.apg_plan(rows, feat, torch.float32, has_diff)
        assert plan == KC.ApgPlan(4, cluster, threads, held, route,
                                  4 * (3 * threads // 32 + 24))
        _apg_ok(plan, feat, torch.float32, has_diff, True)
        assert (_walk_apg(plan, feat) == 1).all()


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_apg_plan_takes_every_dense_configs_logits(arch, dtype):
    vocab = ARCHS[arch].vocab_size
    for rows in (1, 4, 16):
        for has_diff in (False, True):
            plan = KC.apg_plan(rows, vocab, dtype, has_diff)
            _apg_ok(plan, vocab, dtype, has_diff, True)


@pytest.mark.parametrize("rows,feat", [(0, 64), (4, 0), (KC.APG_MAX_GRID ** 2 + 1, 4),
                                       (1, 4 * 8 << 31)])
def test_apg_plan_refuses_what_the_kernel_does_not_take(rows, feat):
    with pytest.raises(ValueError):
        KC.apg_plan(rows, feat, torch.float32, False)


def _apg_emulate(u, c, scale, eta, threshold, diff, plan):
    """B2's arithmetic in float32 numpy: each block's partial |d|^2, |c|^2
    and d.c over its slice, summed over the cluster in rank order, and
    out = c + a d + b c with a = (s - 1) k, b = (s - 1) (eta - 1) p / |c|."""
    f = np.float32
    rows, feat = c.shape
    d = (c - u) if diff is None else diff
    scales = np.broadcast_to(np.asarray(scale, np.float32), (rows,))
    span = _slice(plan, feat) * plan.width
    out = np.empty_like(c)
    for r in range(rows):
        dd = cc = dc = f(0)
        for b in range(plan.cluster):
            sl = slice(b * span, (b + 1) * span)
            dd += np.sum(d[r, sl] * d[r, sl], dtype=f)
            cc += np.sum(c[r, sl] * c[r, sl], dtype=f)
            dc += np.sum(d[r, sl] * c[r, sl], dtype=f)
        k = min(f(1), f(threshold) / max(np.sqrt(dd), f(KC.EPS))) if threshold > 0 else f(1)
        cn = max(np.sqrt(cc), f(KC.EPS))
        p = f(k * dc / cn)
        s1 = f(scales[r] - f(1))
        a, b_ = f(s1 * k), f(s1 * (f(f(eta) - f(1)) * f(p / cn)))
        out[r] = a * d[r] + (b_ * c[r] + c[r])
    return out


@pytest.mark.parametrize("shape,per_row,eta,threshold,with_diff", [
    ((4, 128256), True, 0.3, 2.0, False), ((4, 128256), False, 0.0, 0.0, False),
    ((1, 64 * 64 * 4), False, 0.3, 1.0, True), ((1, 256000), False, 0.3, 0.0, False),
    ((3, 1001), True, 1.0, 50.0, True)])
def test_apg_split_then_merge_matches_plain_and_reference(shape, per_row, eta, threshold,
                                                          with_diff):
    rng = np.random.default_rng(sum(shape))
    u = rng.standard_normal(shape).astype(np.float32)
    c = rng.standard_normal(shape).astype(np.float32)
    u[0] = c[0]                                           # a self-paired row
    if shape[0] > 2:
        u[-1] = c[-1] = 0.0                               # a padding row
    diff = rng.standard_normal(shape).astype(np.float32) if with_diff else None
    scale = (np.linspace(1.5, 7.5, shape[0]).astype(np.float32) if per_row
             else np.float32(7.5))
    plan = KC.apg_plan(shape[0], shape[1], torch.float32, with_diff)
    got = _apg_emulate(u, c, scale, eta, threshold, diff, plan)
    t = torch.from_numpy
    plain = KC.apg_combine_plain(t(u), t(c), t(scale) if per_row else float(scale), eta=eta,
                                 threshold=threshold,
                                 diff=None if diff is None else t(diff)).numpy()
    ref = np.asarray(JC.apg_combine_ref(jnp.asarray(u), jnp.asarray(c),
                                        jnp.asarray(scale)[:, None] if per_row else float(scale),
                                        eta=eta, threshold=threshold,
                                        diff=None if diff is None else jnp.asarray(diff)))
    for want in (plain, ref):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got).all()
    if diff is None:
        np.testing.assert_array_equal(got[0], c[0])
