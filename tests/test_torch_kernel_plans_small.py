"""The launch plans of the RMSNorm kernel (B6, ``rmsnorm_plan``) and of the
Eq. 1 combines (B1/B3, ``combine_plan``), as the pure functions the
wrappers call. Each plan is walked here in Python with the kernel's own
index arithmetic (``csrc/rmsnorm.cu`` and ``csrc/cfg_combine.cu``): every
element, or every row's every vector, is reached exactly once. No kernel
launches: these are plain Python and numpy."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
