"""The port's guidance combines (the plain versions, which CPU tensors take)
against the reference's Pallas kernels in interpret mode and its jnp oracle,
on the same numpy inputs.

Tolerances: Eq. 1 is three float32 roundings on both sides, so 1e-6
relative (XLA may order them otherwise); APG sums rows in another order,
so 1e-5; bfloat16 outputs within one bf16 step (2^-7 relative). The
exactness contracts (s == 1 returns eps_cond, rows with u == c return c)
are checked bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import guidance as jg
from repro.kernels import cfg_combine as jk
from repro_torch.convert import to_tensor
from repro_torch.core import guidance as tg
from repro_torch.kernels import cfg_combine as K

SHAPES = [(5,), (3, 7), (2, 8, 8, 4), (1, 64, 64, 4), (4, 33)]


def _inputs(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape).astype(np.float32)
    c = rng.standard_normal(shape).astype(np.float32)
    if dtype != np.float32:
        u, c = np.asarray(jnp.asarray(u, dtype)), np.asarray(jnp.asarray(c, dtype))
    return u, c


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    K.reset_launches()
    yield
    assert K.LAUNCHES == {"cfg_combine": 0, "cfg_combine_rowscale": 0, "apg_combine": 0}


@settings(max_examples=12, deadline=None)
@given(st.sampled_from(SHAPES), st.floats(-20, 20).filter(lambda s: s != 1.0),
       st.sampled_from(["float32", "bfloat16"]), st.integers(0, 2**16))
def test_cfg_combine_matches_pallas(shape, scale, dtype, seed):
    u, c = _inputs(shape, seed, jnp.dtype(dtype))
    ref = jk.cfg_combine_pallas(jnp.asarray(u), jnp.asarray(c), scale, interpret=True)
    out = tg.cfg_combine(to_tensor(u), to_tensor(c), scale)
    assert tuple(out.shape) == shape and str(out.dtype).endswith(dtype)
    rtol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=rtol, atol=1e-6)
    # and the jnp path that the reference's sampler takes off the TPU
    np.testing.assert_allclose(_f32(out), _f32(jg.cfg_combine(jnp.asarray(u),
                                                              jnp.asarray(c), scale)),
                               rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cfg_combine_scale_one_returns_cond_itself(dtype):
    u, c = _inputs((4, 33), 2, jnp.dtype(dtype))
    tc = to_tensor(c)
    out = tg.cfg_combine(to_tensor(u), tc, 1.0)
    assert out is tc
    assert np.array_equal(_f32(out), _f32(jk.cfg_combine_pallas(
        jnp.asarray(u), jnp.asarray(c), 1.0, interpret=True)))


@settings(max_examples=12, deadline=None)
@given(st.sampled_from([s for s in SHAPES if len(s) > 1]),
       st.lists(st.floats(-10, 10), min_size=8, max_size=8),
       st.sampled_from(["float32", "bfloat16"]), st.integers(0, 2**16))
def test_cfg_combine_rowscale_matches_pallas(shape, scales, dtype, seed):
    u, c = _inputs(shape, seed, jnp.dtype(dtype))
    s = np.asarray(scales[: shape[0]], np.float32)
    s[0] = 1.0                                   # a row outside the interval
    ref = jk.cfg_combine_rowscale_pallas(jnp.asarray(u), jnp.asarray(c), jnp.asarray(s),
                                         interpret=True)
    out = tg.cfg_combine_rowscale(to_tensor(u), to_tensor(c), torch.from_numpy(s))
    rtol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=rtol, atol=1e-6)
    # the row at 1.0 computes u + 1.0 * (c - u), exactly as the reference's
    # interval mode does with its traced scale
    np.testing.assert_array_equal(_f32(out)[0], _f32(jg.cfg_combine(
        jnp.asarray(u[0]), jnp.asarray(c[0]), jnp.float32(1.0))))


@settings(max_examples=12, deadline=None)
@given(st.sampled_from([s for s in SHAPES if len(s) > 1]), st.floats(-5, 12),
       st.sampled_from([0.0, 0.3, 1.0]), st.sampled_from([0.0, 0.5, 1.0, 50.0]),
       st.integers(0, 2**16))
def test_apg_combine_matches_pallas(shape, scale, eta, threshold, seed):
    u, c = _inputs(shape, seed)
    u[0] = c[0]                                   # a self-paired row
    ref = jk.apg_combine_pallas(jnp.asarray(u), jnp.asarray(c), scale, eta=eta,
                                threshold=threshold, interpret=True)
    out = tg.apg_combine(to_tensor(u), to_tensor(c), scale, eta=eta, threshold=threshold)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_f32(out)[0], c[0])


@settings(max_examples=12, deadline=None)
@given(st.sampled_from([s for s in SHAPES if len(s) > 1]), st.floats(-5, 12),
       st.sampled_from([0.0, 0.3]), st.sampled_from([0.0, 1.0]), st.integers(0, 2**16))
def test_apg_combine_with_diff_matches_ref(shape, scale, eta, threshold, seed):
    u, c = _inputs(shape, seed)
    diff = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32)
    ref = jk.apg_combine_ref(jnp.asarray(u), jnp.asarray(c), scale, eta=eta,
                             threshold=threshold, diff=jnp.asarray(diff))
    out = tg.apg_combine(to_tensor(u), to_tensor(c), scale, eta=eta, threshold=threshold,
                         diff=to_tensor(diff))
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=1e-5, atol=1e-5)
    # with diff the reference's dispatcher takes the same oracle
    np.testing.assert_allclose(_f32(out), _f32(jg.apg_combine(
        jnp.asarray(u), jnp.asarray(c), scale, eta=eta, threshold=threshold,
        diff=jnp.asarray(diff))), rtol=1e-5, atol=1e-5)


def test_apg_zero_rows_stay_finite_and_bf16_dtype_kept():
    z = np.zeros((2, 8, 8, 4), np.float32)
    out = tg.apg_combine(to_tensor(z), to_tensor(z), 7.5, eta=0.3, threshold=1.0)
    assert torch.isfinite(out).all() and (out == 0).all()
    u, c = _inputs((2, 8, 8, 4), 3, jnp.bfloat16)
    out = tg.apg_combine(to_tensor(u), to_tensor(c), 4.0)
    ref = jk.apg_combine_pallas(jnp.asarray(u), jnp.asarray(c), 4.0, interpret=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2 ** -7, atol=1e-5)


def test_apg_per_row_scales_at_the_logits_match_pallas():
    """The serve engine's form at guided_decode's logits, (4, 128256)
    float32, one scale a row, a self-paired row and an all-zero padding row:
    the reference's Pallas kernel in interpret mode, one row at a time with
    that row's scale (it takes one scale a call), and its oracle with the
    (4, 1) scale column, against the port's plain version on the same
    inputs."""
    u, c = _inputs((4, 128256), 18)
    u[1] = c[1]                                   # a self-paired row
    u[3] = c[3] = 0.0                             # a padding row
    scales = np.array([3.0, 7.5, 1.0, 3.0], np.float32)
    out = _f32(tg.apg_combine(to_tensor(u), to_tensor(c), to_tensor(scales), eta=0.3,
                              threshold=2.0))
    ref = np.concatenate([_f32(jk.apg_combine_pallas(
        jnp.asarray(u[r:r + 1]), jnp.asarray(c[r:r + 1]), float(scales[r]), eta=0.3,
        threshold=2.0, interpret=True)) for r in range(4)])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, _f32(jk.apg_combine_ref(
        jnp.asarray(u), jnp.asarray(c), jnp.asarray(scales)[:, None], eta=0.3,
        threshold=2.0)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out[1], c[1])
    assert np.isfinite(out).all() and (out[3] == 0).all()


def test_split_merge_match_reference():
    c = np.arange(24, dtype=np.float32).reshape(4, 6)
    u = -c
    m = tg.merge_cond_uncond(torch.from_numpy(c), torch.from_numpy(u))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jg.merge_cond_uncond(c, u)))
    c2, u2 = tg.split_cond_uncond(m)
    np.testing.assert_array_equal(c2.numpy(), c)
    np.testing.assert_array_equal(u2.numpy(), u)
    with pytest.raises(ValueError):
        tg.split_cond_uncond(torch.zeros(3, 2))


def test_wrappers_check_inputs_and_never_fall_back():
    u, c = torch.zeros(2, 4), torch.ones(2, 4)
    with pytest.raises(ValueError):
        K.cfg_combine(u, torch.ones(2, 5), 2.0)
    with pytest.raises(ValueError):
        K.cfg_combine(u.double(), c, 2.0)
    with pytest.raises(ValueError):
        K.cfg_combine_rowscale(u, c, torch.ones(3))
    with pytest.raises(ValueError):
        K.apg_combine(u, c, 2.0, diff=torch.zeros(2, 5))
    # a tensor that is on no CPU takes no plain path: it raises
    with pytest.raises(ValueError):
        K.cfg_combine(u.to("meta"), c.to("meta"), 2.0)
    with pytest.raises(ValueError):
        K.apg_combine(u.to("meta"), c, 2.0)
