"""The plain versions beside the port's flash-prefill (B4), flash-decode (B5)
and RMSNorm (B6) kernels against the reference, on the same numpy inputs:
the Pallas kernels in interpret mode, the ``repro/kernels/ref.py`` oracles
and the model's jnp twins. The wrappers take the plain versions for CPU
tensors, so these tests go through the wrappers, and no kernel launches.

Tolerances. float32: 2e-5 of max|out| (the same math, summed in another
order; the Pallas kernels' online softmax rescales per tile). bf16 against
the oracles: one bf16 step (2^-8) of max|out|, as both round the scores and
the weights once, in the same places. bf16 against the Pallas kernels: 2^-6
of max|out|, since those keep the scores in float32 and round p per tile.
RMSNorm in bf16: one bf16 step of each value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import decode_attention as KD
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import rmsnorm as KR
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL

BF16 = 2.0 ** -8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(shapes, dtype, seed):
    """numpy float32 draws, rounded to ``dtype``; -> (jax arrays, tensors)."""
    rng = np.random.default_rng(seed)
    arrs = [np.asarray(jnp.asarray(rng.standard_normal(s, dtype=np.float32), dtype))
            for s in shapes]
    return [jnp.asarray(a) for a in arrs], [convert.to_tensor(a) for a in arrs]


def _close(out, expect, tol):
    out, expect = _np(out), _np(expect)
    assert out.shape == expect.shape
    np.testing.assert_allclose(out, expect, rtol=0, atol=tol * np.abs(expect).max())


def _no_launches():
    assert KF.LAUNCHES == {"flash_attention": 0}
    assert KD.LAUNCHES == {"decode_attention": 0}
    assert KR.LAUNCHES == {"rmsnorm": 0}


# -- B4: flash prefill ------------------------------------------------------------


@pytest.mark.parametrize("S,H,K,hd", [(128, 4, 2, 64), (256, 8, 1, 32)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None),
                                           (False, 48)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_vs_pallas_and_oracle(S, H, K, hd, causal, window, dtype):
    (q, k, v), (tq, tk, tv) = _inputs([(2, S, H, hd), (2, S, K, hd), (2, S, K, hd)], dtype, S)
    out = KF.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype
    f32 = dtype == jnp.float32
    _close(out, ref.ref_flash_attention(q, k, v, causal=causal, window=window),
           2e-5 if f32 else BF16)
    _close(out, flash_attention_pallas(q, k, v, causal=causal, window=window, interpret=True),
           2e-5 if f32 else 4 * BF16)
    _no_launches()


@pytest.mark.parametrize("S,window", [(77, None), (77, 20), (33, 5)])
def test_flash_plain_any_length_vs_oracle(S, window):
    (q, k, v), (tq, tk, tv) = _inputs([(1, S, 6, 16), (1, S, 3, 16), (1, S, 3, 16)],
                                      jnp.float32, S)
    for causal in (True, False):
        _close(KF.flash_attention(tq, tk, tv, causal=causal, window=window),
               ref.ref_flash_attention(q, k, v, causal=causal, window=window), 2e-5)


def _attn_pair(qk_norm=False, seed=0, D=64, H=4, K=2, hd=16):
    kw = dict(name="a", family="dense", num_layers=1, d_model=D, num_heads=H, num_kv_heads=K,
              d_ff=128, vocab_size=64, qk_norm=qk_norm, rope_theta=5e5)
    rng = np.random.default_rng(seed)
    p = {n: (rng.standard_normal(s) / np.sqrt(D)).astype(np.float32) for n, s in
         (("wq", (D, H, hd)), ("wk", (D, K, hd)), ("wv", (D, K, hd)), ("wo", (H, hd, D)))}
    if qk_norm:
        p["q_norm"] = rng.standard_normal(hd).astype(np.float32)
        p["k_norm"] = rng.standard_normal(hd).astype(np.float32)
    tp = TL.tree_module({n: torch.from_numpy(a) for n, a in p.items()})
    return JModelConfig(**kw), ModelConfig(**kw), {n: jnp.asarray(a) for n, a in p.items()}, tp


@pytest.mark.parametrize("causal,window,qk_norm", [(True, None, False), (True, 40, True),
                                                   (False, None, False)])
def test_attn_forward_auto_vs_model_twins(causal, window, qk_norm):
    """The port's prefill path (plain version on the CPU) against the
    model's direct ``attn_forward`` and its blocked flash-style scan with
    small chunks, float32."""
    jcfg, tcfg, jp, tp = _attn_pair(qk_norm)
    S = 128
    x = np.random.default_rng(3).standard_normal((2, S, 64)).astype(np.float32)
    pos = np.arange(S)[None]
    out, kv = TA.attn_forward_auto(tp, tcfg, torch.from_numpy(x),
                                   TL.rope_tables(torch.from_numpy(pos), 16, 5e5),
                                   causal=causal, window=window)
    direct, jkv = JA.attn_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), causal=causal,
                                  window=window)
    blocked, _ = JA.attn_forward_blocked(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                         causal=causal, window=window, q_chunk=32,
                                         kv_chunk=32)
    _close(out, direct, 2e-5)
    _close(out, blocked, 2e-5)
    _close(kv["k"], jkv["k"], 1e-6)
    _close(kv["v"], jkv["v"], 1e-6)
    _no_launches()


# -- B5: flash decode ---------------------------------------------------------------


@pytest.mark.parametrize("S,H,K,hd,pos", [(256, 4, 4, 64, 100), (256, 8, 2, 32, 255),
                                          (256, 8, 1, 64, 0)])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_plain_vs_pallas_and_oracle(S, H, K, hd, pos, window, dtype):
    (q, k, v), (tq, tk, tv) = _inputs([(2, H, hd), (2, S, K, hd), (2, S, K, hd)], dtype,
                                      pos + hd)
    out = KD.decode_attention(tq, tk, tv, pos, window=window)
    assert out.dtype == tq.dtype
    f32 = dtype == jnp.float32
    _close(out, ref.ref_decode_attention(q, k, v, pos, window=window), 2e-5 if f32 else BF16)
    _close(out, decode_attention_pallas(q, k, v, pos, window=window, bk=128, interpret=True),
           2e-5 if f32 else 4 * BF16)
    _no_launches()


@pytest.mark.parametrize("pos,window", [(0, None), (40, None), (71, None), (71, 16)])
def test_decode_plain_capacity_72_vs_oracle(pos, window):
    (q, k, v), (tq, tk, tv) = _inputs([(3, 6, 16), (3, 72, 2, 16), (3, 72, 2, 16)],
                                      jnp.float32, pos)
    _close(KD.decode_attention(tq, tk, tv, pos, window=window),
           ref.ref_decode_attention(q, k, v, pos, window=window), 2e-5)


@pytest.mark.parametrize("window,qk_norm", [(None, False), (24, True)])
def test_attn_decode_vs_model_twin(window, qk_norm):
    """One decode token against a half-filled linear cache: the port writes
    the new K/V in place and attends; the reference's ``attn_decode``
    updates functionally. Outputs and caches agree, float32."""
    jcfg, tcfg, jp, tp = _attn_pair(qk_norm, seed=1)
    rng = np.random.default_rng(4)
    cap, pos = 48, 30
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    k = rng.standard_normal((2, cap, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, cap, 2, 16)).astype(np.float32)
    k[:, pos:], v[:, pos:] = 0, 0
    ref_out, ref_cache = JA.attn_decode(jp, jcfg, jnp.asarray(x),
                                        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, pos,
                                        window=window)
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    rope = TL.rope_tables(torch.full((1, 1), pos), 16, 5e5)
    out, cache = TA.attn_decode(tp, tcfg, torch.from_numpy(x), cache, pos, rope, window=window)
    _close(out, ref_out, 2e-5)
    _close(cache["k"], ref_cache["k"], 1e-6)
    _close(cache["v"], ref_cache["v"], 1e-6)
    _no_launches()


# -- B6: RMSNorm ------------------------------------------------------------------


@pytest.mark.parametrize("rows,dim", [(1, 64), (5, 128), (130, 256), (4, 2048)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_plain_vs_pallas_oracle_and_layer(rows, dim, dtype):
    (x, s), (tx, ts) = _inputs([(rows, dim), (dim,)], dtype, rows * dim)
    x, tx = x * 3, tx * 3
    s32 = s.astype(jnp.float32)
    out = KR.rmsnorm(tx, ts.float(), 1e-5)
    assert out.dtype == tx.dtype
    expect = [ref.ref_rmsnorm(x, s32, 1e-5), rmsnorm_pallas(x, s32, 1e-5, interpret=True),
              JL.rmsnorm({"scale": s32}, x, 1e-5)]
    for e in expect:
        e = _np(e)
        if dtype == jnp.float32:
            np.testing.assert_allclose(_np(out), e, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(_np(out), e, rtol=BF16, atol=0)
    _close(TL.rmsnorm(ts.float(), tx, 1e-5), out, 0)
    _no_launches()


def test_head_rmsnorm_matches_reference():
    (x, s), (tx, ts) = _inputs([(2, 3, 4, 16), (16,)], jnp.bfloat16, 7)
    np.testing.assert_array_equal(_np(TL.head_rmsnorm(ts, tx)), _np(JL.head_rmsnorm(s, x)))


# -- the wrappers' contract ---------------------------------------------------------


def test_wrappers_refuse_what_is_neither_cpu_nor_one_cuda_device():
    """A CUDA tensor never takes the plain version. Meta tensors (shapes
    without data: the dry-run's) take it as CPU tensors do, launching
    nothing, and tensors on two devices raise."""
    m = dict(device="meta")
    out = KF.flash_attention(torch.empty(1, 8, 2, 8, **m), torch.empty(1, 8, 1, 8, **m),
                             torch.empty(1, 8, 1, 8, **m))
    assert out.is_meta and out.shape == (1, 8, 2, 8)
    out = KD.decode_attention(torch.empty(1, 2, 8, **m), torch.empty(1, 8, 1, 8, **m),
                              torch.empty(1, 8, 1, 8, **m), 3)
    assert out.is_meta and out.shape == (1, 2, 8)
    assert KR.rmsnorm(torch.empty(4, 8, **m), torch.empty(8, **m)).is_meta
    with pytest.raises(ValueError, match="CUDA"):
        KR.rmsnorm(torch.empty(4, 8), torch.empty(8, **m))
    with pytest.raises(ValueError, match="CUDA"):
        KD.decode_attention(torch.empty(1, 2, 8), torch.empty(1, 8, 1, 8, **m),
                            torch.empty(1, 8, 1, 8), 3)
    _no_launches()


def test_wrappers_check_shapes():
    with pytest.raises(ValueError):
        KF.flash_attention(torch.zeros(1, 8, 3, 8), torch.zeros(1, 8, 2, 8),
                           torch.zeros(1, 8, 2, 8))
    with pytest.raises(ValueError):
        KF.flash_attention(torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 1, 8),
                           torch.zeros(1, 8, 1, 8), window=0)
    with pytest.raises(TypeError):
        KF.flash_attention(torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 1, 8),
                           torch.zeros(1, 8, 1, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        KD.decode_attention(torch.zeros(1, 2, 8), torch.zeros(1, 8, 1, 4),
                            torch.zeros(1, 8, 1, 4), 0)
    with pytest.raises(ValueError):
        KR.rmsnorm(torch.zeros(4, 8), torch.zeros(6))
