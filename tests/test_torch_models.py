"""The port's text encoder and UNet against the reference's, on the same
weights (converted) and the same numpy inputs.

Tolerances: the UNet runs in float32 on both sides, with convolutions and
matmuls summed in other orders, so 1e-4 relative to the output's largest
value. The encoder runs in bf16: one eager layer is bit-exact, but the
reference scans its layers and XLA keeps some bf16 intermediates of the
fused body in float32, so the 4-layer output is held to 8 bf16 steps
(8 * 2^-8) of its largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import UNetConfig as JUNetConfig
from repro.core.pipeline import SDPipeline as JPipe
from repro.data.tokenizer import encode_batch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models import unet as JU
from repro_torch import convert
from repro_torch.configs.base import UNetConfig
from repro_torch.core.pipeline import TEXT_VOCAB, SDPipeline
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models import unet as TU

PROMPTS = ["a red disc", "a blue square with a long tail of words", ""]


def _pair(cfg):
    jp = JPipe.init(JUNetConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}),
                    jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp.params)
    return jp, SDPipeline.from_state(cfg, convert.from_jax_params(tree), device="cpu")


@pytest.fixture(scope="module")
def reduced():
    return _pair(UNetConfig().reduced())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_encoder_layer_bit_exact(reduced):
    jp, tp = reduced
    tcfg = jp.text_cfg()
    toks = encode_batch(PROMPTS, TEXT_VOCAB, jp.cfg.text_len)
    xj = JL.embed(jp.params["text"]["embed"], jnp.asarray(toks), dtype=jnp.bfloat16)
    xt = TL.embed(tp.text.embed.table, torch.from_numpy(toks).long(), dtype=torch.bfloat16)
    np.testing.assert_array_equal(_f32(xt), _f32(xj))
    for i in range(tcfg.num_layers):
        bp = jax.tree.map(lambda a: a[i], jp.params["text"]["segments"][0][0])
        xj, _, _ = JT.block_forward(bp, tcfg, "attn", xj, jnp.arange(xj.shape[1])[None],
                                    moe_layer=False)
        xt = TT.encoder_layer(tp.text.layers[i], tcfg, xt, torch.arange(xt.shape[1])[None])
        np.testing.assert_array_equal(_f32(xt), _f32(xj))


def test_encode_text_matches_at_bf16_tolerance(reduced):
    jp, tp = reduced
    ref = jp.encode_prompts(PROMPTS)
    out = tp.encode_prompts(PROMPTS)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert tuple(out.shape) == ref.shape == (3, jp.cfg.text_len, jp.cfg.text_dim)
    tol = 8 * 2 ** -8 * np.abs(_f32(ref)).max()
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=0, atol=tol)
    null_ref, null = jp.null_embedding(2), tp.null_embedding(2)
    np.testing.assert_allclose(_f32(null), _f32(null_ref), rtol=0,
                               atol=8 * 2 ** -8 * np.abs(_f32(null_ref)).max())


def _unet_case(jp, tp, B, seed):
    cfg = jp.cfg
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, cfg.latent_size, cfg.latent_size, cfg.in_channels),
                            dtype=np.float32)
    text = rng.standard_normal((B, cfg.text_len, cfg.text_dim), dtype=np.float32)
    text_bf16 = np.asarray(jnp.asarray(text, jnp.bfloat16))
    t = rng.integers(0, 1000, size=B).astype(np.int32)
    ref = np.asarray(JU.unet_forward(jp.params["unet"], cfg, jnp.asarray(x), jnp.asarray(t),
                                     jnp.asarray(text_bf16)))
    out = TU.unet_forward(tp.unet, torch.from_numpy(x), torch.from_numpy(t),
                          convert.to_tensor(text_bf16))
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_unet_forward_reduced(reduced):
    jp, tp = reduced
    _unet_case(jp, tp, B=3, seed=1)


def test_unet_forward_default_config():
    jp, tp = _pair(UNetConfig())
    _unet_case(jp, tp, B=1, seed=2)


@pytest.mark.parametrize("hw", [(2, 2), (4, 6), (7, 5)])
def test_nearest_upsample_equals_image_resize(hw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, hw[0] * 2, hw[1] * 2, 3), "nearest"))
    out = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                                          scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("size", [8, 9, 16])
@pytest.mark.parametrize("stride,k", [(2, 3), (1, 3), (1, 1)])
def test_conv_same_padding(size, stride, k):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ref = np.asarray(JU.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                               stride=stride))
    p = TL.tree_module({"w": torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(),
                        "b": torch.from_numpy(b)})
    out = TU.conv2d(p, torch.from_numpy(x).permute(0, 3, 1, 2), stride=stride)
    assert tuple(out.shape) == (2, 6, *ref.shape[1:3])
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)
    if stride == 2 and size % 2 == 0:
        assert TU._same_pads(size, 3, 2) == (0, 1)


@pytest.mark.parametrize("channels,groups", [(32, 8), (48, 32), (20, 8), (7, 32)])
def test_groupnorm_group_fallback(channels, groups):
    rng = np.random.default_rng(channels)
    x = rng.standard_normal((2, 4, 4, channels)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(channels).astype(np.float32)
    bias = rng.standard_normal(channels).astype(np.float32)
    ref = np.asarray(JU.groupnorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                  jnp.asarray(x), groups))
    p = TL.tree_module({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    out = TU.groupnorm(p, torch.from_numpy(x).permute(0, 3, 1, 2), groups)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(5)[None].repeat(2, 0)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos))), rtol=1e-6, atol=1e-6)
    t = np.array([0, 1, 37, 999], np.int32)
    np.testing.assert_allclose(TL.sinusoidal_embedding(torch.from_numpy(t), 64).numpy(),
                               np.asarray(JL.sinusoidal_embedding(jnp.asarray(t), 64)),
                               rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    s, bb = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        TL.layernorm(torch.from_numpy(s), torch.from_numpy(bb), torch.from_numpy(h)).numpy(),
        np.asarray(JL.layernorm({"scale": s, "bias": bb}, jnp.asarray(h))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TL.rmsnorm(torch.from_numpy(s), torch.from_numpy(h)).numpy(),
        np.asarray(JL.rmsnorm({"scale": s}, jnp.asarray(h))), rtol=1e-5, atol=1e-5)
    w = {k: rng.standard_normal(sh).astype(np.float32) for k, sh in
         (("w_in", (16, 32)), ("b_in", (32,)), ("w_out", (32, 16)), ("b_out", (16,)))}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    np.testing.assert_allclose(
        TL.gelu_mlp(tw["w_in"], tw["b_in"], tw["w_out"], tw["b_out"], torch.from_numpy(h)).numpy(),
        np.asarray(JL.gelu_mlp(w, jnp.asarray(h))), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal,window,qk_norm", [(False, None, False), (True, None, True),
                                                   (True, 3, False)])
def test_attn_forward_direct_path(causal, window, qk_norm):
    """float32, so 1e-5 of the largest output: the same einsums summed in
    another order."""
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import attention as JA
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import attention as TA

    kw = dict(name="a", family="dense", num_layers=1, d_model=32, num_heads=4,
              num_kv_heads=2, d_ff=64, vocab_size=16, qk_norm=qk_norm)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(1)
    p = {k: (rng.standard_normal(sh) / np.sqrt(32)).astype(np.float32) for k, sh in
         (("wq", (32, 4, 8)), ("wk", (32, 2, 8)), ("wv", (32, 2, 8)), ("wo", (4, 8, 32)))}
    if qk_norm:
        p["q_norm"] = rng.standard_normal(8).astype(np.float32)
        p["k_norm"] = rng.standard_normal(8).astype(np.float32)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    pos = np.arange(6)[None]
    ref, _ = JA.attn_forward({k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x),
                             jnp.asarray(pos), causal=causal, window=window)
    out = TA.attn_forward(TL.tree_module({k: torch.from_numpy(v) for k, v in p.items()}), tcfg,
                          torch.from_numpy(x), torch.from_numpy(pos), causal=causal,
                          window=window)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
