"""The port's pipeline against ``repro.core.pipeline.SDPipeline``: weight
conversion, segment-boundary trajectories and the whole ``generate``.

Tolerances: conversion is exact. Trajectories take the reference's
embeddings, so 1e-4 of the largest latent (float32 summation order,
amplified by guidance). The whole ``generate`` also encodes the prompts,
whose bf16 encoder may differ by a few bf16 steps from the reference's
scanned one (see test_torch_models.py), so 2e-2 of the largest latent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import UNetConfig as JUNetConfig
from repro.core import sampler as JS
from repro.core import selective as jsel
from repro.core.pipeline import SDPipeline as JPipe
from repro.core.schedules import NoiseSchedule as JSched
from repro_torch import convert
from repro_torch.configs.base import UNetConfig
from repro_torch.core import sampler as TS
from repro_torch.core import selective as tsel
from repro_torch.core.pipeline import SDPipeline
from repro_torch.core.schedules import NoiseSchedule
from repro_torch.kernels import cfg_combine as K


@pytest.fixture(scope="module")
def pair():
    jp = JPipe.init(JUNetConfig().reduced(), jax.random.PRNGKey(0), sched=JSched.sd_default(100))
    tree = jax.tree.map(np.asarray, jp.params)
    tp = SDPipeline.from_state(UNetConfig().reduced(), convert.from_jax_params(tree),
                               device="cpu", sched=NoiseSchedule.sd_default(100))
    return jp, tp


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tensor_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_convert_round_trips_bit_exact(dtype):
    cfg = UNetConfig().reduced()
    jp = JPipe.init(JUNetConfig().reduced(), jax.random.PRNGKey(1), dtype=dtype)
    tree = jax.tree.map(np.asarray, jp.params)
    tp = SDPipeline.from_state(cfg, convert.from_jax_params(tree), device="cpu")
    for module, items in ((tp.unet, convert.unet_items(tree["unet"])),
                          (tp.text, convert.text_items(tree["text"]))):
        state = module.state_dict()
        expected = dict(items)
        assert set(state) == set(expected)
        for key, a in expected.items():
            t = state[key]
            assert str(t.dtype).split(".")[-1] == a.dtype.name, key
            assert tuple(t.shape) == a.shape, key
            np.testing.assert_array_equal(_tensor_bits(t), _bits(a), err_msg=key)
    # the layout changes are the only ones: HWIO convs, stacked encoder layers
    w = tree["unet"]["conv_in"]["w"]
    np.testing.assert_array_equal(_tensor_bits(tp.unet.conv_in.w),
                                  _bits(np.transpose(w, (3, 2, 0, 1))))
    stacked = tree["text"]["segments"][0][0]["attn"]["wq"]
    for i in range(stacked.shape[0]):
        np.testing.assert_array_equal(_tensor_bits(tp.text.layers[i].attn.wq),
                                      _bits(stacked[i]))


def test_sample_trajectory_boundaries_match(pair):
    jp, tp = pair
    cond, uncond = jp.encode_prompts(["a red cross"]), jp.null_embedding(1)
    x0 = np.random.default_rng(3).standard_normal((1, 8, 8, 4)).astype(np.float32)
    jplan = jsel.GuidancePlan.window(8, 0.25, 0.5, 5.0)
    tplan = tsel.GuidancePlan.window(8, 0.25, 0.5, 5.0)
    ref, ref_xs = JS.sample_trajectory(jp.eps_fn(), jplan, jp.sched, jnp.asarray(x0),
                                       cond, uncond)
    out, xs = TS.sample_trajectory(tp.eps_fn(), tplan, tp.sched, torch.from_numpy(x0),
                                   convert.to_tensor(np.asarray(cond)),
                                   convert.to_tensor(np.asarray(uncond)))
    assert len(xs) == len(ref_xs) == len(tplan.segments) + 1
    for a, b in zip(xs, ref_xs):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())
    np.testing.assert_array_equal(out.numpy(), xs[-1].numpy())


@pytest.mark.parametrize("stepper", ["ddim", "ddpm"])
def test_generate_matches_reference(pair, stepper):
    jp, tp = pair
    prompts, seed, B = ["a red disc", "a magenta ring"], 3, 2
    jplan = jsel.GuidancePlan.suffix(6, 0.5, 4.0)
    tplan = tsel.GuidancePlan.suffix(6, 0.5, 4.0)
    ref = np.asarray(jp.generate(prompts, jplan, seed=seed, stepper=stepper))
    rng = jax.random.PRNGKey(seed)
    shape = (B, 8, 8, 4)
    x0 = np.asarray(jax.random.normal(jax.random.fold_in(rng, 1), shape, jnp.float32))
    step_rng = jax.random.fold_in(rng, 2)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(step_rng, i), shape,
                                                   jnp.float32)) for i in range(6)])
    K.reset_launches()
    out = tp.generate(prompts, tplan, stepper=stepper, x_init=torch.from_numpy(x0),
                      noise=torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-2 * np.abs(ref).max())
    assert sum(K.LAUNCHES.values()) == 0               # CPU tensors take plain paths


def test_generate_scale_one_selective_exact(pair):
    """At s = 1 a COND suffix gives the FULL plan's latents. The combine's
    s == 1 short-circuit is exact (see
    ``test_cfg_combine_scale_one_returns_cond_itself``); what differs is the
    UNet pass at 2x batch (FULL) against 1x (COND), whose convolution
    algorithms may differ, so within 1e-4 relative and 1e-5 absolute."""
    _, tp = pair
    base = tp.generate(["a green ring"], tsel.GuidancePlan.full(6, 1.0), seed=1)
    sel = tp.generate(["a green ring"], tsel.GuidancePlan.suffix(6, 0.5, 1.0), seed=1)
    np.testing.assert_allclose(base.numpy(), sel.numpy(), rtol=1e-4, atol=1e-5)


def test_generate_draws_from_seed_and_runner_agrees(pair):
    _, tp = pair
    plan = tsel.GuidancePlan.suffix(4, 0.5, 3.0)
    a = tp.generate(["a red disc"], plan, seed=5)
    b = tp.generate(["a red disc"], plan, seed=5)
    assert torch.equal(a, b) and a.shape == (1, 8, 8, 4)
    x0 = torch.randn(tp.latent_shape(1), generator=torch.Generator().manual_seed(5))
    run = tp.generate_runner(plan)
    out = run(tp.encode_prompts(["a red disc"]), tp.null_embedding(1), x0)
    assert torch.equal(out, a)
    with pytest.raises(ValueError):
        run(tp.encode_prompts(["x"]), tp.null_embedding(1), x0,
            noise=torch.zeros(3, 1, 8, 8, 4))


def test_timed_generate_protocol(pair):
    _, tp = pair
    out, mean_s, std_s = tp.timed_generate(["x"], tsel.GuidancePlan.suffix(4, 0.5, 3.0),
                                           warmup=1, iters=2)
    assert out.shape == (1, 8, 8, 4) and mean_s > 0 and std_s >= 0
