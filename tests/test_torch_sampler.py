"""The port's sampler against ``repro.core.sampler.sample`` on the reduced
UNet (converted weights), with the reference's text embeddings and the same
initial latents and per-step noise injected.

Tolerance: both sides run the UNet and the updates in float32; summation
order differs and guidance at s = 7.5 amplifies it over the steps, so
1e-4 of the largest latent.
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

STEPS = 6
COMBINES = {
    "cfg": dict(combine="cfg"),
    "apg": dict(combine="apg", apg_eta=0.3, apg_threshold=2.0),
    "apg_momentum": dict(combine="apg", apg_momentum=0.5, apg_eta=0.2),
    "interval": dict(combine="interval", interval=(0.2, 0.7)),
}
STEPPERS = {"ddim": dict(stepper="ddim"), "ddim_eta": dict(stepper="ddim", eta=0.5),
            "euler": dict(stepper="euler"), "ddpm": dict(stepper="ddpm")}


@pytest.fixture(scope="module")
def setup():
    jp = JPipe.init(JUNetConfig().reduced(), jax.random.PRNGKey(0), sched=JSched.sd_default(100))
    tree = jax.tree.map(np.asarray, jp.params)
    tp = SDPipeline.from_state(UNetConfig().reduced(), convert.from_jax_params(tree),
                               device="cpu", sched=NoiseSchedule.sd_default(100))
    cond, uncond = jp.encode_prompts(["a red disc", "a green ring"]), jp.null_embedding(2)
    x0 = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(np.float32)
    return jp, tp, cond, uncond, x0


def _noise(rng, T, shape):
    """The reference's per-step normals: ``normal(fold_in(rng, i))``."""
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, i), shape,
                                                  jnp.float32)) for i in range(T)])


def _counting(eps_fn, B, passes):
    def fn(x, t, text):
        passes.append(x.shape[0] // B)
        return eps_fn(x, t, text)
    return fn


@pytest.mark.parametrize("stepper", list(STEPPERS))
@pytest.mark.parametrize("combine", list(COMBINES))
def test_sample_matches_reference(setup, stepper, combine):
    jp, tp, cond, uncond, x0 = setup
    jplan = jsel.GuidancePlan.suffix(STEPS, 0.34, 7.5)
    tplan = tsel.GuidancePlan.suffix(STEPS, 0.34, 7.5)
    kw = dict(STEPPERS[stepper], **COMBINES[combine])
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(JS.sample(jp.eps_fn(), jplan, jp.sched, jnp.asarray(x0), cond, uncond,
                               rng=rng, **kw))
    passes = []
    out = TS.sample(_counting(tp.eps_fn(), 2, passes), tplan, tp.sched, torch.from_numpy(x0),
                    convert.to_tensor(np.asarray(cond)), convert.to_tensor(np.asarray(uncond)),
                    noise=torch.from_numpy(_noise(rng, STEPS, x0.shape)), **kw)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert sum(passes) == jplan.denoiser_passes() == tplan.denoiser_passes()
