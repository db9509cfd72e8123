"""The paper's claims (``tests/test_system.py``'s pass accounting, 20%
threshold and Fig. 1 window ordering) on a reduced SD pipeline that the
port trains itself with ``train_pipeline``, twice:

* from the reference's initial weights (``PRNGKey(0)``, converted), on the
  reference's 400 steps of draws (its ``jax.random.split`` chain from
  ``PRNGKey(1)``, repeated here), generating from the reference's initial
  latents (``fold_in(PRNGKey(seed), 1)``): the reference's recipe, step for
  step;
* from ``train_pipeline``'s own defaults (its CPU-generator init and
  draws) and the port's own latent draws: what ``chip_smoke.py`` runs on
  the card.

Each pipeline is saved through the port's checkpoint io into a temporary
directory and reloaded before the claims (never into ``results/``, which
``test_system.py`` writes). The claims are the reference's inequalities, no
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import UNetConfig as JUNetConfig
from repro.core.pipeline import SDPipeline as JPipe
from repro.core.schedules import NoiseSchedule as JSched
from repro_torch import convert
from repro_torch.configs.base import UNetConfig
from repro_torch.core import sampler as TS
from repro_torch.core.pipeline import SDPipeline
from repro_torch.core.selective import GuidancePlan
from repro_torch.kernels import cfg_combine as KC
from repro_torch.train import diffusion as TD

STEPS = 400


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Training runs thousands of small ops: on a machine shared by several
    test workers, torch's thread pool spends more time waiting than
    computing, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_draws(steps: int, batch: int, shape, T: int):
    """The reference trainer's per-step (t, eps, drop): ``key = PRNGKey(1)``,
    ``key, sub = split(key)`` a step, then ``diffusion_loss``'s own
    ``split(sub, 3)`` and draws."""
    key, out = jax.random.PRNGKey(1), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k_t, k_eps, k_drop = jax.random.split(sub, 3)
        t = jax.random.randint(k_t, (batch,), 0, T)
        eps = jax.random.normal(k_eps, shape, jnp.float32)
        drop = jax.random.bernoulli(k_drop, 0.1, (batch,))
        out.append(tuple(torch.from_numpy(np.array(a)) for a in (t, eps, drop)))
    return out


def reference_init(cfg) -> SDPipeline:
    jp = JPipe.init(JUNetConfig().reduced(), jax.random.PRNGKey(0), sched=JSched.sd_default(1000))
    state = convert.from_jax_params(jax.tree.map(np.asarray, jp.params))
    return SDPipeline.from_state(cfg, state, device="cpu")


def reference_x0(prompt, seed):
    cfg = UNetConfig().reduced()
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.in_channels)
    x0 = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(seed), 1), shape, jnp.float32)
    return torch.from_numpy(np.asarray(x0))


def _trained(tmp_path_factory, name, **kw):
    pipe, losses = TD.train_pipeline(UNetConfig().reduced(), STEPS, device="cpu", **kw)
    path = str(tmp_path_factory.mktemp(name) / "ckpt")
    TD.save_pipeline(path, pipe, step=STEPS)
    loaded = TD.load_pipeline(path, device="cpu")
    for a, b in zip(pipe.unet.state_dict().values(), loaded.unet.state_dict().values()):
        assert torch.equal(a, b)
    return loaded, losses


@pytest.fixture(scope="module", params=["reference_draws", "own_draws"])
def trained(request, tmp_path_factory):
    cfg = UNetConfig().reduced()
    if request.param == "reference_draws":
        shape = (8, cfg.latent_size, cfg.latent_size, cfg.in_channels)
        pipe, losses = _trained(tmp_path_factory, request.param, pipe=reference_init(cfg),
                                draws=reference_draws(STEPS, 8, shape, 1000))
        return pipe, losses, reference_x0
    pipe, losses = _trained(tmp_path_factory, request.param)
    return pipe, losses, None


@pytest.fixture(scope="module")
def claims(trained):
    pipe, _, x_init = trained
    out = TD.claim_distances(pipe, x_init=x_init)
    print(f"claims ({'reference' if x_init else 'own'} draws): {out}")
    return out


def test_training_converged(trained):
    _, losses, _ = trained
    assert losses.shape == (STEPS,) and bool(torch.isfinite(losses).all())
    assert float(losses[-50:].mean()) < 0.5 * float(losses[:10].mean())


def test_pass_accounting(trained, monkeypatch):
    """40 and 36 UNet passes (rows of the batch) for full guidance and a 20%
    COND suffix, counted around the UNet, and one Eq. 1 combine a FULL
    step."""
    pipe = trained[0]
    base, sel = GuidancePlan.full(20, 5.0), GuidancePlan.suffix(20, 0.2, 5.0)
    assert (base.denoiser_passes(), sel.denoiser_passes()) == (40, 36)
    assert sel.predicted_saving(1.0) == pytest.approx(0.10)
    unet, rows, combines = pipe.unet, [], []

    def counted(u, c, s):
        combines.append(1)
        return KC.cfg_combine(u, c, s)

    class Counted(torch.nn.Module):
        def forward(self, x, t, text):
            rows.append(x.shape[0])
            return unet(x, t, text)

    monkeypatch.setattr(pipe, "unet", Counted())
    monkeypatch.setattr(TS, "cfg_combine", counted)
    for plan, passes, full in ((base, 40, 20), (sel, 36, 16)):
        rows.clear()
        combines.clear()
        pipe.generate(["a red disc"], plan, seed=11)
        assert sum(rows) == passes and len(combines) == full


def test_paper_threshold_20pct(claims):
    assert claims["d20"] < claims["d80"]
    assert claims["d20"] < 0.25 * claims["scale"]


def test_fig1_window_ordering(claims):
    dists = np.asarray(claims["windows"])
    assert np.mean(dists[2:]) < np.mean(dists[:2])
    assert np.argmax(dists) == 0
