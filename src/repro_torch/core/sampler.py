"""Guided diffusion sampling with phase-split selective guidance.
Counterpart of ``repro/core/sampler.py``.

``sample`` runs a :class:`GuidancePlan` segment by segment: FULL steps run
the denoiser at 2x batch (cond first, uncond second) and combine; COND steps
run it at 1x batch and use the conditional eps directly. The reference runs
one ``lax.scan`` per segment; here each segment is a Python loop.

Combine modes on FULL steps: ``cfg`` (Eq. 1), ``apg`` (optionally with an
EMA of ``c - u`` carried through COND segments) and ``interval`` (the
plan's scale inside ``interval``, 1.0 outside, one scale per row).

Randomness enters as input: ``noise`` is a ``(T, B, h, w, C)`` tensor of
per-step normals for DDPM and DDIM with eta > 0; without it, ``generator``
draws them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.guidance import (apg_combine, cfg_combine, cfg_combine_rowscale,
                                       merge_cond_uncond, split_cond_uncond)
from repro_torch.core.schedules import NoiseSchedule
from repro_torch.core.selective import GuidancePlan, Mode, round_half_up

COMBINE_MODES = ("cfg", "apg", "interval")


def _step_coeffs(sched: NoiseSchedule, num_steps: int):
    """-> (timesteps int32, alpha_bar_t float32, alpha_bar_prev float32), as
    CPU tensors of shape (num_steps,)."""
    ts = sched.spaced_timesteps(num_steps)                     # descending
    ab = sched.alphas_bar
    ab_prev = np.concatenate([ab[ts[1:]], [1.0]])
    return (torch.from_numpy(ts.astype(np.int32)),
            torch.from_numpy(ab[ts].astype(np.float32)),
            torch.from_numpy(ab_prev.astype(np.float32)))


def ddim_update(x, eps, ab_t, ab_prev, *, eta: float = 0.0, noise=None):
    xf, ef = x.float(), eps.float()
    x0 = (xf - torch.sqrt(1.0 - ab_t) * ef) / torch.sqrt(ab_t)
    sigma = eta * torch.sqrt((1 - ab_prev) / (1 - ab_t)) * torch.sqrt(1 - ab_t / ab_prev)
    dir_xt = torch.sqrt(torch.clamp(1.0 - ab_prev - sigma ** 2, min=0.0)) * ef
    out = torch.sqrt(ab_prev) * x0 + dir_xt
    if noise is not None:
        out = out + sigma * noise.float()
    return out.to(x.dtype)


def euler_update(x, eps, ab_t, ab_prev):
    """Euler step on the sigma-space probability-flow ODE."""
    xf, ef = x.float(), eps.float()
    sigma_t = torch.sqrt((1.0 - ab_t) / ab_t)
    sigma_prev = torch.sqrt(torch.clamp((1.0 - ab_prev) / ab_prev, min=0.0))
    x_sig = xf / torch.sqrt(ab_t)
    x_sig = x_sig + (sigma_prev - sigma_t) * ef
    return (x_sig * torch.sqrt(ab_prev)).to(x.dtype)


def ddpm_update(x, eps, ab_t, ab_prev, noise):
    xf, ef = x.float(), eps.float()
    alpha_t = ab_t / ab_prev
    beta_t = 1.0 - alpha_t
    mean = (xf - beta_t / torch.sqrt(1.0 - ab_t) * ef) / torch.sqrt(alpha_t)
    sigma = torch.sqrt(beta_t * (1.0 - ab_prev) / (1.0 - ab_t))
    return (mean + sigma * noise.float()).to(x.dtype)


class _Loop:
    """What every step of one sampling run shares: coefficients, text
    batches, the stepper and the source of per-step noise."""

    def __init__(self, eps_fn, plan, sched, x_init, cond_emb, uncond_emb, *,
                 stepper, eta, noise, generator):
        if stepper not in ("ddim", "euler", "ddpm"):
            raise ValueError(stepper)
        self.eps_fn = eps_fn
        ts, self.ab_t, self.ab_prev = _step_coeffs(sched, plan.total_steps)
        # timesteps live on the device (indexing them never waits on it); the
        # float32 coefficients stay CPU scalars, passed to kernels by value
        self.ts = ts.to(x_init.device)
        self.B = x_init.shape[0]
        self.cond_emb = cond_emb
        self.text2 = merge_cond_uncond(cond_emb, uncond_emb)
        self.stepper, self.eta = stepper, eta
        self.stochastic = stepper == "ddpm" or (stepper == "ddim" and eta > 0.0)
        if self.stochastic and noise is None and generator is None:
            raise ValueError("ddpm / eta>0 needs noise or a generator")
        if noise is not None and noise.shape != (plan.total_steps, *x_init.shape):
            raise ValueError(f"noise {tuple(noise.shape)} for {plan.total_steps} "
                             f"steps of {tuple(x_init.shape)}")
        self.noise, self.generator = noise, generator

    def _noise(self, x, i):
        if not self.stochastic:
            return None
        if self.noise is not None:
            return self.noise[i].to(x.device)
        return torch.randn(x.shape, generator=self.generator, dtype=torch.float32,
                           device=x.device)

    def update(self, x, eps, i):
        ab_t, ab_prev, noise = self.ab_t[i], self.ab_prev[i], self._noise(x, i)
        if self.stepper == "ddim":
            return ddim_update(x, eps, ab_t, ab_prev, eta=self.eta, noise=noise)
        if self.stepper == "euler":
            return euler_update(x, eps, ab_t, ab_prev)
        return ddpm_update(x, eps, ab_t, ab_prev, noise)

    def full_eps(self, x, i):
        """-> (eps_cond, eps_uncond) from one 2x-batch denoiser pass."""
        t2 = self.ts[i].expand(2 * self.B)
        return split_cond_uncond(self.eps_fn(merge_cond_uncond(x, x), t2, self.text2))

    def cond_step(self, x, i):
        t1 = self.ts[i].expand(self.B)
        return self.update(x, self.eps_fn(x, t1, self.cond_emb), i)


def _interval_scales(plan: GuidancePlan, interval, B: int, device):
    """Per-step (B,) float32 scales: the plan's inside [start, stop), 1.0
    outside. The reference computes ``u + 1.0 * (c - u)`` outside, not a
    short-circuit, and so does the rowscale kernel."""
    iv = (0.0, 1.0) if interval is None else interval
    a = round_half_up(plan.total_steps * iv[0])
    b = round_half_up(plan.total_steps * iv[1])
    s = plan.guidance_scale
    return lambda i: torch.full((B,), s if a <= i < b else 1.0,
                                dtype=torch.float32, device=device)


@torch.no_grad()
def sample(
    eps_fn: Callable,            # (latents (N,...), t (N,), text (N,L,D)) -> eps
    plan: GuidancePlan,
    sched: NoiseSchedule,
    x_init,                      # (B, h, w, c) initial noise
    cond_emb,                    # (B, L, D)
    uncond_emb,                  # (B, L, D)
    *,
    stepper: str = "ddim",
    eta: float = 0.0,
    noise=None,                  # (T, B, h, w, c) per-step normals, or None
    generator: torch.Generator | None = None,
    combine: str = "cfg",
    apg_eta: float = 0.0,
    apg_threshold: float = 0.0,
    apg_momentum: float = 0.0,
    interval: tuple[float, float] | None = None,
):
    """Run the guided denoising loop under ``plan``. Returns final latents."""
    if combine not in COMBINE_MODES:
        raise ValueError(f"combine {combine!r} not in {COMBINE_MODES}")
    loop = _Loop(eps_fn, plan, sched, x_init, cond_emb, uncond_emb, stepper=stepper,
                 eta=eta, noise=noise, generator=generator)
    s = plan.guidance_scale
    momentum = combine == "apg" and apg_momentum != 0.0
    # the APG EMA flows untouched through COND segments: the uncond stream
    # is dead there, not the memory of it
    avg = torch.zeros(x_init.shape, dtype=torch.float32, device=x_init.device) \
        if momentum else None
    step_scales = _interval_scales(plan, interval, loop.B, x_init.device) \
        if combine == "interval" else None

    x = x_init
    for seg in plan.segments:
        for i in range(seg.start, seg.stop):
            if seg.mode is Mode.COND:
                x = loop.cond_step(x, i)
                continue
            e_c, e_u = loop.full_eps(x, i)
            if combine == "cfg":
                eps = cfg_combine(e_u, e_c, s)
            elif combine == "interval":
                eps = cfg_combine_rowscale(e_u, e_c, step_scales(i))
            else:
                if momentum:
                    avg = (e_c.float() - e_u.float()) + apg_momentum * avg
                eps = apg_combine(e_u, e_c, s, eta=apg_eta, threshold=apg_threshold,
                                  diff=avg)
            x = loop.update(x, eps, i)
    return x


@torch.no_grad()
def sample_trajectory(eps_fn, plan, sched, x_init, cond_emb, uncond_emb, *,
                      stepper="ddim", eta=0.0, noise=None, generator=None):
    """As ``sample`` with ``combine="cfg"`` (the reference's segment runner
    takes no combine options), also returning the latents at every segment
    boundary."""
    loop = _Loop(eps_fn, plan, sched, x_init, cond_emb, uncond_emb, stepper=stepper,
                 eta=eta, noise=noise, generator=generator)
    xs = [x_init]
    x = x_init
    for seg in plan.segments:
        for i in range(seg.start, seg.stop):
            if seg.mode is Mode.COND:
                x = loop.cond_step(x, i)
            else:
                e_c, e_u = loop.full_eps(x, i)
                x = loop.update(x, cfg_combine(e_u, e_c, plan.guidance_scale), i)
        xs.append(x)
    return x, xs
