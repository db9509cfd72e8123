"""The guided Stable-Diffusion-style pipeline: hash tokenizer -> text encoder
-> latent UNet denoiser -> sampler under a :class:`GuidancePlan`.
Counterpart of ``repro/core/pipeline.py``.

Runs on the GPU unless ``device`` says otherwise. Weights are random from
``seed`` (``init``) or converted from the reference (``from_state``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import UNetConfig
from repro_torch.core.sampler import sample
from repro_torch.core.schedules import NoiseSchedule
from repro_torch.core.selective import GuidancePlan
from repro_torch.data.tokenizer import encode_batch
from repro_torch.models import frontends as F
from repro_torch.models.transformer import Encoder
from repro_torch.models.unet import UNet

TEXT_VOCAB = 4096


@dataclass
class SDPipeline:
    cfg: UNetConfig
    unet: UNet
    text: Encoder
    sched: NoiseSchedule
    device: torch.device

    @classmethod
    def init(cls, cfg: UNetConfig, seed: int = 0, *, device=None,
             dtype=torch.float32, sched: NoiseSchedule | None = None):
        """Random weights at the reference's scales, drawn on ``device``
        from a generator seeded with ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tcfg = F.text_encoder_config(TEXT_VOCAB, cfg.text_dim, cfg.text_len)
        return cls(cfg, UNet.init(cfg, gen, dtype=dtype, device=dev),
                   Encoder.init(tcfg, gen, dtype=dtype, device=dev),
                   sched or NoiseSchedule.sd_default(), dev)

    @classmethod
    def from_state(cls, cfg: UNetConfig, state: dict, *, device=None,
                   sched: NoiseSchedule | None = None):
        """From ``{"unet": state_dict, "text": state_dict}``, as
        ``repro_torch.convert.from_jax_params`` returns it."""
        dev = resolve_device(device)
        tcfg = F.text_encoder_config(TEXT_VOCAB, cfg.text_dim, cfg.text_len)
        to = {k: {n: t.to(dev) for n, t in sd.items()} for k, sd in state.items()}
        return cls(cfg, UNet.from_state_dict(cfg, to["unet"]),
                   Encoder.from_state_dict(tcfg, to["text"]),
                   sched or NoiseSchedule.sd_default(), dev)

    def to(self, device) -> "SDPipeline":
        """The same weights on another device."""
        state = {"unet": self.unet.state_dict(), "text": self.text.state_dict()}
        return SDPipeline.from_state(self.cfg, state, device=device, sched=self.sched)

    # -- pieces -------------------------------------------------------------

    def latent_shape(self, batch: int) -> tuple[int, int, int, int]:
        s = self.cfg.latent_size
        return (batch, s, s, self.cfg.in_channels)

    @torch.no_grad()
    def encode_prompts(self, prompts: list[str]):
        toks = encode_batch(prompts, TEXT_VOCAB, self.cfg.text_len)
        return F.encode_text(self.text, torch.from_numpy(toks).long().to(self.device))

    @torch.no_grad()
    def null_embedding(self, batch: int):
        toks = F.null_tokens(batch, self.cfg.text_len, device=self.device)
        return F.encode_text(self.text, toks)

    def eps_fn(self):
        return self.unet

    # -- generation ---------------------------------------------------------

    def generate(self, prompts: list[str], plan: GuidancePlan, *, seed: int = 0,
                 stepper: str = "ddim", eta: float = 0.0, x_init=None, noise=None,
                 **combine_kw):
        """-> latents (B, latent_size, latent_size, C).

        ``x_init`` and ``noise`` (``(T, B, h, w, C)``) inject the initial
        latents and per-step normals; what is not given is drawn from a
        generator seeded with ``seed``. ``combine_kw`` goes to
        :func:`repro_torch.core.sampler.sample` (``combine=``, ``apg_eta=``,
        ``apg_threshold=``, ``apg_momentum=``, ``interval=``)."""
        B = len(prompts)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        cond = self.encode_prompts(prompts)
        uncond = self.null_embedding(B)
        if x_init is None:
            x_init = torch.randn(self.latent_shape(B), generator=gen,
                                 dtype=torch.float32, device=self.device)
        return sample(self.eps_fn(), plan, self.sched, x_init.to(self.device), cond,
                      uncond, stepper=stepper, eta=eta,
                      noise=None if noise is None else noise.to(self.device),
                      generator=gen, **combine_kw)

    def generate_runner(self, plan: GuidancePlan, *, stepper="ddim", eta=0.0,
                        **combine_kw):
        """-> ``run(cond_emb, uncond_emb, x0, noise=None) -> latents``, the
        measured object of the Table-1 protocol (counterpart of
        ``generate_jit``)."""
        eps, sched = self.eps_fn(), self.sched

        def run(cond, uncond, x0, noise=None):
            return sample(eps, plan, sched, x0, cond, uncond, stepper=stepper, eta=eta,
                          noise=noise, **combine_kw)

        return run

    def timed_generate(self, prompts, plan: GuidancePlan, *, seed=0,
                       warmup: int = 2, iters: int = 5, **combine_kw):
        """Paper §3.3 protocol: warm up, then the mean and std of wall time
        over ``iters`` runs, each between two device synchronisations.
        -> (latents, mean_s, std_s)."""
        B = len(prompts)
        cond = self.encode_prompts(prompts)
        uncond = self.null_embedding(B)
        run = self.generate_runner(plan, **combine_kw)
        times, out = [], None
        for i in range(warmup + iters):
            gen = torch.Generator(device=self.device).manual_seed(seed + i)
            x0 = torch.randn(self.latent_shape(B), generator=gen, dtype=torch.float32,
                             device=self.device)
            _sync(self.device)
            t0 = time.perf_counter()
            out = run(cond, uncond, x0)
            _sync(self.device)
            if i >= warmup:
                times.append(time.perf_counter() - t0)
        return out, float(np.mean(times)), float(np.std(times))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
