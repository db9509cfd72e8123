"""Losses: next-token cross-entropy (decoders), masked-prediction
cross-entropy (encoders) and eps-prediction MSE with CFG condition dropout
(diffusion). Counterpart of ``repro/train/losses.py``.

The reference draws the diffusion loss's timesteps, noise and dropout mask
from a key inside the loss. Here they are inputs (``t``, ``eps``,
``drop``), so that a test can feed the reference's draws, and
``diffusion_draws`` draws them from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch


def _ce(logits, targets, mask=None):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def lm_loss(model, tokens, *, remat: bool = True):
    """Next-token CE over tokens (B, S) through ``model`` (a
    ``Transformer``), plus the stack's MoE load-balance loss (0 without
    experts). -> (loss, metrics).

    The forward runs on the full S; the last position's logits are masked
    out of the loss and its target is the rolled-in first token, as in the
    reference."""
    h, _, aux = model(tokens, remat=remat)
    logits = model.unembed(h)
    B, S = tokens.shape
    mask = (torch.arange(S, device=tokens.device)[None] < S - 1).expand(B, S)
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    loss = _ce(logits, targets, mask)
    return loss + aux, {"ce": loss, "aux": aux}


def masked_prediction_loss(model, features, targets, mask, *, remat: bool = True):
    """HuBERT's objective: the codebook ``targets`` (B, S) at the frames
    where ``mask`` (B, S) bool is True, from ``features`` (B, S, D), frontend
    embeddings already corrupted at those frames. -> (loss, metrics)."""
    h, _, aux = model(features, remat=remat)
    loss = _ce(model.unembed(h), targets, mask)
    return loss + aux, {"ce": loss, "aux": aux}


def diffusion_draws(generator: torch.Generator, batch: int, shape, T: int,
                    cond_drop: float = 0.1):
    """The draws of one diffusion-loss step, on the generator's device:
    timesteps ``t`` (batch,) int64 in [0, T), noise ``eps`` of the latents'
    ``shape`` float32, and the condition-dropout mask ``drop`` (batch,) bool
    with P(True) = ``cond_drop``."""
    dev = generator.device
    t = torch.randint(0, T, (batch,), generator=generator, device=dev)
    eps = torch.randn(tuple(shape), generator=generator, dtype=torch.float32, device=dev)
    drop = torch.rand((batch,), generator=generator, device=dev) < cond_drop
    return t, eps, drop


def diffusion_loss(eps_fn, sched, latents, text_emb, null_emb, *, t, eps, drop):
    """eps-prediction MSE with condition dropout (CFG training). latents
    (B,h,w,c); text_emb, null_emb (B,L,D); ``t`` (B,) timesteps, ``eps``
    noise of the latents' shape, ``drop`` (B,) bool (True: the null text).
    -> (loss, metrics)."""
    ab = torch.as_tensor(sched.alphas_bar, dtype=torch.float32, device=latents.device)[t]
    sa = torch.sqrt(ab)[:, None, None, None]
    sb = torch.sqrt(1 - ab)[:, None, None, None]
    x_t = sa * latents.float() + sb * eps
    text = torch.where(drop[:, None, None], null_emb, text_emb)
    pred = eps_fn(x_t.to(latents.dtype), t, text)
    loss = torch.mean(torch.square(pred.float() - eps))
    return loss, {"mse": loss}
