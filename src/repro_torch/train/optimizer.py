"""AdamW with global-norm clipping and a warmup-cosine schedule.
Counterpart of ``repro/train/optimizer.py``, over a dict of named
parameters instead of a pytree.

The state holds ``m`` and ``v`` in float32 for every parameter (the
parameters keep their dtype) and a 0-d int32 ``step``. The step count, the
learning rate and the bias corrections are float32 tensors, as the
reference computes them in ``jnp``. ``adamw_update`` updates the parameters
and the state in place under ``torch.no_grad()``. ``torch.optim.AdamW`` is
not used: its clipping, schedule and decay term are not the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor), a float32 0-d tensor."""
    step = step.float()
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
                    0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_opt_state(params: dict) -> dict:
    """Zero float32 moments beside each parameter, on its device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = next(iter(params.values())).device
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    total = None
    for x in tensors:
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict):
    """One step: clip the gradients to ``clip_norm`` by their global norm,
    then AdamW with decoupled decay at the scheduled rate. ``params`` and
    ``state`` are updated in place. -> (params, state, metrics)."""
    step = state["step"]
    gnorm = global_norm(grads[k] for k in params)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    n = step.float() + 1
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=n.device), n)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=n.device), n)
    for k, p in params.items():
        g = grads[k].float() * scale
        m, v = state["m"][k], state["v"][k]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        pf = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    state["step"] = step + 1
    return params, state, {"grad_norm": gnorm, "lr": lr}
