"""Training loop: an eager step (loss, gradients, AdamW), a metrics log and
checkpoints. Counterpart of ``repro/train/loop.py``; the reference's
jitted step is an eager one here, and its key is an explicit
``torch.Generator`` handed to the loss."""

from __future__ import annotations

import time
from typing import Callable, Iterator

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig):
    """``loss_fn(params, batch, generator) -> (loss, metrics)``, ``params`` a
    dict of named parameters that require grad. -> ``step(params, opt_state,
    batch, generator) -> (params, opt_state, metrics)``; a parameter the loss
    does not reach gets a zero gradient, as under ``jax.grad``."""

    def step(params, opt_state, batch, generator):
        loss, metrics = loss_fn(params, batch, generator)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads, opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {"loss": loss.detach(), **metrics, **opt_metrics}

    return step


def train(params: dict, loss_fn, batches: Iterator, opt_cfg: AdamWConfig, *,
          num_steps: int, log_every: int = 10, ckpt_dir: str | None = None,
          ckpt_every: int = 0, seed: int = 0, log_fn=print):
    """Runs ``num_steps`` steps on ``params`` (updated in place) with a CPU
    generator seeded with ``seed``. -> (params, opt_state, history), the
    history one dict of floats per logged step."""
    step_fn = make_train_step(loss_fn, opt_cfg)
    opt_state = init_opt_state(params)
    generator = torch.Generator().manual_seed(seed)
    history = []
    t0 = time.perf_counter()
    for i in range(num_steps):
        batch = next(batches)
        params, opt_state, metrics = step_fn(params, opt_state, batch, generator)
        if i % log_every == 0 or i == num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            log_fn(f"step {i:5d} loss {m['loss']:.4f} "
                   f"gnorm {m.get('grad_norm', 0):.3f} lr {m.get('lr', 0):.2e}")
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, {"params": params}, step=i + 1)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, {"params": params}, step=num_steps)
    return params, opt_state, history
