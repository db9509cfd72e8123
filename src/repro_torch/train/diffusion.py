"""Trains the reduced SD pipeline that the paper's claims are checked on.
Counterpart of ``benchmarks/common.py::trained_pipeline``: the same recipe
(``UNetConfig().reduced()``, the SD noise schedule of 1000 steps, the
shapes dataset from ``default_rng(0)`` in batches of 8, the class prompts'
embeddings against the null prompt's, AdamW at lr 2e-3 with 10 warmup
steps and no decay, 400 steps), in the port.

Only the UNet trains; the text encoder runs once, under ``no_grad``, for the
class prompts and the null prompt. The per-step draws (timesteps, noise,
dropout mask) come from ``draws`` when given, else from a CPU generator
seeded with ``seed``, moved to the device, so that a run on the CPU and one
on the GPU train on the same numbers. ``save_pipeline`` and
``load_pipeline`` keep a pipeline in the reference's checkpoint format and
tree layout, which its ``load_checkpoint`` and ``SDPipeline`` take as they
take ``results/bench_unet_ckpt``. ``claim_distances`` computes the numbers
behind the paper's §3.2 and Fig. 1 claims on a trained pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import UNetConfig
from repro_torch.core.pipeline import SDPipeline
from repro_torch.core.schedules import NoiseSchedule
from repro_torch.core.selective import GuidancePlan
from repro_torch.data.synthetic import CLASS_PROMPTS, shapes_dataset
from repro_torch.train.losses import diffusion_draws, diffusion_loss
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def diffusion_loss_fn(pipe: SDPipeline):
    """The loss of ``loop.make_train_step`` for batches ``(latents (B,h,w,c),
    class ids (B,), t, eps, drop)`` on ``pipe``'s device: the class prompts'
    embeddings, computed once here under ``no_grad``, against the null
    prompt's, through ``pipe.unet``."""
    prompts_emb = pipe.encode_prompts(CLASS_PROMPTS)
    null_emb = pipe.null_embedding(1)

    def loss_fn(_params, batch, _generator):
        lat, cls, t, eps, drop = batch
        text = prompts_emb[cls]
        return diffusion_loss(pipe.unet, pipe.sched, lat, text, null_emb.expand(text.shape),
                              t=t, eps=eps, drop=drop)

    return loss_fn


def train_pipeline(cfg: UNetConfig | None = None, steps: int = 400, *, seed: int = 1,
                   device=None, draws=None, pipe: SDPipeline | None = None):
    """-> (pipeline, losses (steps,) float32 tensor on the CPU).

    ``pipe`` is the pipeline to train, moved to ``device`` (None: the GPU);
    by default ``SDPipeline.init`` from seed 0 on the CPU, as the reference
    starts from ``PRNGKey(0)``. ``draws`` is a sequence of one ``(t, eps,
    drop)`` a step, as ``losses.diffusion_draws`` returns them."""
    cfg = cfg or UNetConfig().reduced()
    dev = resolve_device(device)
    sched = NoiseSchedule.sd_default(1000)
    if pipe is None:
        pipe = SDPipeline.init(cfg, 0, device="cpu", sched=sched)
    pipe = pipe.to(dev)
    pipe.sched = sched
    data = shapes_dataset(np.random.default_rng(0), batch=8, size=cfg.latent_size)
    opt_cfg = AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=steps, weight_decay=0.0)
    step = make_train_step(diffusion_loss_fn(pipe), opt_cfg)
    params = dict(pipe.unet.requires_grad_(True).named_parameters())
    opt = init_opt_state(params)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for i in range(steps):
        lat, cls = next(data)
        drawn = draws[i] if draws is not None else diffusion_draws(
            gen, lat.shape[0], lat.shape, sched.T)
        batch = (torch.from_numpy(lat), torch.from_numpy(cls).long(), *drawn)
        params, opt, metrics = step(params, opt, tuple(torch.as_tensor(b).to(dev)
                                                       for b in batch), None)
        losses.append(metrics["loss"])
    pipe.unet.requires_grad_(False)
    return pipe, torch.stack(losses).cpu()


def save_pipeline(path: str, pipe: SDPipeline, *, step: int = 0) -> None:
    """Writes ``{"params": {"unet": ..., "text": ...}}`` in the reference's
    layout (``convert.to_jax_params``)."""
    save_checkpoint(path, {"params": convert.to_jax_params(pipe.unet, pipe.text)}, step=step)


def load_pipeline(path: str, cfg: UNetConfig | None = None, *, device=None) -> SDPipeline:
    """A pipeline (on ``device``, None meaning the GPU; the SD schedule of
    1000 steps) from a checkpoint that ``save_pipeline`` or the reference's
    ``trained_pipeline`` wrote."""
    tree, _, _ = load_checkpoint(path, device="cpu")
    state = convert.from_jax_params(_numpy_tree(tree["params"]))
    return SDPipeline.from_state(cfg or UNetConfig().reduced(), state, device=device,
                                 sched=NoiseSchedule.sd_default(1000))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [None if v is None else _numpy_tree(v) for v in tree]
    return tree.numpy()


THRESHOLD_CASE = ("a red disc", 11)
WINDOW_PROMPTS, WINDOW_SEEDS = ("a blue square", "a red disc"), (23, 57)
WINDOWS = ((0.0, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))


def claim_distances(pipe: SDPipeline, *, x_init=None) -> dict:
    """The numbers behind the paper's claims as the reference's
    ``tests/test_system.py`` states them, on 20-step plans at scale 5:
    ``d20``/``d80`` the mean square distance of a 20%/80% COND suffix's
    latents from full guidance's ("a red disc", seed 11), ``scale`` the
    mean square of the full-guidance latents, and ``windows`` the mean
    distance of a COND window at each quarter of the steps, over two prompts
    x two seeds. ``x_init(prompt, seed)`` gives initial latents (None: the
    pipeline's own draw from ``seed``). -> {"d20", "d80", "scale",
    "windows"} as floats."""
    def gen(prompt, plan, seed):
        x0 = None if x_init is None else x_init(prompt, seed)
        return pipe.generate([prompt], plan, seed=seed, x_init=x0).float()

    prompt, seed = THRESHOLD_CASE
    base = gen(prompt, GuidancePlan.full(20, 5.0), seed)
    d20 = gen(prompt, GuidancePlan.suffix(20, 0.2, 5.0), seed).sub(base).square().mean()
    d80 = gen(prompt, GuidancePlan.suffix(20, 0.8, 5.0), seed).sub(base).square().mean()
    dists = [0.0] * len(WINDOWS)
    for prompt in WINDOW_PROMPTS:
        for seed in WINDOW_SEEDS:
            base_w = gen(prompt, GuidancePlan.full(20, 5.0), seed)
            for w, (a, b) in enumerate(WINDOWS):
                out = gen(prompt, GuidancePlan.window(20, a, b, 5.0), seed)
                dists[w] += float(out.sub(base_w).square().mean()) / 4
    return {"d20": float(d20), "d80": float(d80), "scale": float(base.square().mean()),
            "windows": dists}
