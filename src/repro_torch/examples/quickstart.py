"""Quickstart: train a tiny guided diffusion model, generate with and
without selective guidance, report the latency saving and image distance.
Counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The pipeline is trained here on every run (``train.diffusion.train_pipeline``,
400 steps by default), where the reference caches its trained checkpoint.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.selective import GuidancePlan
from repro_torch.train.diffusion import train_pipeline

STEPS = 50   # the paper's denoising iteration count


def main(argv=None) -> dict:
    """-> {"saving", "mse", "t_base", "t_opt"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--train-steps", type=int, default=400)
    args = ap.parse_args(argv)

    print("== Selective Guidance quickstart ==")
    print(f"training a tiny conditional latent-diffusion pipeline ({args.train_steps} steps)...")
    pipe, _ = train_pipeline(steps=args.train_steps, device=args.device)

    prompts = ["a red disc", "a blue square"]
    baseline_plan = GuidancePlan.full(STEPS, guidance_scale=7.5)
    paper_plan = GuidancePlan.suffix(STEPS, 0.2, guidance_scale=7.5)

    base, t_base, _ = pipe.timed_generate(prompts, baseline_plan, iters=3)
    opt, t_opt, _ = pipe.timed_generate(prompts, paper_plan, iters=3)

    base, opt = np.asarray(base.float().cpu()), np.asarray(opt.float().cpu())
    mse = float(np.mean((base - opt) ** 2))
    scale = float(np.mean(base ** 2))
    saving = 1 - t_opt / t_base
    exact = 1 - paper_plan.denoiser_passes() / baseline_plan.denoiser_passes()
    print(f"\nbaseline: {t_base:.3f}s   selective(last 20%): {t_opt:.3f}s")
    print(f"measured saving: {saving:.1%}  (exact pass saving: {exact:.1%} of denoiser "
          "passes)")
    print(f"output MSE vs baseline: {mse:.4f} (latent power {scale:.3f})")
    return {"saving": saving, "mse": mse, "t_base": t_base, "t_opt": t_opt}


if __name__ == "__main__":
    main()
