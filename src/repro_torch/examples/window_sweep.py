"""The paper's Figure 1 and Figure 2 sweeps on the tiny pipeline: slide the
optimization window (Fig. 1) and grow the suffix fraction (Fig. 2), saving
a contact sheet per sweep. Counterpart of ``examples/window_sweep.py``.

    PYTHONPATH=src python -m repro_torch.examples.window_sweep [--device cpu]

The sheets are binary PPM images written from numpy (the reference writes
PNGs through PIL): ``results/fig1_window_sweep.ppm`` and
``results/fig2_fraction_sweep.ppm`` under ``--out-dir``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.core.selective import GuidancePlan
from repro_torch.train.diffusion import train_pipeline

STEPS = 50
TILE = 96


def to_img(lat) -> np.ndarray:
    """(h, w, 4) latent in [-1, 1] -> (96, 96, 3) uint8 RGB, the mask channel
    dropped, nearest-neighbour resized."""
    a = np.clip((np.asarray(lat[..., :3].float().cpu()) + 1) / 2, 0, 1)
    h, w = a.shape[:2]
    rows = np.arange(TILE) * h // TILE
    cols = np.arange(TILE) * w // TILE
    return (a[rows][:, cols] * 255).astype(np.uint8)


def sheet(images: list, path: str) -> np.ndarray:
    """Side by side, written as a binary PPM (P6). -> the sheet."""
    out = np.concatenate(images, axis=1)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (out.shape[1], out.shape[0]))
        f.write(out.tobytes())
    print("wrote", path)
    return out


def main(argv=None) -> dict:
    """-> {path: sheet (H, W, 3) uint8}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--train-steps", type=int, default=400)
    ap.add_argument("--out-dir", default="results")
    args = ap.parse_args(argv)

    pipe, _ = train_pipeline(steps=args.train_steps, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    prompt = ["a red disc"]
    sheets = {}

    # Fig. 1: same budget (25%), window slides right; leftmost = earliest
    imgs = []
    for a, b in [(0.0, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0)]:
        lat = pipe.generate(prompt, GuidancePlan.window(STEPS, a, b, 7.5), seed=0)
        imgs.append(to_img(lat[0]))
    path = os.path.join(args.out_dir, "fig1_window_sweep.ppm")
    sheets[path] = sheet(imgs, path)

    # Fig. 2: baseline then last-20/30/40/50% optimized
    imgs = [to_img(pipe.generate(prompt, GuidancePlan.full(STEPS, 7.5), seed=0)[0])]
    for f in [0.2, 0.3, 0.4, 0.5]:
        lat = pipe.generate(prompt, GuidancePlan.suffix(STEPS, f, 7.5), seed=0)
        imgs.append(to_img(lat[0]))
    path = os.path.join(args.out_dir, "fig2_fraction_sweep.ppm")
    sheets[path] = sheet(imgs, path)
    return sheets


if __name__ == "__main__":
    main()
