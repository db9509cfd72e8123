# Copy of repro/data/synthetic.py (framework-free).
"""Synthetic data pipelines (offline container: no real corpora).

* ``lm_batches`` — token streams with learnable k-gram structure (a random
  deterministic transition table), so train loss demonstrably decreases.
* ``shapes_dataset`` — procedural "latents": anti-aliased coloured discs /
  squares / crosses parameterised by a class id; a tiny text prompt maps to
  the class, giving the diffusion pipeline a real conditional structure the
  quality benchmarks can measure against.
"""

from __future__ import annotations

import numpy as np


def lm_batches(rng: np.random.Generator, vocab: int, batch: int, seq: int,
               order: int = 2):
    """Infinite iterator of (batch, seq) int32 token arrays with k-gram
    structure: next token = f(prev ``order`` tokens) 80% of the time."""
    table = rng.integers(0, vocab, size=(vocab,) * order)
    while True:
        out = np.empty((batch, seq), np.int32)
        state = rng.integers(0, vocab, size=(batch, order))
        for t in range(seq):
            follow = rng.random(batch) < 0.8
            nxt = table[tuple(state[:, i] for i in range(order))]
            rand = rng.integers(0, vocab, size=batch)
            tok = np.where(follow, nxt, rand)
            out[:, t] = tok
            state = np.concatenate([state[:, 1:], tok[:, None]], axis=1)
        yield out


N_CLASSES = 8
CLASS_PROMPTS = [
    "a red disc", "a green disc", "a blue square", "a yellow square",
    "a red cross", "a cyan cross", "a green ring", "a magenta ring",
]
_COLORS = np.array([
    [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0],
    [1, 0, 0], [0, 1, 1], [0, 1, 0], [1, 0, 1],
], np.float32)


def render_class(cls: int, size: int, jitter_xy=(0.0, 0.0), scale=1.0):
    """Render one class instance -> (size, size, 4) in [-1, 1] (4 'latent'
    channels: RGB + shape mask)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cx = size / 2 + jitter_xy[0] * size / 4
    cy = size / 2 + jitter_xy[1] * size / 4
    r = size / 4 * scale
    dx, dy = xx - cx, yy - cy
    dist = np.sqrt(dx ** 2 + dy ** 2)
    kind = ["disc", "disc", "square", "square", "cross", "cross", "ring", "ring"][cls]
    if kind == "disc":
        m = np.clip(r - dist, 0, 1)
    elif kind == "square":
        m = np.clip(r - np.maximum(np.abs(dx), np.abs(dy)), 0, 1)
    elif kind == "cross":
        arm = r / 2.5
        m = np.clip(np.maximum(
            np.minimum(arm - np.abs(dx), r - np.abs(dy)),
            np.minimum(arm - np.abs(dy), r - np.abs(dx))), 0, 1)
    else:  # ring
        m = np.clip(r / 4 - np.abs(dist - r), 0, 1)
    img = m[..., None] * _COLORS[cls]
    out = np.concatenate([img, m[..., None]], axis=-1)
    return (out * 2.0 - 1.0).astype(np.float32)


def shapes_dataset(rng: np.random.Generator, batch: int, size: int):
    """Infinite iterator of (latents (B,size,size,4), class_ids (B,))."""
    while True:
        cls = rng.integers(0, N_CLASSES, size=batch)
        jit = rng.uniform(-0.5, 0.5, size=(batch, 2))
        sc = rng.uniform(0.7, 1.3, size=batch)
        lat = np.stack([render_class(int(c), size, tuple(j), float(s))
                        for c, j, s in zip(cls, jit, sc)])
        yield lat, cls.astype(np.int32)


def audio_frames(rng: np.random.Generator, batch: int, frames: int, dim: int,
                 n_units: int = 504):
    """HuBERT-style synthetic: frame features whose class structure matches
    the masked-prediction targets (so the loss is learnable)."""
    units = rng.integers(0, n_units, size=(batch, frames)).astype(np.int32)
    proto = rng.standard_normal((n_units, dim)).astype(np.float32)
    feats = proto[units] + 0.1 * rng.standard_normal((batch, frames, dim)).astype(np.float32)
    mask = rng.random((batch, frames)) < 0.35
    corrupted = np.where(mask[..., None], 0.0, feats)
    return corrupted.astype(np.float32), units, mask
