# Copy of repro/core/schedules.py (framework-free).
"""Diffusion noise schedules + timestep spacing."""

from __future__ import annotations

import numpy as np


def linear_beta_schedule(T: int = 1000, beta_start=8.5e-4, beta_end=1.2e-2):
    """SD's scaled-linear schedule."""
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5, T, dtype=np.float64) ** 2


def cosine_beta_schedule(T: int = 1000, s: float = 8e-3):
    t = np.arange(T + 1, dtype=np.float64) / T
    f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
    betas = 1.0 - f[1:] / f[:-1]
    return np.clip(betas, 0.0, 0.999)


class NoiseSchedule:
    def __init__(self, betas: np.ndarray):
        self.betas = betas
        self.alphas = 1.0 - betas
        self.alphas_bar = np.cumprod(self.alphas)
        self.T = len(betas)

    @classmethod
    def sd_default(cls, T: int = 1000):
        return cls(linear_beta_schedule(T))

    def spaced_timesteps(self, num_steps: int) -> np.ndarray:
        """DDIM-style even spacing, descending (t_50 ... t_1)."""
        step = self.T // num_steps
        ts = (np.arange(num_steps) * step + step - 1)[::-1]
        return ts.astype(np.int32)
