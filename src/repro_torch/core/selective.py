"""Selective guidance plans: which denoising steps run FULL (cond + uncond,
Eq. 1) and which run COND only. Copy of ``repro/core/selective.py``."""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from typing import Iterable


def round_half_up(x: float) -> int:
    """``floor(x + 0.5)``: plain half-up rounding for step boundaries.

    Python's ``round()`` does banker's rounding (``round(2.5) == 2`` but
    ``round(3.5) == 4``), which makes ``optimized_steps`` jump unevenly
    across a Table-1 fraction sweep.  Half-up keeps the boundary monotone
    in the fraction.
    """
    return math.floor(x + 0.5)


class Mode(str, Enum):
    FULL = "full"
    COND = "cond"


@dataclass(frozen=True)
class Segment:
    start: int       # first step index (inclusive)
    stop: int        # last step index (exclusive)
    mode: Mode

    @property
    def length(self) -> int:
        return self.stop - self.start


@dataclass(frozen=True)
class GuidancePlan:
    total_steps: int
    segments: tuple[Segment, ...]
    guidance_scale: float = 7.5

    def __post_init__(self):
        cursor = 0
        for seg in self.segments:
            if seg.start != cursor or seg.stop <= seg.start:
                raise ValueError(f"non-contiguous plan: {self.segments}")
            cursor = seg.stop
        if cursor != self.total_steps:
            raise ValueError(f"plan covers {cursor} of {self.total_steps} steps")

    # ---- factories -------------------------------------------------------

    @staticmethod
    def full(total_steps: int, guidance_scale: float = 7.5) -> "GuidancePlan":
        """The unoptimized baseline."""
        return GuidancePlan(total_steps,
                            (Segment(0, total_steps, Mode.FULL),),
                            guidance_scale)

    @staticmethod
    def suffix(total_steps: int, fraction: float,
               guidance_scale: float = 7.5) -> "GuidancePlan":
        """The paper's policy: optimize the last ``fraction`` of iterations."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(fraction)
        n_opt = round_half_up(total_steps * fraction)
        segs = []
        if total_steps - n_opt:
            segs.append(Segment(0, total_steps - n_opt, Mode.FULL))
        if n_opt:
            segs.append(Segment(total_steps - n_opt, total_steps, Mode.COND))
        return GuidancePlan(total_steps, tuple(segs), guidance_scale)

    @staticmethod
    def window(total_steps: int, start_frac: float, stop_frac: float,
               guidance_scale: float = 7.5) -> "GuidancePlan":
        """Figure-1 ablation: optimization window anywhere in the loop."""
        a = round_half_up(total_steps * start_frac)
        b = round_half_up(total_steps * stop_frac)
        if not 0 <= a < b <= total_steps:
            raise ValueError((start_frac, stop_frac))
        segs = []
        if a:
            segs.append(Segment(0, a, Mode.FULL))
        segs.append(Segment(a, b, Mode.COND))
        if b < total_steps:
            segs.append(Segment(b, total_steps, Mode.FULL))
        return GuidancePlan(total_steps, tuple(segs), guidance_scale)

    # ---- properties ------------------------------------------------------

    @property
    def optimized_steps(self) -> int:
        return sum(s.length for s in self.segments if s.mode is Mode.COND)

    @property
    def optimized_fraction(self) -> float:
        return self.optimized_steps / self.total_steps

    @property
    def is_suffix(self) -> bool:
        """True iff COND steps form a (possibly empty) suffix."""
        seen_cond = False
        for seg in self.segments:
            if seg.mode is Mode.COND:
                seen_cond = True
            elif seen_cond:
                return False
        return True

    def modes(self) -> list[Mode]:
        out = []
        for seg in self.segments:
            out.extend([seg.mode] * seg.length)
        return out

    def denoiser_passes(self) -> int:
        """Total denoiser forward passes (in units of 1x-batch)."""
        return sum(2 * s.length if s.mode is Mode.FULL else s.length
                   for s in self.segments)

    def predicted_saving(self, denoiser_share: float = 1.0) -> float:
        """Analytic latency-saving model: f * 0.5 * U (paper §3.3)."""
        return self.optimized_fraction * 0.5 * denoiser_share

    def validate_for_ar(self) -> None:
        if not self.is_suffix:
            raise ValueError(
                "autoregressive guided decoding requires a suffix plan: the "
                "unconditional KV cache goes stale once skipped "
                "(DESIGN.md §2)")


def sweep(total_steps: int, fractions: Iterable[float],
          guidance_scale: float = 7.5) -> list[GuidancePlan]:
    """Table-1 sweep: one plan per optimized fraction."""
    return [GuidancePlan.suffix(total_steps, f, guidance_scale) for f in fractions]


@dataclass
class PlanCursor:
    """A request's live position inside its :class:`GuidancePlan`.

    The serving scheduler (``repro.serve``) schedules *denoiser-pass slots*,
    not requests: a step in a FULL segment costs 2 passes, a COND step costs
    1. The cursor is the per-request source of truth for that cost — it
    walks the plan one step per engine tick, so two requests admitted at
    different times sit at different phases of different plans and the
    scheduler can co-pack them against one pass budget.
    """

    plan: GuidancePlan
    step: int = 0
    passes_executed: int = 0

    def __post_init__(self):
        if not 0 <= self.step <= self.plan.total_steps:
            raise ValueError(f"cursor step {self.step} outside plan "
                             f"[0, {self.plan.total_steps}]")

    @staticmethod
    def for_request(total_steps: int, fraction: float,
                    guidance_scale: float) -> "PlanCursor":
        """Suffix-plan cursor (the only AR-legal shape, DESIGN.md §2)."""
        plan = GuidancePlan.suffix(total_steps, fraction, guidance_scale)
        plan.validate_for_ar()
        return PlanCursor(plan)

    @property
    def done(self) -> bool:
        return self.step >= self.plan.total_steps

    @property
    def mode(self) -> Mode:
        """Mode of the *next* step to execute."""
        if self.done:
            raise ValueError("cursor exhausted")
        for seg in self.plan.segments:
            if seg.start <= self.step < seg.stop:
                return seg.mode
        raise AssertionError("unreachable: plans are contiguous")

    @property
    def cost(self) -> int:
        """Denoiser passes the next step will consume (FULL=2, COND=1)."""
        return 2 if self.mode is Mode.FULL else 1

    @property
    def at_transition(self) -> bool:
        """True when the next step changes mode vs the previous one —
        the scheduler re-packs the batch on these boundaries."""
        if self.step == 0 or self.done:
            return False
        return self.mode is not self._mode_at(self.step - 1)

    def _mode_at(self, i: int) -> Mode:
        for seg in self.plan.segments:
            if seg.start <= i < seg.stop:
                return seg.mode
        raise IndexError(i)

    def remaining_passes(self) -> int:
        return sum(2 * (min(s.stop, self.plan.total_steps) - max(s.start, self.step))
                   if s.mode is Mode.FULL
                   else (s.stop - max(s.start, self.step))
                   for s in self.plan.segments if s.stop > self.step)

    def advance(self) -> Mode:
        """Execute the current step: record its cost, move on, return the
        mode that was executed."""
        mode = self.mode                     # raises if exhausted
        self.passes_executed += 2 if mode is Mode.FULL else 1
        self.step += 1
        return mode
