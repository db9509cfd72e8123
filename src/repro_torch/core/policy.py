# Copy of repro/core/policy.py (framework-free).
"""Dynamic guidance policies: data-dependent FULL→COND switching.

The paper fixes the FULL→COND switch at a static step fraction
(:meth:`GuidancePlan.suffix`).  The related work makes it adaptive: "How
Much To Guide" (arxiv 2506.08351) adapts guidance per step from runtime
signals, and Kynkäänniemi et al. (arxiv 2404.07724) restrict guidance to a
step interval.  This module packages both behind one interface the serving
stack can plan against (DESIGN.md §15):

* a :class:`GuidancePolicy` owns a static **bound plan** — a guaranteed
  upper bound on FULL steps that admission, page reservation and the
  roofline pass-budget autotuner price against (``max_full_steps()``); and
* a cursor factory whose cursors realize the *actual* schedule at runtime,
  never exceeding the bound.

``static`` reproduces today's suffix plans bit for bit (the cursor IS a
plain :class:`PlanCursor`).  ``interval`` (2404.07724) is structurally
static in its pass schedule — FULL until the interval's stop fraction, COND
after — but carries a per-step *effective scale* (1.0 outside the interval)
for the combine stage.  ``divergence`` switches mid-flight: it feeds the
per-step cond/uncond divergence norm through an EMA
:class:`MomentumBuffer` (cf. the APG momentum buffer, arxiv 2410.02416)
and drops the uncond stream as soon as the smoothed divergence falls below
a threshold — the two streams have converged, so guidance no longer buys
anything.  ``replay`` re-enacts a recorded switch step; it is how the
offline simulator reproduces an engine run event for event without a model.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.selective import (GuidancePlan, Mode, PlanCursor, Segment,
                                  round_half_up)

#: Policy names the serving stack accepts (``replay`` is sim/test-only —
#: it needs a recorded switch step, which live traffic does not have).
GUIDANCE_POLICIES = ("static", "divergence", "interval")


@dataclass
class MomentumBuffer:
    """EMA accumulator (APG, arxiv 2410.02416): ``avg = v + m * avg``."""

    momentum: float = 0.0
    running_average: float = 0.0

    def update(self, value: float) -> float:
        self.running_average = float(value) + self.momentum * self.running_average
        return self.running_average


@dataclass
class DynamicPlanCursor(PlanCursor):
    """A :class:`PlanCursor` whose FULL→COND switch can move *earlier* than
    the plan's static boundary, never later.

    The plan is the bound plan: every step the plan marks COND stays COND.
    Once ``switch_step`` is set (by :meth:`observe` or restored from a
    preemption checkpoint), every step at or past it runs COND regardless
    of the plan.  Because :meth:`PlanCursor.advance`, ``cost`` and the
    scheduler's ``provision_growth`` all read the ``mode`` property, the
    override propagates everywhere without further changes.
    """

    threshold: float = 0.0       # switch when the EMA divergence drops below
    momentum: float = 0.0        # MomentumBuffer momentum for the EMA
    replay_at: int | None = None  # prescribed switch step (sim replay)
    switch_step: int | None = None  # realized switch; checkpointed on preempt
    ema: float = 0.0             # running divergence average; checkpointed

    @property
    def mode(self) -> Mode:
        if self.done:
            raise ValueError("cursor exhausted")
        if self.switch_step is not None and self.step >= self.switch_step:
            return Mode.COND
        return PlanCursor.mode.fget(self)

    def remaining_plan_full_steps(self) -> int:
        """Plan-FULL steps not yet executed (before any dynamic override)."""
        return sum(1 for i in range(self.step, self.plan.total_steps)
                   if self._mode_at(i) is Mode.FULL)

    def elided_uncond_passes(self) -> int:
        """Uncond passes dropped beyond the bound plan by the switch."""
        if self.switch_step is None:
            return 0
        return sum(1 for i in range(self.switch_step, self.plan.total_steps)
                   if self._mode_at(i) is Mode.FULL)

    def observe(self, divergence: float) -> bool:
        """Feed one post-advance cond/uncond divergence observation.

        The engine calls this after every executed FULL step with
        ``||logits_cond - logits_uncond||_2`` for that step.  Returns True
        exactly once — on the observation that triggers the FULL→COND
        switch — so the caller can emit the ``policy_switch`` event.
        """
        if self.switch_step is not None:
            return False
        self.ema = float(divergence) + self.momentum * self.ema
        if self.remaining_plan_full_steps() == 0:
            return False         # at the plan boundary: nothing to elide
        if self.replay_at is not None:
            triggered = self.step >= self.replay_at
        else:
            triggered = self.threshold > 0.0 and self.ema < self.threshold
        if triggered:
            self.switch_step = self.step
            return True
        return False


class GuidancePolicy:
    """Base policy: a bound plan plus a cursor factory.

    The bound plan is what every *capacity* decision prices: admission page
    needs (``stream_page_needs``/``fresh_lazy_needs``), eager reservation
    and the roofline pass budget.  ``max_full_steps()`` is the guarantee —
    no cursor this policy builds ever executes more FULL steps.
    """

    name = "static"

    def __init__(self, plan: GuidancePlan):
        self.plan = plan

    def bound_plan(self) -> GuidancePlan:
        return self.plan

    def max_full_steps(self) -> int:
        return sum(s.length for s in self.plan.segments
                   if s.mode is Mode.FULL)

    def cursor(self, *, step: int = 0, passes_executed: int = 0) -> PlanCursor:
        raise NotImplementedError

    def effective_scale(self, step: int) -> float:
        """Combine-stage guidance scale for step ``step`` (interval policy
        weakens guidance to 1.0 outside its interval; others are flat)."""
        return self.plan.guidance_scale


class StaticGuidancePolicy(GuidancePolicy):
    """Today's behavior: the realized schedule IS the bound plan.

    Returns a plain :class:`PlanCursor`, so the serve path is bit-compatible
    with the pre-policy code (golden traces hold byte for byte).
    """

    name = "static"

    def cursor(self, *, step: int = 0, passes_executed: int = 0) -> PlanCursor:
        return PlanCursor(self.plan, step=step, passes_executed=passes_executed)


class DivergenceGuidancePolicy(GuidancePolicy):
    """Data-dependent switch on the EMA'd cond/uncond divergence norm."""

    name = "divergence"

    def __init__(self, plan: GuidancePlan, *, threshold: float,
                 momentum: float = 0.0):
        super().__init__(plan)
        if threshold <= 0.0:
            raise ValueError("divergence policy needs threshold > 0")
        self.threshold = float(threshold)
        self.momentum = float(momentum)

    def cursor(self, *, step: int = 0, passes_executed: int = 0,
               switch_step: int | None = None,
               ema: float = 0.0) -> DynamicPlanCursor:
        return DynamicPlanCursor(self.plan, step=step,
                                 passes_executed=passes_executed,
                                 threshold=self.threshold,
                                 momentum=self.momentum,
                                 switch_step=switch_step, ema=ema)


class ReplayGuidancePolicy(GuidancePolicy):
    """Re-enact a recorded switch at a fixed step (sim / determinism tests).

    ``switch_at=None`` means the recorded run never switched — the cursor
    behaves exactly like the bound plan.
    """

    name = "replay"

    def __init__(self, plan: GuidancePlan, switch_at: int | None):
        super().__init__(plan)
        if switch_at is not None and not 0 <= switch_at <= plan.total_steps:
            raise ValueError(f"switch_at {switch_at} outside plan")
        self.switch_at = switch_at

    def cursor(self, *, step: int = 0, passes_executed: int = 0,
               switch_step: int | None = None,
               ema: float = 0.0) -> PlanCursor:
        if self.switch_at is None:
            return PlanCursor(self.plan, step=step,
                              passes_executed=passes_executed)
        return DynamicPlanCursor(self.plan, step=step,
                                 passes_executed=passes_executed,
                                 replay_at=self.switch_at,
                                 switch_step=switch_step, ema=ema)


class IntervalGuidancePolicy(GuidancePolicy):
    """Interval guidance (Kynkäänniemi et al., arxiv 2404.07724), AR-legal.

    Guidance is applied only for steps in ``[start, stop)`` (fractions of
    ``total_steps``).  The AR-legal realization keeps both streams alive
    through the whole pre-``stop`` prefix (the uncond KV cache must stay
    fresh) but weakens the combine to scale 1.0 outside the interval; after
    ``stop`` the uncond stream is dropped structurally, exactly like a
    suffix plan.  The pass schedule is therefore static — no
    ``policy_switch`` events — and the bound plan is exact.
    """

    name = "interval"

    def __init__(self, total_steps: int, start_frac: float, stop_frac: float,
                 guidance_scale: float = 7.5):
        if not 0.0 <= start_frac < stop_frac <= 1.0:
            raise ValueError((start_frac, stop_frac))
        self.start = round_half_up(total_steps * start_frac)
        self.stop = round_half_up(total_steps * stop_frac)
        segs = []
        if self.stop:
            segs.append(Segment(0, self.stop, Mode.FULL))
        if self.stop < total_steps:
            segs.append(Segment(self.stop, total_steps, Mode.COND))
        super().__init__(GuidancePlan(total_steps, tuple(segs), guidance_scale))

    def cursor(self, *, step: int = 0, passes_executed: int = 0) -> PlanCursor:
        return PlanCursor(self.plan, step=step, passes_executed=passes_executed)

    def effective_scale(self, step: int) -> float:
        if self.start <= step < self.stop:
            return self.plan.guidance_scale
        return 1.0


def make_policy(name: str, plan: GuidancePlan, *,
                threshold: float = 0.0, momentum: float = 0.0,
                interval: tuple[float, float] = (0.0, 1.0)) -> GuidancePolicy:
    """Build the per-request policy the engine/sim uses for ``plan``.

    For ``interval`` the plan argument supplies ``total_steps`` and the
    guidance scale; the FULL prefix is rederived from the interval's stop
    fraction (the caller's plan fraction is ignored by design — the
    interval IS the schedule).
    """
    if name == "static":
        return StaticGuidancePolicy(plan)
    if name == "divergence":
        return DivergenceGuidancePolicy(plan, threshold=threshold,
                                        momentum=momentum)
    if name == "interval":
        return IntervalGuidancePolicy(plan.total_steps, interval[0],
                                      interval[1], plan.guidance_scale)
    raise ValueError(f"unknown guidance policy {name!r}; "
                     f"expected one of {GUIDANCE_POLICIES}")
