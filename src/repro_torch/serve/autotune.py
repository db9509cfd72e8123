"""Pass-budget autotuning from the roofline step-latency model.

Copy of ``repro/serve/autotune.py`` (framework-free) with two recorded
differences. The reference prices a step by running ``repro.roofline`` on
its compiled XLA executable; the port has none, so :meth:`observe` and
:meth:`observe_ragged` take the step's roofline seconds, which the engine
counts from its geometry (``repro_torch.roofline.decode_step``, H100
constants). And :meth:`BudgetAutotuner.budget` steps its raw pass count
down once where ``int(target / per_pass)`` rounded up past the target (the
reference's fault recorded in ROADMAP C).

The per-tick ``pass_budget`` was a constant; this module derives it from
the roofline. Observations are keyed by step shape *and KV dtype* (an int8
pool step streams ~half the bytes of a bf16 one, so the same occupancy
prices differently per dtype); each observation is a predicted step
latency ``max(compute_s, memory_s)`` turned into a per-pass cost
``latency / passes``. The budget is
the largest pass count whose predicted tick latency fits the operator's
``target_tick_s``, priced off the *worst* per-pass cost among the
observations that apply to the pool's dtype — pricing off the global
worst would let a stale observation from another dtype (a bf16 compile
in an int8 run, say) shrink the budget for no physical reason.

Two step shapes feed it:

* signature mode observes the two pure occupancies ((1,0) and (0,1)),
  keyed ``(n_full, n_cond, kv_dtype)``;
* ragged mode observes its single fixed-width step, keyed
  ``("ragged", rows, kv_dtype)``.

When the budget the envelope allows falls below ``min_budget`` the
clamp wins (a budget below 2 can't schedule one FULL step) — but then
the engine is *knowingly* exceeding ``target_tick_s``.
``envelope_violated`` surfaces that instead of clamping silently.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.roofline import H100_HOST_LINK_BYTES_S


def _key_dtype(key: tuple) -> str | None:
    """The kv_dtype a per_pass_s key is scoped to, or None if unscoped.

    Canonical keys end in the dtype string (``(1, 0, "bf16")``,
    ``("ragged", 8, "int8")``). Bare occupancy tuples (``(1, 0)``) —
    still accepted for direct injection in tests and external tools —
    carry no dtype and apply to every pool.
    """
    tail = key[-1] if key else None
    return tail if isinstance(tail, str) and tail != "ragged" else None


@dataclass
class BudgetAutotuner:
    """Maps observed (step shape -> roofline seconds) pairs to a pass budget.

    ``target_tick_s`` is the latency envelope one tick must fit;
    ``min_budget`` keeps the budget schedulable (one FULL step needs 2);
    ``max_budget`` caps runaway targets (default: no cap).
    """

    target_tick_s: float
    min_budget: int = 2
    max_budget: int | None = None
    per_pass_s: dict[tuple, float] = field(default_factory=dict)

    def observe(self, signature: tuple[int, int], seconds: float, *,
                kv_dtype: str = "bf16") -> float:
        """Record one per-signature step's roofline ``seconds``; returns the
        signature's per-pass seconds.

        Entries are keyed ``(n_full, n_cond, kv_dtype)``: an int8 and a
        bf16 step of the same occupancy are *different* steps (the int8
        step streams ~half the KV bytes, so its memory_s is lower). Keying
        on occupancy alone would let whichever dtype was observed last
        overwrite the other and the worst-per-pass budget would be priced
        off a stale dtype.
        """
        n_full, n_cond = signature
        passes = 2 * n_full + n_cond
        if passes <= 0:
            raise ValueError(signature)
        per_pass = float(seconds) / passes
        self.per_pass_s[(n_full, n_cond, kv_dtype)] = per_pass
        return per_pass

    def observe_ragged(self, rows: int, seconds: float, *,
                       kv_dtype: str = "bf16") -> float:
        """Record the ragged step's roofline ``seconds``, keyed
        ``("ragged", rows, kv_dtype)``. A fully packed ragged step runs
        ``rows`` passes, so that is the per-pass divisor: the roofline
        prices the step with every row live, the honest fully-loaded
        cost."""
        if rows <= 0:
            raise ValueError(rows)
        per_pass = float(seconds) / rows
        self.per_pass_s[("ragged", rows, kv_dtype)] = per_pass
        return per_pass

    def worst_for(self, kv_dtype: str | None = None) -> float | None:
        """Worst observed per-pass seconds among entries that apply to
        ``kv_dtype`` (dtype-unscoped legacy keys always apply); None
        scopes to nothing, i.e. the global worst."""
        vals = [v for k, v in self.per_pass_s.items()
                if kv_dtype is None or _key_dtype(k) in (None, kv_dtype)]
        return max(vals) if vals else None

    @property
    def worst_per_pass_s(self) -> float | None:
        return self.worst_for(None)

    def budget(self, kv_dtype: str | None = None) -> int | None:
        """Largest pass count whose predicted tick time fits the target
        (clamped to [min_budget, max_budget]); None before any applicable
        observe. Pass the pool's ``kv_dtype`` to price off that dtype's
        observations only (a stale other-dtype entry must not set the
        budget). Where the division rounds up past the target (``raw *
        per_pass > target_tick_s``), ``raw`` steps down once: the port's fix
        of the reference's rounding fault."""
        per_pass = self.worst_for(kv_dtype)
        if per_pass is None:
            return None
        raw = int(self.target_tick_s / per_pass) if per_pass > 0 else \
            (self.max_budget or self.min_budget)
        if per_pass > 0 and raw * per_pass > self.target_tick_s:
            raw -= 1
        if self.max_budget is not None:
            raw = min(raw, self.max_budget)
        return max(self.min_budget, raw)

    def predicted_tick_s(self, kv_dtype: str | None = None) -> float | None:
        """Predicted latency of a fully packed tick at the chosen budget
        — ``budget * worst_per_pass``. Exceeds ``target_tick_s`` exactly
        when the ``min_budget`` clamp overrode the envelope."""
        per_pass = self.worst_for(kv_dtype)
        b = self.budget(kv_dtype)
        if per_pass is None or b is None:
            return None
        return b * per_pass

    def headroom_s(self, kv_dtype: str | None = None) -> float | None:
        """Envelope slack: ``target_tick_s - predicted_tick_s``. Negative
        exactly when :meth:`envelope_violated` — the observability report
        surfaces this as a number instead of a bare flag so SLO dashboards
        can trend it."""
        pred = self.predicted_tick_s(kv_dtype)
        if pred is None:
            return None
        return self.target_tick_s - pred

    def envelope_violated(self, kv_dtype: str | None = None) -> bool:
        """True when the returned budget *knowingly* exceeds the operator's
        ``target_tick_s`` — the ``min_budget`` clamp won, so a full tick is
        predicted to run long. Callers that care about the envelope must
        check this rather than trusting ``budget()`` silently."""
        pred = self.predicted_tick_s(kv_dtype)
        return pred is not None and pred > self.target_tick_s

    #: break-even verdict for "swapping never pays on this link": larger
    #: than any real checkpoint, so ``plan_swap_out`` always recomputes
    SWAP_NEVER = 1 << 30

    def swap_break_even_pages(self, page_bytes: int, *,
                              host_gbps: float = H100_HOST_LINK_BYTES_S / 1e9,
                              kv_dtype: str | None = None) -> int:
        """Restore-bytes vs recompute-passes break-even (DESIGN.md §14):
        the smallest checkpoint size, in pages, for which restoring from
        the host tier beats recomputing the KV with the batched resume
        forward — the floor ``swap_min_pages="auto"`` installs into
        ``plan_swap_out``.

        Cost model, both sides in roofline seconds:

        * **restore(n)** = ``t_setup + n * page_bytes / host_bw`` — a
          fixed DMA round-trip setup (priced at one per-pass unit, the
          kernel-launch scale of the gather/scatter pair) plus per-byte
          transfer;
        * **recompute(n)** = ``2 * per_pass * n`` — the two-stream resume
          forward's work grows with the span it rebuilds, priced per page
          at the roofline's worst applicable per-pass seconds.

        Short checkpoints sit under the DMA setup cost, so recompute wins
        (the issue's "long generated suffixes swap"); the break-even is
        the smallest ``n`` where restore is no slower. When the per-page
        DMA alone exceeds the per-page recompute (``page_bytes/host_bw >=
        2*per_pass``) the lines never cross and :data:`SWAP_NEVER` says
        so. Monotonicity (pinned in tests): a faster link lowers the
        floor, fatter pages raise it, a slower model (larger per-pass)
        lowers it. Returns 0 — swap everything — before any applicable
        observation or on degenerate inputs. ``host_gbps`` defaults to the
        H100's PCIe Gen5 x16 link in one direction
        (``repro_torch.roofline``), where the reference assumes 8 GB/s.
        """
        per_pass = self.worst_for(kv_dtype)
        if per_pass is None or per_pass <= 0 or page_bytes <= 0 \
                or host_gbps <= 0:
            return 0
        per_page_s = page_bytes / (host_gbps * 1e9)
        margin = 2 * per_pass - per_page_s     # per-page restore advantage
        if margin <= 0:
            return self.SWAP_NEVER
        return max(1, min(self.SWAP_NEVER, math.ceil(per_pass / margin)))

    def report(self, kv_dtype: str | None = None) -> dict:
        """Full autotuner state. ``per_pass_s`` lists every observation;
        worst/budget/predicted/violated scope to ``kv_dtype`` when given
        (the pool's active dtype), else global."""
        return {
            "target_tick_s": self.target_tick_s,
            "per_pass_s": {",".join(map(str, k)): v
                           for k, v in sorted(self.per_pass_s.items(),
                                              key=lambda kv: str(kv[0]))},
            "worst_per_pass_s": self.worst_for(kv_dtype),
            "budget": self.budget(kv_dtype),
            "predicted_tick_s": self.predicted_tick_s(kv_dtype),
            "headroom_s": self.headroom_s(kv_dtype),
            "envelope_violated": self.envelope_violated(kv_dtype),
        }
