# Copy of repro/serve/fleet.py: the router, ``ServeFleet`` over the port's
# engines, the fleet simulator and the summary.
"""Fleet tier: N engine replicas behind a prefix-affinity router.

The ROADMAP's "millions of users" item (DESIGN.md §16). One engine —
even sharded and pipelined — is a single arena and a single content
cache; fleet scale multiplies both, and the router decides which
replica's cache a request can exploit. Two placement policies:

* ``affinity`` — repeats of a ``content_key`` go to the replica that
  admitted the first occurrence (its content cache holds the founder's
  cond prompt KV and pre-combine logits, so every repeat is a zero-pass
  prefix hit); first occurrences go to the replica with the fewest
  assigned KV bytes (ties: fewest requests, then lowest id).
* ``random`` — the seeded baseline the acceptance criterion beats:
  on a Zipf "popular" trace, affinity routing must produce strictly
  more prefix hits and strictly fewer denoiser passes at equal total
  pool bytes, because random routing re-prefills the head prompt once
  per replica it lands on.

The router is a *pure function of the routed request sequence* — it
never reads live replica state. That is deliberate: the same
``FleetRouter.route`` calls, in the same order, with the same keys and
byte costs, reproduce the same placement in :func:`simulate_fleet` as
in :class:`ServeFleet`, which is what extends the engine == sim
event-stream parity to fleet scale (per replica, event for event).
Live-occupancy feedback would couple placement to wall-clock timing and
break replayability; byte-need at admission is the load signal that
stays deterministic.

Aggregation rides on the mergeable log2 histograms:
:func:`fleet_summary` merges every replica's TTFT/TPOT/queue-wait/tick
histograms into fleet-wide p50/p95/p99 and SLO attainment, and sums the
counters (with the same zero-denominator guards a cold replica needs).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.obs.hist import default_histograms
from repro_torch.serve.sim import SimReport, SimRequest, simulate
from repro_torch.serve.state import content_key, stream_page_needs

ROUTE_POLICIES = ("affinity", "random")

#: Counters summed across replicas by :func:`fleet_summary`.
FLEET_COUNTERS = (
    "completed", "expired", "rejected", "tokens_emitted",
    "denoiser_passes", "prefill_passes", "prefix_hits", "prefix_misses",
    "recompute_passes_avoided", "swap_outs", "swap_ins", "host_evictions",
    "preemptions", "resumes", "pages_grown", "shared_page_hits",
    "cow_copies", "cache_evictions", "pages_reclaimed",
    "uncond_ticks_elided", "policy_switches",
    "uncond_passes_elided_dynamic", "step_launches", "step_compiles",
)


class FleetRouter:
    """Deterministic request -> replica placement.

    ``route`` sees each request exactly once, in arrival order, as a
    ``(content key, KV byte need)`` pair; it returns the replica id and
    updates its own assignment ledger. No live replica state is read
    (see the module docstring: that purity is the engine == sim lever).
    """

    def __init__(self, n_replicas: int, *, policy: str = "affinity",
                 seed: int = 0):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if policy not in ROUTE_POLICIES:
            raise ValueError(f"policy must be one of {ROUTE_POLICIES}, "
                             f"got {policy!r}")
        self.n_replicas = n_replicas
        self.policy = policy
        self._home: dict[str, int] = {}     # content key -> founding replica
        self.assigned_bytes = [0] * n_replicas
        self.assigned_count = [0] * n_replicas
        self._rng = np.random.default_rng(seed)

    def route(self, ckey: str | None, nbytes: int = 0) -> int:
        """Place one request; ``ckey=None`` means a prompt with no
        content identity (affinity falls through to load balancing)."""
        if self.policy == "random":
            rid = int(self._rng.integers(self.n_replicas))
        elif ckey is not None and ckey in self._home:
            rid = self._home[ckey]          # replica whose cache holds it
        else:
            rid = min(range(self.n_replicas),
                      key=lambda r: (self.assigned_bytes[r],
                                     self.assigned_count[r], r))
            if ckey is not None:
                self._home[ckey] = rid
        self.assigned_bytes[rid] += nbytes
        self.assigned_count[rid] += 1
        return rid


class ServeFleet:
    """N real engines behind one :class:`FleetRouter`.

    Replicas are fully independent (disjoint arenas, caches and metric
    streams; on one GPU they may share one model object, each engine with
    its own pool and graph pool); the fleet routes each request once, then
    drives every replica's sub-trace through the single-engine
    ``serve_trace``. The byte cost the router balances on is the request's
    worst-case KV page need priced at the replica page size — known at
    routing time, before any device work.
    """

    def __init__(self, engines: list, *, policy: str = "affinity",
                 seed: int = 0):
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        if any(e.mesh_devices > 1 for e in engines):
            raise NotImplementedError("a fleet of engines on meshes of several devices is not "
                                      "ported (ROADMAP §A)")
        self.engines = list(engines)
        self.router = FleetRouter(len(engines), policy=policy, seed=seed)
        self.assignments: dict[str, int] = {}

    def route_request(self, req) -> int:
        """Route one request (and record the assignment)."""
        eng = self.engines[0]     # replicas share model geometry
        plan = eng._plan_for(req)
        S = eng._prompt_len_for(req)
        ckey = None
        if eng._content is not None:
            ckey = content_key(eng._tokenize(req.prompt, S))
        need = sum(stream_page_needs(plan, S, eng.page_size))
        rid = self.router.route(ckey, need * eng.page_bytes)
        self.assignments[req.uid] = rid
        return rid

    def serve_trace(self, requests: list, arrivals,
                    max_ticks: int = 100_000) -> dict[str, list[int]]:
        """Route the whole trace in arrival order, then drain each
        replica's sub-trace; returns the merged uid -> tokens map."""
        subs = [([], []) for _ in self.engines]
        for req, arr in zip(requests, arrivals):
            rid = self.route_request(req)
            subs[rid][0].append(req)
            subs[rid][1].append(arr)
        out: dict[str, list[int]] = {}
        for eng, (reqs, arrs) in zip(self.engines, subs):
            if reqs:
                out.update(eng.serve_trace(reqs, arrs, max_ticks=max_ticks))
        return out

    @property
    def metrics(self) -> list[ServeMetrics]:
        return [e.metrics for e in self.engines]

    def summary(self) -> dict:
        return fleet_summary(self.metrics)


@dataclass
class FleetReport:
    """One fleet simulation: per-replica :class:`SimReport`s plus the
    router that produced the placement."""

    replicas: list[SimReport]
    router: FleetRouter
    assignments: dict[str, int] = field(default_factory=dict)

    @property
    def metrics(self) -> list[ServeMetrics]:
        return [r.metrics for r in self.replicas]

    def summary(self) -> dict:
        return fleet_summary(self.metrics)


def simulate_fleet(trace: list[SimRequest], n_replicas: int, *,
                   policy: str = "affinity", seed: int = 0,
                   page_size: int = 4, page_bytes: int | None = None,
                   **sim_kwargs) -> FleetReport:
    """Fleet-scale offline replay: route ``trace`` across ``n_replicas``
    with the *same* :class:`FleetRouter` the live fleet uses, then run
    each sub-trace through :func:`repro_torch.serve.sim.simulate` with
    identical per-replica knobs (``sim_kwargs``). Each replica's
    counters and event stream equal a real engine serving the same
    sub-trace — the single-engine parity contract, once per replica.

    A request's content identity is its ``content`` label (the sim's
    stand-in for the engine's token-id hash); ``None`` routes by load
    alone, exactly as an engine with no content cache would.
    """
    router = FleetRouter(n_replicas, policy=policy, seed=seed)
    pb = page_bytes if page_bytes is not None else 1
    subs: list[list[SimRequest]] = [[] for _ in range(n_replicas)]
    assignments: dict[str, int] = {}
    for req in sorted(trace, key=lambda r: (r.arrival, r.uid)):
        need = sum(stream_page_needs(req.plan, req.prompt_len, page_size))
        rid = router.route(req.content, need * pb)
        assignments[req.uid] = rid
        subs[rid].append(req)
    reports = [simulate(sub, page_size=page_size, page_bytes=page_bytes,
                        **sim_kwargs)
               for sub in subs]
    return FleetReport(reports, router, assignments)


def fleet_summary(metrics_list: list[ServeMetrics],
                  slo: dict[str, float] | None = None) -> dict:
    """Fleet-wide aggregate: summed counters, guarded rates, and merged
    log2 histograms (the merge is exact — bucket layouts are
    identical by construction, so fleet percentiles carry the same
    bounded error as a single replica's).

    ``slo`` maps a histogram name (``ttft``/``tpot``/``queue_wait``/
    ``tick_s``) to a threshold; attainment is computed on the *merged*
    histogram, conservatively (a cold fleet attains 1.0, never a
    division by zero).
    """
    out: dict = {"replicas": len(metrics_list)}
    for name in FLEET_COUNTERS:
        out[name] = sum(getattr(m, name) for m in metrics_list)
    lookups = out["prefix_hits"] + out["prefix_misses"]
    out["prefix_hit_rate"] = out["prefix_hits"] / lookups if lookups else 0.0
    out["passes_saved"] = sum(m.passes_saved() for m in metrics_list)
    full = sum(m.full_cfg_passes() for m in metrics_list)
    out["savings_fraction"] = out["passes_saved"] / full if full else 0.0
    merged = default_histograms()
    for m in metrics_list:
        for name, h in m.hists.items():
            if name in merged:
                merged[name].merge(h)
    for name, h in merged.items():
        out[name] = h.summary()
    if slo:
        out["slo_attainment"] = {
            name: merged[name].slo_attainment(thr)
            for name, thr in slo.items() if name in merged}
    return out
