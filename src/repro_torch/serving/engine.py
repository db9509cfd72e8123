"""Batched guided-generation serving — compatibility facade. Copy of
``repro/serving/engine.py`` over the port's engine.

The real engine lives in ``repro_torch.serve`` (phase-aware continuous
batching over a slot arena). :class:`ServingEngine` keeps
the seed's static-batching surface — fixed ``(batch, prompt_len,
max_new)`` buckets, synchronous ``generate`` — but executes every bucket
on a :class:`repro_torch.serve.ContinuousEngine` configured with
``pass_budget = 2 * max_batch``, under which a same-plan bucket steps in
lockstep exactly as the old phase-split decode did.

Two seed bugs are fixed here rather than preserved:

* per-request ``guidance_scale`` / ``temperature`` are honored (the seed
  silently applied ``chunk[0]``'s values to the whole bucket) — the
  continuous engine carries both per slot, so no compatibility grouping
  is needed;
* ``BucketStats.tokens_generated`` counts post-truncation tokens (EOS /
  ``max_new_tokens``), not ``max_new`` per request, so ``tokens_per_s``
  no longer overstates throughput.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from repro_torch.core.selective import GuidancePlan
from repro_torch.data.tokenizer import EOS
from repro_torch.serve import ContinuousEngine, ServeRequest


@dataclass
class Request:
    uid: str
    prompt: str | list[int]
    max_new_tokens: int = 32
    guidance_scale: float = 4.0
    temperature: float = 0.0


@dataclass
class BucketStats:
    batches: int = 0
    requests: int = 0
    tokens_generated: int = 0
    wall_s: float = 0.0
    denoiser_passes: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.wall_s if self.wall_s else 0.0


class ServingEngine:
    """``model`` is a ``repro_torch.models.transformer.Transformer`` on the
    device the engine runs on; the rest are the reference's arguments and
    defaults."""

    def __init__(self, model, cfg, *, max_batch: int = 8, prompt_len: int = 32,
                 max_new: int = 32, selective_fraction: float = 0.2,
                 rules=None, seed: int = 0, kv: str = "slot",
                 page_size: int = 8):
        self.model = model
        self.cfg = cfg
        self.max_batch = max_batch
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.selective_fraction = selective_fraction
        self.rules = rules
        self.stats = BucketStats()
        # budget 2*max_batch: a full bucket fits even when every request is
        # in FULL phase, so same-plan buckets run lockstep (static batching
        # as a special case of the continuous engine); kv picks the arena
        # (slot rows vs the paged pool) without changing the facade surface
        self._engine = ContinuousEngine(
            model, cfg, num_slots=max_batch, pass_budget=2 * max_batch,
            prompt_len=prompt_len, max_new=max_new,
            selective_fraction=selective_fraction, rules=rules, seed=seed,
            stop_on_eos=False, prefills_per_tick=max_batch,
            queue_depth=max(256, max_batch), kv=kv, page_size=page_size)

    @property
    def _compiled(self) -> set:
        """The step and prefill shapes the engine has used, under the
        reference's jit keys (compat: the seed engine exposed its jit cache
        under this name)."""
        return self._engine._shapes

    def _plan(self, scale: float, fraction: float) -> GuidancePlan:
        return GuidancePlan.suffix(self.max_new, fraction, guidance_scale=scale)

    # -- main entry ---------------------------------------------------------

    def generate(self, requests: list[Request],
                 selective_fraction: float | None = None) -> dict[str, list[int]]:
        """Serve a list of requests; returns uid -> generated token ids."""
        frac = self.selective_fraction if selective_fraction is None else selective_fraction
        out: dict[str, list[int]] = {}
        for i in range(0, len(requests), self.max_batch):
            chunk = requests[i:i + self.max_batch]
            out.update(self._run_batch(chunk, frac))
        return out

    def _run_batch(self, chunk: list[Request], frac: float):
        eng = self._engine
        passes0 = eng.metrics.denoiser_passes
        t0 = time.perf_counter()
        served = eng.serve([
            ServeRequest(uid=req.uid, prompt=req.prompt,
                         max_new_tokens=req.max_new_tokens,
                         guidance_scale=req.guidance_scale,
                         temperature=req.temperature,
                         selective_fraction=frac)
            for req in chunk])
        dt = time.perf_counter() - t0

        out = {}
        tokens = 0
        for req in chunk:
            ids = served[req.uid][: req.max_new_tokens]
            if EOS in ids:
                ids = ids[: ids.index(EOS)]
            out[req.uid] = ids
            tokens += len(ids)
            # delivered: drop per-request state so a long-lived facade does
            # not grow with total requests served (tick records rotate via
            # ServeMetrics.max_records)
            eng.results.pop(req.uid, None)
            eng.metrics.timelines.pop(req.uid, None)

        self.stats.batches += 1
        self.stats.requests += len(chunk)
        self.stats.tokens_generated += tokens
        self.stats.wall_s += dt
        self.stats.denoiser_passes += eng.metrics.denoiser_passes - passes0
        return out
