# Copy of repro/serve/queue.py (framework-free).
"""Arrival queue with admission control and per-request deadlines.

The queue is the engine-facing front door of ``repro.serve``: requests
arrive (possibly mid-flight of other requests), are admission-controlled
against a bounded depth, and can carry a time-to-live after which they are
dropped unserved rather than wasting denoiser passes on an answer nobody is
waiting for.

Time is a caller-supplied monotonic value (the engine's tick counter, or a
simulated clock in ``repro.serve.sim``) — the queue never reads a wall
clock, which is what keeps trace replays deterministic.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from repro_torch.core.selective import GuidancePlan


@dataclass
class ServeRequest:
    """One guided-generation request as the continuous engine sees it.

    ``guidance_scale`` / ``temperature`` / ``selective_fraction`` are
    per-request (the static engine's single-bucket flattening of these was a
    bug); ``plan`` overrides the suffix plan the engine would otherwise
    build; ``ttl`` is a deadline in ticks relative to arrival (``None`` =
    never expires); ``priority`` layers under the scheduler's EDF/aging
    guard (larger = packs first, preempted last — lazy-reservation engines
    evict the lowest-priority in-flight request when the page pool runs
    dry).
    """

    uid: str
    prompt: str | list[int]
    max_new_tokens: int = 32
    guidance_scale: float = 4.0
    temperature: float = 0.0
    selective_fraction: float | None = None
    plan: GuidancePlan | None = None
    ttl: float | None = None
    prompt_len: int | None = None   # paged engines admit mixed lengths;
                                    # None = the engine-wide default
    priority: int = 0

    # set by the queue at push time
    arrival: float = field(default=0.0, init=False)
    deadline: float | None = field(default=None, init=False)


@dataclass
class QueueStats:
    submitted: int = 0
    rejected: int = 0
    expired: int = 0
    popped: int = 0
    requeued: int = 0


class ArrivalQueue:
    """Bounded FIFO with deadline expiry.

    ``push`` applies admission control (full queue -> reject, not block);
    ``expire`` drops requests whose deadline passed while they waited;
    ``pop`` hands the oldest admissible request to the engine.
    """

    def __init__(self, max_depth: int = 256):
        if max_depth < 1:
            raise ValueError(max_depth)
        self.max_depth = max_depth
        self._q: deque[ServeRequest] = deque()
        self.stats = QueueStats()

    def __len__(self) -> int:
        return len(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    def push(self, req: ServeRequest, now: float = 0.0) -> bool:
        """Admit ``req`` at time ``now``; False = rejected (queue full)."""
        self.stats.submitted += 1
        if len(self._q) >= self.max_depth:
            self.stats.rejected += 1
            return False
        req.arrival = now
        req.deadline = None if req.ttl is None else now + req.ttl
        self._q.append(req)
        return True

    def requeue(self, req: ServeRequest) -> None:
        """Return a preempted request to the *front* of the queue,
        preserving its original arrival and deadline (the eviction is the
        engine's doing, not the request's — it must not lose its FCFS
        standing or gain fresh deadline budget). Bypasses the depth bound:
        the request was already admitted once and its state is
        checkpointed; dropping it here would lose work."""
        self.stats.requeued += 1
        self._q.appendleft(req)

    def expire(self, now: float) -> list[ServeRequest]:
        """Drop (and return) every queued request whose deadline passed."""
        dead = [r for r in self._q
                if r.deadline is not None and r.deadline < now]
        if dead:
            gone = set(id(r) for r in dead)
            self._q = deque(r for r in self._q if id(r) not in gone)
            self.stats.expired += len(dead)
        return dead

    def pop(self) -> ServeRequest | None:
        if not self._q:
            return None
        self.stats.popped += 1
        return self._q.popleft()

    def peek(self) -> ServeRequest | None:
        return self._q[0] if self._q else None
