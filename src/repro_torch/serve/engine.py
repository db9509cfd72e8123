"""Continuous-batching serve engine over a slot or paged KV arena.
Counterpart of ``repro.serve.engine.ContinuousEngine``.

Requests join and leave mid-flight. Each tick expires queued requests past
their deadline, admits new ones, asks the :class:`Scheduler` to pack the
active requests against the tick's denoiser-pass budget (FULL = 2 passes,
COND = 1), runs one decode step, then emits tokens, retires completed
requests and, on pages, returns a request's unconditional pages to the pool
the moment its plan crosses into the COND suffix.

Two KV arenas (``kv``):

* ``"slot"`` (the default) holds two pools, cond and uncond, of
  ``num_slots`` rows a layer: linear caches of ``prompt_len + max_new``
  positions, or, for a layer whose sliding window W is shorter, rings of W
  slots with their slot positions (a ring a row, as the reference's
  per-row decode caches); MLA latents of that capacity; recurrent states,
  a row each. Every request uses the engine-wide ``prompt_len``. Each
  admission prefills its row; the step reads and writes the rows of its
  groups in place through their slot indices, each row at its own position
  (B5's per-row form, or its ring-a-row form; latents by index; states
  gathered, stepped and scattered back).
  Holes left by departures are compacted (``_maybe_defrag``) past
  ``defrag_threshold``.
* ``"paged"`` shares one page pool between both streams of every request
  through block tables. ``reservation="eager"`` grants each stream every
  page it can touch at admission; ``"lazy"`` grants the prompt's pages,
  grows the decode span every tick (``provision_growth``), shares the
  uncond prompt prefix between requests of one length (copy-on-write once
  a shared partial page diverges), and when the pool runs dry preempts the
  weakest request: its pages are freed, its cursor, tokens and sampling key
  kept, and on resume one prefill over prompt + generated tokens rebuilds
  its KV, so the resumed tokens are those of an uninterrupted run. The
  prefills of one tick are batched per pow2 length bucket.

Two tiers beside lazy reservation:

* ``host_pool_bytes`` buys a host tier (``HostPagePool``, pinned beside a
  GPU pool): a preemption victim's pages are copied out (``_swap_out``)
  unless ``plan_swap_out`` says recompute (``swap_min_pages``, an int or
  ``"auto"``: the roofline break-even), and its resume copies them back
  (``_restore_pages``) with no forward; the least recently stored
  checkpoint goes first when the tier is full, and an expired request's
  checkpoint goes with it.
* ``prefix_cache="content"`` keeps the cond prompt pages of each distinct
  prompt (``ContentPrefixRegistry``): a later identical prompt shares them
  and replays token 0 from the founder's cached pre-combine logits (kept
  on the device) with its own scale, key and temperature, at no pass.

Two step modes:

* ``"ragged"`` (the default) runs the whole tick as one step of
  ``ragged_rows`` rows, one denoiser pass each with its own block table,
  position and phase: FULL entries give a cond and an uncond row, COND
  entries one, the rest is phase-0 padding. The attention goes to the
  ragged paged kernels (B7 bf16, B8 int8). Its shape never changes, so it
  is counted as one compile per model, under the key ``("rstep", R)``.
* ``"signature"`` (the slot arena's; opt-in on pages) runs the FULL and
  COND groups of the tick, each padded to a power of two; on pages through
  the per-row-position kernels (B9, B10), one compile counted per
  ``("pstep", n_full, n_cond)`` bucket, in the slot arena through B5 per
  row, one per ``("step", n_full, n_cond)``.

On a GPU every step is a CUDA graph (``graphs``, on by default there, off
on a mesh of several devices), the
counterpart of the reference's jitted steps: captured at the step's counted
compile (the embedding, the forwards over the pools, the combine, the
divergence and the argmax), one graph for the ragged step and one per
signature bucket, all of a mode drawing on one memory pool; each tick
writes its rows into a pinned host buffer, copies them into the step's
fixed device buffers and replays the graph once; rows at temperature > 0
are drawn after the replay from the graph's logits. Every host array the
device reads goes up from pinned memory without waiting.

``tick_mode="async"`` pipelines the ragged paged tick (``_tick_async``):
the step is dispatched, the structural finalize runs, and while the device
works the next tick's expiries and admissions are decided
(``_admit_collect``: slots, pages and prefills dispatched, nothing waited
for), their events captured and replayed next tick in the synchronous
order; only the harvest waits. Tokens, counters and events equal a sync
engine's.

``pass_budget="auto"`` derives the budget from the roofline of the step
the engine runs (``repro_torch.roofline``, H100 constants; the ragged
step's R rows, or the signature steps (1, 0) and (0, 1)) against
``target_tick_s`` (``serve/autotune.py``), capturing or warming that step.

``kv_dtype="int8"`` stores the pool as int8 values with float32 scales per
(position, kv head), quantized on write. The combine stage is Eq. 1 with a
per-row scale (``cfg``, and ``interval`` with scale 1 outside the interval)
or APG (``apg``), and the guidance policy is ``static``, ``divergence`` or
``interval`` (``repro_torch.core.policy``).

The port differs from the reference in what a framework forces: the
engine takes the port's ``Transformer`` where the reference takes params;
the pool lives on the model's device and is updated in place; there is no
jit, so the first use of a step shape counts as the compile the reference
would pay, under the reference's keys (``step_compiles`` and
``step_launches`` fold to the reference's values); randomness for
temperature > 0 comes from a ``torch.Generator`` seeded per request and
step, not from jax's threefry keys, so sampled tokens differ from the
reference's while greedy tokens are the parity contract; the roofline is
counted, not read off a compiled executable, and the autotuner's budget
rounding is fixed (ROADMAP C).

``mesh`` places the arena's pools by the rule tables (``rules``, the
serve table by default) on a ``DeviceMesh`` (``launch.mesh.make_host_mesh``),
one process a device under ``torch.distributed``: every rank runs this
engine on the same requests (SPMD), the weights replicated, and holds
each pool leaf as a ``DTensor`` (``placed``) whose local tensor, its shard
plus its own spare page or row past it, the steps and kernels run on. On
one device that is the whole pool and the steps are the meshless ones. On
several, the spec decides the path: pages split over ``data`` (the
attention's shard form on each rank's pages, the ranks' (o, lse) gathered
and merged), a slot pool's rows over ``data`` (each row on one rank), kv
heads over ``model`` (each rank attends its heads, gathers every head and
runs the whole o-projection); a dim that does not divide replicates and
needs no exchange. A copy-on-write copy between two owners goes from the
owner of the source page to the owner of the destination. The steps run
eagerly there (``graphs=None`` is off; ``graphs=True`` raises
``ValueError``: a gloo collective cannot be captured, and no card has
tested an NCCL-captured step). With a mesh the default page count rounds
up to a multiple of the pages axis' shard count, as the reference's does.
On several devices the host tier, the content cache, async ticks, MLA and
recurrent stacks, windowed rings and a slot pool split along ``kv_seq``
raise ``NotImplementedError`` (ROADMAP §A), and a ``MeshShape`` (sizes
without devices) raises when the pools are built.
The engine serves every decoder stack of ``Transformer``:
GQA (with qk-norm, windows, MoE FFNs), MLA and recurrent (RG-LRU, mLSTM,
sLSTM) stacks in the slot arena, a row of each pool leaf a slot; GQA stacks
also on pages. The paged arena raises the reference's ``ValueError`` for
MLA latents and recurrent states, which have no pages. An encoder has no
decode step: it raises ``ValueError`` at construction, where the reference
builds the engine and fails at its first tick (ROADMAP C). MoE layers route
each decode row as its own group (the reference's vmap of batch-of-one
rows) and each prefill row over the padded shape the reference runs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import roofline
from repro_torch.core import ar_decode as AR
from repro_torch.core import graphs as G
from repro_torch.core.guidance import apg_combine, cfg_combine_rowscale
from repro_torch.core.policy import (GUIDANCE_POLICIES, DivergenceGuidancePolicy,
                                     DynamicPlanCursor, GuidancePolicy, make_policy)
from repro_torch.core.selective import GuidancePlan, Mode, PlanCursor, round_half_up
from repro_torch.data.tokenizer import EOS, PAD, encode
from repro_torch.dist import exchange as X
from repro_torch.dist.sharding import (RULES_SERVE, MeshShape, as_mesh_shape, local_shape,
                                       spec_placements)
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serve.autotune import BudgetAutotuner
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.obs import TickTimer
from repro_torch.serve.queue import ArrivalQueue, ServeRequest
from repro_torch.serve.scheduler import (Scheduler, TickPlan, admission_cutoff, bucket_pow2,
                                         provision_growth)
from repro_torch.serve.state import (ContentPrefixRegistry, HostPagePool, PageAllocator,
                                     PrefixShareRegistry, StatePool, content_key,
                                     fresh_lazy_needs, host_pages_for_bytes, kv_page_bytes,
                                     paged_partition_specs, pages_for, pages_shard_count,
                                     plan_swap_out, pool_partition_specs, resume_lazy_needs,
                                     stream_page_needs)

KV_MODES = ("slot", "paged")
KV_DTYPES = ("bf16", "int8")
RESERVATION_MODES = ("eager", "lazy")
STEP_MODES = ("signature", "ragged")
PREFIX_CACHE_MODES = ("length", "content")
COMBINE_MODES = ("cfg", "apg", "interval")
TICK_MODES = ("sync", "async")

_bucket = bucket_pow2


_RAGGED_INT = ("tok", "pos", "lstep", "u_idx", "phase")    # int32 rows after the tables


def _views(buf, layout) -> dict:
    """Named views of a flat buffer (a numpy array on the host, a tensor on
    the device), laid out in the order of ``layout``'s (name, shape)."""
    out, at = {}, 0
    for name, shape in layout:
        n = int(np.prod(shape))
        out[name] = buf[at:at + n].reshape(shape)
        at += n
    return out


def _by_slot(slots: list[int], pages: list[int]) -> tuple[list[int], list[int]]:
    """Host slots and the device pages paired with them, in slot order."""
    pairs = sorted(zip(slots, pages))
    return [s for s, _ in pairs], [p for _, p in pairs]


class _SlotArrays:
    """Host-side per-slot scalars (token, position, scale, ...); ``key`` is
    the request's sampling seed."""

    def __init__(self, n: int):
        self.tok = np.zeros(n, np.int32)
        self.pos = np.zeros(n, np.int32)
        self.scale = np.zeros(n, np.float32)
        self.temp = np.zeros(n, np.float32)
        self.lstep = np.zeros(n, np.int32)
        self.key = np.zeros(n, np.uint32)

    def permute(self, src: np.ndarray) -> None:
        for name in ("tok", "pos", "scale", "temp", "lstep", "key"):
            setattr(self, name, getattr(self, name)[src].copy())


class _RequestState:
    def __init__(self, req: ServeRequest, cursor: PlanCursor, slot: int):
        self.req = req
        self.cursor = cursor
        self.slot = slot
        self.generated: list[int] = []
        # True once the uncond stream is dead: reclaimed at the transition,
        # or never allocated (all-COND plan)
        self.uncond_dead = not any(s.mode is Mode.FULL for s in cursor.plan.segments)


class _ResumeState:
    """Checkpoint of a preempted request: its plan step and passes, its
    tokens (the prefill's and one a step), its sampling key, the dynamic
    policy's state and whether its uncond stream is dead. The KV pages are
    freed, and rebuilt at re-admission by one forward over prompt +
    generated[:-1]."""

    def __init__(self, *, step: int, passes: int, generated: list[int], key: int,
                 switch_step: int | None = None, ema: float = 0.0,
                 uncond_dead: bool = False):
        self.step = step
        self.passes = passes
        self.generated = generated
        self.key = key
        self.switch_step = switch_step
        self.ema = ema
        self.uncond_dead = uncond_dead


class _PrefillItem:
    """One admission, normalized for the batched bucketed prefill: a fresh
    one (eager or lazy; a prefix sharer's uncond writes masked), a resume
    (prompt + generated tokens, no token emitted), a resume from the host
    tier (``restore`` pages copied back, no forward) or a content-cache hit
    (``cached`` logits, no forward)."""

    def __init__(self, req: ServeRequest, slot: int, tokens: np.ndarray, true_len: int,
                 key: int, *, u_mask_below: int | None = 0, emit: bool = True,
                 u_tokens: np.ndarray | None = None, shared_pages: int = 0,
                 restore: int = 0, cached: tuple | None = None, hit_pages: int = 0,
                 miss: bool = False, publish_key: str | None = None):
        self.req = req
        self.slot = slot
        self.tokens = tokens              # (true_len,) int32
        self.true_len = true_len
        self.key = key
        self.u_mask_below = u_mask_below  # uncond writes drop below this table
                                          # column (None: all of them)
        self.emit = emit
        self.u_tokens = u_tokens          # the uncond row; None: all PAD
        self.shared_pages = shared_pages  # uncond prefix pages shared
        self.restore = restore            # pages restored from the host tier
        self.cached = cached              # a hit: the founder's (l_u, l_c)
        self.hit_pages = hit_pages        # cond prompt pages shared on a hit
        self.miss = miss                  # the content lookup ran and missed
        self.publish_key = publish_key    # this prefill's logits become the
                                          # content entry's payload


class _DeferredMetrics:
    """Records the metric calls made in the async overlap window: tick t+1's
    admissions are decided while tick t's step runs, but their events
    belong after tick t's token events. ``replay`` re-issues the calls in
    decision order at tick t+1's admit phase, the order a synchronous
    engine (and the simulator) emits."""

    def __init__(self):
        self.calls: list[tuple[str, tuple, dict]] = []

    def __getattr__(self, name: str):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def record(*args, **kwargs):
            self.calls.append((name, args, kwargs))

        return record

    def replay(self, metrics) -> None:
        for name, args, kwargs in self.calls:
            getattr(metrics, name)(*args, **kwargs)


class _AdmitStash:
    """One tick's admission decisions (``_admit_collect``) awaiting their
    bookkeeping (``_admit_bookkeep``): the batch in queue order and, per
    length bucket, (emitting items, token 0, l_c, l_u) as device tensors
    not yet waited for."""

    def __init__(self, batch: list[_PrefillItem], groups: list[tuple]):
        self.batch = batch
        self.groups = groups


class ContinuousEngine:
    """Phase-aware continuous batching over a slot or paged KV arena.

    ``model`` is a ``repro_torch.models.transformer.Transformer`` on the
    device the engine runs on (``Transformer.init`` puts it on the GPU
    unless asked for the CPU). The constructor takes the reference's
    arguments and defaults.
    """

    def __init__(self, model, cfg, *, num_slots: int = 8,
                 pass_budget=None, prompt_len: int = 32,
                 max_new: int = 32, selective_fraction: float = 0.2,
                 rules=None, seed: int = 0, stop_on_eos: bool = True,
                 policy: str = "phase", starvation_limit: int = 4,
                 defrag_threshold: float = 0.5, prefills_per_tick: int = 2,
                 queue_depth: int = 256, bucket: bool = True,
                 kv: str = "slot", page_size: int = 8,
                 num_pages: int | None = None,
                 reservation: str = "eager",
                 kv_dtype: str = "bf16",
                 target_tick_s: float = 50e-3,
                 step_mode: str | None = None,
                 host_pool_bytes: int = 0,
                 swap_min_pages: int | str = 0,
                 prefix_cache: str = "length",
                 guidance_policy: str = "static",
                 divergence_threshold: float = 0.0,
                 divergence_momentum: float = 0.0,
                 combine: str = "cfg",
                 apg_eta: float = 0.0,
                 apg_threshold: float = 0.0,
                 interval: tuple[float, float] = (0.0, 1.0),
                 mesh=None,
                 tick_mode: str = "sync",
                 graphs: bool | None = None):
        # the reference's validation, in its order
        if kv not in KV_MODES:
            raise ValueError(f"kv {kv!r} not in {KV_MODES}")
        if step_mode is None:
            step_mode = "ragged" if kv == "paged" else "signature"
        if step_mode not in STEP_MODES:
            raise ValueError(f"step_mode {step_mode!r} not in {STEP_MODES}")
        if tick_mode not in TICK_MODES:
            raise ValueError(f"tick_mode {tick_mode!r} not in {TICK_MODES}")
        if tick_mode == "async":
            if kv != "paged" or step_mode != "ragged":
                raise ValueError('tick_mode="async" requires kv="paged" and '
                                 'step_mode="ragged" (the pipeline overlaps the ragged step)')
            if stop_on_eos:
                raise ValueError('tick_mode="async" requires stop_on_eos=False: completion '
                                 "must be cursor-driven so tick t+1's admission can be "
                                 "decided before tick t's tokens are harvested")
            if guidance_policy != "static":
                raise ValueError('tick_mode="async" requires guidance_policy="static": a '
                                 "dynamic switch reads tick t's divergence, not yet "
                                 "harvested when t+1 is decided")
        if step_mode == "ragged" and kv != "paged":
            raise ValueError('step_mode="ragged" requires kv="paged" (the '
                             "flat pass list addresses KV through block tables)")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
        if kv_dtype == "int8" and kv != "paged":
            raise ValueError('kv_dtype="int8" requires kv="paged"')
        if reservation not in RESERVATION_MODES:
            raise ValueError(f"reservation {reservation!r} not in {RESERVATION_MODES}")
        if reservation == "lazy" and kv != "paged":
            raise ValueError('reservation="lazy" requires kv="paged" '
                             "(the slot arena reserves whole rows)")
        if prefix_cache not in PREFIX_CACHE_MODES:
            raise ValueError(f"prefix_cache {prefix_cache!r} not in {PREFIX_CACHE_MODES}")
        if prefix_cache == "content" and reservation != "lazy":
            raise ValueError('prefix_cache="content" requires reservation="lazy"')
        if host_pool_bytes < 0:
            raise ValueError(host_pool_bytes)
        if host_pool_bytes and reservation != "lazy":
            raise ValueError('host_pool_bytes requires reservation="lazy" '
                             "(swap-out rides the preemption path)")
        if swap_min_pages != "auto" and (not isinstance(swap_min_pages, int)
                                         or swap_min_pages < 0):
            raise ValueError(f"swap_min_pages {swap_min_pages!r}")
        if swap_min_pages == "auto" and pass_budget != "auto":
            raise ValueError('swap_min_pages="auto" needs the roofline '
                             'latency model: set pass_budget="auto"')
        if guidance_policy not in GUIDANCE_POLICIES:
            raise ValueError(f"guidance_policy {guidance_policy!r} not in "
                             f"{GUIDANCE_POLICIES}")
        if guidance_policy == "divergence" and divergence_threshold <= 0.0:
            raise ValueError('guidance_policy="divergence" needs divergence_threshold > 0')
        if combine not in COMBINE_MODES:
            raise ValueError(f"combine {combine!r} not in {COMBINE_MODES}")
        if not 0.0 <= interval[0] < interval[1] <= 1.0:
            raise ValueError(f"interval {interval!r} must satisfy 0 <= start < stop <= 1")
        if kv == "paged":
            T.check_pageable(cfg)       # the reference's ValueError first
        if cfg.is_encoder:
            # the reference builds this engine and fails at its first tick
            # (ROADMAP C): the port refuses it here
            raise ValueError(f"{cfg.name}: an encoder has no decode step to serve")
        if guidance_policy == "interval" and combine == "cfg":
            # the interval policy's semantics live in the combine stage
            combine = "interval"
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.num_slots = num_slots
        self.prompt_len = prompt_len           # engine-wide maximum
        self.max_new = max_new
        self.capacity = prompt_len + max_new
        # the devices of a DeviceMesh (a MeshShape places nothing)
        self.mesh_devices = 1 if mesh is None or isinstance(mesh, MeshShape) else mesh.size()
        if self.mesh_devices > 1:
            self._check_mesh_options(kv, host_pool_bytes, prefix_cache, tick_mode)
            if graphs:
                raise ValueError(f"graphs=True on a mesh of {self.mesh_devices} devices: the "
                                 "steps run eagerly there (a gloo collective cannot be "
                                 "captured)")
            graphs = False
        if graphs and self.device.type != "cuda":
            raise ValueError("graphs=True needs a model on a CUDA device")
        # every step as a CUDA graph (a port option: None = on a GPU)
        self.graphs = self.device.type == "cuda" if graphs is None else bool(graphs)
        self.selective_fraction = selective_fraction
        if mesh is not None and rules is None:
            # the serve rules already name the pages/page logical axes
            rules = RULES_SERVE
        self.rules = rules
        self.mesh = mesh
        self.placed: dict = {}                 # pool name -> its DTensor leaves, with a mesh
        self._shard: A.MeshShard | None = None  # this rank's share, on several devices
        self.tick_mode = tick_mode
        self.stop_on_eos = stop_on_eos
        self.guidance_policy = guidance_policy
        self.divergence_threshold = divergence_threshold
        self.divergence_momentum = divergence_momentum
        self.combine = combine
        self.apg_eta = apg_eta
        self.apg_threshold = apg_threshold
        self.interval = (float(interval[0]), float(interval[1]))
        self.defrag_threshold = defrag_threshold
        self.prefills_per_tick = prefills_per_tick
        self.bucket = bucket
        self.kv = kv
        self.kv_dtype = kv_dtype
        self.page_size = page_size
        self.nb_max = pages_for(self.capacity, page_size)
        self._budget_auto = pass_budget == "auto"
        self._autotuner = None
        if self._budget_auto:
            self.pass_budget = max(2, num_slots)          # provisional until tuned
            self._autotuner = BudgetAutotuner(target_tick_s, min_budget=2,
                                              max_budget=2 * num_slots)
        else:
            self.pass_budget = pass_budget if pass_budget is not None else num_slots
        self.step_mode = step_mode
        # the ragged step's fixed row count: every tick fits
        self.ragged_rows = 2 * num_slots if self._budget_auto \
            else min(self.pass_budget, 2 * num_slots)
        self.reservation = reservation
        self.queue = ArrivalQueue(max_depth=queue_depth)
        self.pool = StatePool(num_slots)       # slot rows
        self.pages: PageAllocator | None = None
        self._prefix: PrefixShareRegistry | None = None
        self._resume: dict[str, _ResumeState] = {}
        self.page_bytes = 0
        self._pool_shards = pages_shard_count(self.rules, mesh) \
            if (kv == "paged" and mesh is not None) else 1
        if kv == "paged":
            # fails fast on stacks the paged arena cannot hold
            self.page_bytes = kv_page_bytes(cfg, page_size, kv_dtype)
            if num_pages is not None:
                # an explicit count is honored as is: an indivisible pool
                # falls down the allocator's chain instead of resizing
                self.num_pages = num_pages
            else:
                # uniform shard shapes: one whole page multiple a shard
                s = self._pool_shards
                self.num_pages = -(-2 * num_slots * self.nb_max // s) * s
            self.pages = PageAllocator(self.num_pages, page_size, kv_dtype=kv_dtype)
            if reservation == "lazy":
                self._prefix = PrefixShareRegistry(self.pages)
        self.prefix_cache = prefix_cache
        self._content = ContentPrefixRegistry(self.pages) if prefix_cache == "content" \
            else None
        self.scheduler = Scheduler(self.pass_budget, policy=policy,
                                   starvation_limit=starvation_limit)
        self.metrics = ServeMetrics()
        # the host tier: the byte budget in whole pages at the pool's price
        self.host_pool_bytes = host_pool_bytes
        host_pages = host_pages_for_bytes(host_pool_bytes, self.page_bytes)
        if host_pool_bytes and not host_pages:
            raise ValueError(f"host_pool_bytes={host_pool_bytes} affords no whole page "
                             f"(page_bytes={self.page_bytes})")
        self._host = HostPagePool(host_pages, page_bytes=self.page_bytes) if host_pages \
            else None
        self._swap_min_auto = swap_min_pages == "auto"
        self._swap_min = 0 if self._swap_min_auto else int(swap_min_pages)
        self.metrics.page_bytes = self.page_bytes
        self.results: dict[str, list[int]] = {}
        self.tick_count = 0

        self.seed = seed
        self._req_seq = 0
        self._states: dict[str, _RequestState] = {}
        self._slots = _SlotArrays(num_slots)
        self._shapes: set = set()              # step shapes used, by the reference's jit keys
        self._pool_c = None                    # slot: the cond pool, one per layer
        self._pool_u = None                    # slot: the uncond pool
        self._pool_p = None                    # paged: one pool per layer
        self._staging = None                   # the ragged step's host and device rows
        self._ragged_graph = None              # the captured ragged step (graphs)
        self._sig_stagings: dict = {}          # signature bucket key -> its rows
        self._sig_graphs: dict = {}            # signature bucket key -> its captured step
        self._sig_pool = None                  # the signature graphs' memory pool
        # async: (tick, deferred metric calls, admissions) decided in the
        # previous tick's overlap window
        self._stash: tuple | None = None

    def _check_mesh_options(self, kv: str, host_pool_bytes: int, prefix_cache: str,
                            tick_mode: str) -> None:
        """On several devices: refuse what has no sharded form yet."""
        why = None
        if host_pool_bytes > 0:
            why = "the host tier (host_pool_bytes > 0)"
        elif prefix_cache == "content":
            why = 'prefix_cache="content"'
        elif tick_mode == "async":
            why = 'tick_mode="async"'
        elif self.cfg.mla is not None or any(k not in T.ATTN for k in self.cfg.blocks):
            why = f"{self.cfg.name}: MLA latents and recurrent states"
        elif kv == "slot" and any(w is not None for w in self._rings()):
            why = f"{self.cfg.name}: windowed rings in the slot arena"
        if why is not None:
            raise NotImplementedError(f"{why} on a mesh of {self.mesh_devices} devices is not "
                                      "ported (ROADMAP §A)")

    # -- public API --------------------------------------------------------

    def submit(self, req: ServeRequest) -> bool:
        """Queue a request at the current tick; False = rejected (queue
        full, or the request's plan/length is invalid for this engine)."""
        self.metrics.on_arrival(req.uid, self.tick_count)
        try:
            plan = self._plan_for(req)
            plan.validate_for_ar()
            S = self._prompt_len_for(req)
            # a request that can never fit the pool must not wedge the
            # FCFS head of the queue forever
            if self.kv == "paged" and \
                    sum(stream_page_needs(plan, S, self.page_size)) > self.num_pages:
                raise ValueError("page need exceeds pool")
        except ValueError:
            self.metrics.on_reject(req.uid, self.tick_count)
            return False
        ok = self.queue.push(req, self.tick_count)
        if not ok:
            self.metrics.on_reject(req.uid, self.tick_count)
        return ok

    @property
    def _has_pending(self) -> bool:
        """Async: the previous tick's overlap window left events or
        admissions that replay next tick."""
        if self._stash is None:
            return False
        _, rec, stash = self._stash
        return bool(rec.calls) or stash is not None

    def drain(self, max_ticks: int = 100_000) -> None:
        """Tick until queue and slots are empty."""
        while len(self.queue) or self.scheduler.n_active or self._has_pending:
            if self.tick_count >= max_ticks:
                raise RuntimeError(f"engine did not drain in {max_ticks} ticks")
            self.tick()

    def serve(self, requests: list[ServeRequest]) -> dict[str, list[int]]:
        """Submit everything now, drain, return uid -> generated tokens."""
        return self.serve_trace(requests, [0] * len(requests))

    def serve_trace(self, requests: list[ServeRequest], arrivals,
                    max_ticks: int = 100_000) -> dict[str, list[int]]:
        """Drive an arrival trace: ``requests[i]`` is submitted once
        ``arrivals[i]`` ticks (relative to now, non-decreasing) have
        elapsed; drains and returns uid -> generated tokens."""
        start = self.tick_count
        i = 0
        while i < len(requests) or self.scheduler.n_active or len(self.queue) \
                or self._has_pending:
            if self.tick_count - start >= max_ticks:
                raise RuntimeError(f"trace did not drain in {max_ticks} ticks")
            while i < len(requests) and start + int(arrivals[i]) <= self.tick_count:
                self.submit(requests[i])
                i += 1
            self.tick()
        return {r.uid: self.results[r.uid] for r in requests if r.uid in self.results}

    @torch.no_grad()
    def tick(self) -> TickPlan:
        if self.tick_mode == "async":
            return self._tick_async()
        timer = TickTimer(self.tick_count)
        now = self.tick_count
        # metrics objects are replaceable (benchmarks reset them between
        # warm-up and measurement): keep the byte pricing installed
        self.metrics.page_bytes = self.page_bytes
        with timer.phase("admit"):
            self._expire_queue(now)
            if self._autotuner is not None and not self._autotuner.per_pass_s:
                self.autotune_budget()
            if self.kv == "paged":
                self._admit_paged(now)
                self.metrics.note_pages(self.pages.n_in_use, now)
            else:
                self._admit(now)
                self._maybe_defrag()
        with timer.phase("schedule"):
            plan = self._schedule(now)
        with timer.phase("step"):
            sampled, divs = self._execute(plan) if plan.in_flight else ([], [])
        with timer.phase("finalize"):
            events = self.scheduler.commit(plan)
            for ev, nxt, dv in zip(events, sampled, divs):
                state = self._states[ev.uid]
                if ev.done:
                    self._finalize(ev.uid, now)       # last sample discarded
                    continue
                if self.stop_on_eos and nxt == EOS:
                    self._finalize(ev.uid, now)
                    continue
                state.generated.append(int(nxt))
                slot = state.slot
                self._slots.tok[slot] = nxt
                self._slots.pos[slot] += 1
                self._slots.lstep[slot] += 1
                self.metrics.on_token(ev.uid, now, cond=ev.mode is Mode.COND)
                cursor = state.cursor
                if ev.mode is Mode.FULL and isinstance(cursor, DynamicPlanCursor) \
                        and cursor.observe(dv):
                    # the EMA'd cond/uncond divergence crossed the policy's
                    # threshold: every remaining plan-FULL step runs COND
                    self.metrics.on_policy_switch(ev.uid, now, step=cursor.switch_step,
                                                  elided=cursor.elided_uncond_passes())
                if not state.uncond_dead and not cursor.done and cursor.mode is Mode.COND:
                    # the schedule just crossed into COND: the uncond stream
                    # is dead, its pages go back to the shared pool now
                    state.uncond_dead = True
                    self.metrics.on_phase_transition(ev.uid, now)
                    if self.kv == "paged":
                        self.metrics.on_reclaim(ev.uid, now, self._release_uncond(ev.uid))
            self.metrics.record_tick(
                now, n_full=plan.n_full, n_cond=plan.n_cond, budget=plan.budget,
                active=self.scheduler.n_active, queue_depth=len(self.queue),
                pages_in_use=self.pages.n_in_use if self.pages else 0)
        self.metrics.on_tick_timing(timer.finish())
        self.tick_count += 1
        return plan

    def _schedule(self, now: int) -> TickPlan:
        """The tick's plan; under lazy reservation with on-demand growth,
        copy-on-write and priority preemption, the decision procedure the
        simulator replays."""
        plan = self.scheduler.plan_tick()
        if self.reservation == "lazy" and plan.in_flight:
            plan = provision_growth(
                plan, self.scheduler, self.pages, page_size=self.page_size,
                pos_of=lambda uid: int(self._slots.pos[self._states[uid].slot]),
                metrics=self.metrics, preempt=lambda uid: self._preempt(uid, now),
                copy_page=self._copy_page, reclaim_cache=self._reclaim_cache, now=now)
            self.metrics.note_pages(self.pages.n_in_use, now)
        return plan

    def _tick_async(self) -> TickPlan:
        """One pipelined tick. Tick ``now``'s admissions were decided in
        tick ``now - 1``'s overlap window (the stash): their deferred
        events replay and their bookkeeping runs; the ragged step is
        scheduled and dispatched without waiting; the structural finalize
        runs; then, while the device works, tick ``now + 1``'s expiries and
        admissions are decided under a recorder of their events. Only the
        harvest waits for the step. The decisions are the sync tick's own
        procedures, and every event is emitted in the sync order, so
        tokens, counters and events equal ``tick_mode="sync"``'s."""
        timer = TickTimer(self.tick_count)
        now = self.tick_count
        self.metrics.page_bytes = self.page_bytes
        with timer.phase("admit"):
            if self._autotuner is not None and not self._autotuner.per_pass_s:
                self.autotune_budget()
            if self._stash is not None:
                stamp, rec, stash = self._stash
                self._stash = None
                assert stamp == now, (stamp, now)
                rec.replay(self.metrics)
                if stash is not None:
                    self._admit_bookkeep(stash, now)
            elif admission_cutoff(now, pipelined=True) == now:
                # tick 0: no earlier overlap window; the pipeline fills inline
                self._expire_queue(now)
                stash = self._admit_collect(now)
                if stash is not None:
                    self._admit_bookkeep(stash, now)
            self.metrics.note_pages(self.pages.n_in_use, now)
        with timer.phase("schedule"):
            plan = self._schedule(now)
        with timer.phase("step"):
            handles = None
            if plan.in_flight:
                self.metrics.on_step_launch(self.tick_count)
                handles = self._dispatch_ragged(plan)
        with timer.phase("finalize"):
            # the structural finalize, before the overlap window, so that
            # tick now + 1's admissions see the pages a sync tick would have
            # freed; no token value is needed (stop_on_eos is off and the
            # policy static)
            pending = []
            for ev in self.scheduler.commit(plan):
                state = self._states[ev.uid]
                if ev.done:
                    passes = state.cursor.passes_executed
                    self._finalize_state(ev.uid)
                    pending.append(("done", ev.uid, passes))
                    continue
                freed = None
                cursor = state.cursor
                if not state.uncond_dead and not cursor.done and cursor.mode is Mode.COND:
                    state.uncond_dead = True
                    freed = self._release_uncond(ev.uid)
                pending.append(("tok", ev.uid, state.slot, ev.mode, freed))
            # the sync end-of-tick state, before the overlap changes it
            snap = (self.scheduler.n_active, len(self.queue), self.pages.n_in_use)
        with timer.phase("overlap"):
            rec = _DeferredMetrics()
            real, self.metrics = self.metrics, rec
            try:
                self._expire_queue(now + 1)
                stash = self._admit_collect(now + 1)
            finally:
                self.metrics = real
            self._stash = (now + 1, rec, stash)
        with timer.phase("finalize"):
            sampled = self._harvest_ragged(*handles)[0] if handles is not None else []
            for info, nxt in zip(pending, sampled):
                if info[0] == "done":
                    self.metrics.on_complete(info[1], now, info[2])
                    continue
                _, uid, slot, mode, freed = info
                self._states[uid].generated.append(int(nxt))
                self._slots.tok[slot] = nxt
                self._slots.pos[slot] += 1
                self._slots.lstep[slot] += 1
                self.metrics.on_token(uid, now, cond=mode is Mode.COND)
                if freed is not None:
                    self.metrics.on_phase_transition(uid, now)
                    self.metrics.on_reclaim(uid, now, freed)
            self.metrics.record_tick(now, n_full=plan.n_full, n_cond=plan.n_cond,
                                     budget=plan.budget, active=snap[0], queue_depth=snap[1],
                                     pages_in_use=snap[2])
        self.metrics.on_tick_timing(timer.finish())
        self.tick_count += 1
        return plan

    def kv_hbm_bytes(self) -> dict:
        """Reserved vs peak-in-use KV arena bytes, from the page price or the
        sum of one slot row's leaves (``_pool_specs`` on the meta device:
        asking never allocates the pool)."""
        if self.kv == "paged":
            return {"kv": "paged", "kv_dtype": self.kv_dtype,
                    "reserved_bytes": self.num_pages * self.page_bytes,
                    "page_bytes": self.page_bytes,
                    "peak_in_use_bytes": self.metrics.peak_bytes_in_use,
                    "num_pages": self.num_pages,
                    "page_size": self.page_size}
        row_bytes = sum(t.numel() * t.element_size()
                        for layer in self._pool_specs(1, "meta") for t in layer.values())
        peak_active = max((r.active for r in self.metrics.records), default=0)
        return {"kv": "slot", "reserved_bytes": 2 * self.num_slots * row_bytes,
                "row_bytes": 2 * row_bytes,
                "peak_in_use_bytes": int(peak_active * 2 * row_bytes),
                "num_slots": self.num_slots}

    def autotune_budget(self) -> dict:
        """Derive ``pass_budget`` from the roofline of the step the engine
        runs: the ragged step's R rows priced at full packing, or the
        signature steps (1, 0) and (0, 1); each is captured (graphs) or run
        once (eager) on padding rows, as the reference warms its jit cache,
        and its compile counted. Installs the largest budget whose predicted
        tick fits ``target_tick_s`` at the pool's dtype (at most R in ragged
        mode) and, with ``swap_min_pages="auto"``, the restore-vs-recompute
        break-even on the H100's host link. Runs on the first tick under
        ``pass_budget="auto"``. -> the autotuner's report."""
        if self._autotuner is None:
            raise ValueError('autotuning requires pass_budget="auto"')
        if self.kv == "paged":
            if self._pool_p is None:
                self._init_paged_pool()
        elif self._pool_c is None:
            self._init_pools()
        if self.step_mode == "ragged":
            R = self.ragged_rows
            self._autotuner.observe_ragged(R, self.step_roofline((R,), R).seconds,
                                           kv_dtype=self.kv_dtype)
            self._ragged_step(self._stage_ragged([], 0), [])
        else:
            for nf, nc in ((1, 0), (0, 1)):
                forwards = (nf, nf) if nf else (nc,)
                self._autotuner.observe((nf, nc), self.step_roofline(forwards, nf + nc).seconds,
                                        kv_dtype=self.kv_dtype)
                self._signature_step(self._group([], nf, full=True),
                                     self._group([], nc, full=False))
        budget = self._autotuner.budget(self.kv_dtype)
        if self.step_mode == "ragged":
            budget = min(budget, self.ragged_rows)
        self.pass_budget = budget
        self.scheduler.pass_budget = budget
        self.metrics.on_autotune(self.tick_count, budget)
        if self._swap_min_auto and self._host is not None:
            self._swap_min = self._autotuner.swap_break_even_pages(self.page_bytes,
                                                                   kv_dtype=self.kv_dtype)
        return self._autotuner.report(self.kv_dtype)

    def step_roofline(self, forwards: tuple[int, ...], out_rows: int) -> roofline.StepCost:
        """The roofline of a decode step of this engine: ``forwards`` rows
        per decode forward, each row attending its block table's (or slot
        row's) whole capacity, ``out_rows`` combined rows; the weights at
        their dtype, the embedding table once where it is tied, else only
        the unembedding's."""
        weight_bytes = sum(p.numel() * p.element_size() for p in self.model.parameters())
        if not self.cfg.tie_embeddings:
            table = self.model.embed.table
            weight_bytes -= table.numel() * table.element_size()
        tokens = self.nb_max * self.page_size if self.kv == "paged" else self.capacity
        return roofline.decode_step(self.cfg, forwards=forwards, kv_tokens=tokens,
                                    weight_bytes=weight_bytes, out_rows=out_rows,
                                    kv_dtype=self.kv_dtype)

    # -- admission ---------------------------------------------------------

    def _expire_queue(self, now: int) -> None:
        """Expire queued requests past their deadline; a preempted one's
        host checkpoint goes with it."""
        for dead in self.queue.expire(now):
            had_ckpt = self._resume.pop(dead.uid, None) is not None
            self.metrics.on_expire(dead.uid, now)
            if had_ckpt and self._host is not None:
                freed = self._host.drop(dead.uid)
                if freed:
                    self.metrics.on_host_evict(dead.uid, now, freed)

    def _plan_for(self, req: ServeRequest) -> GuidancePlan:
        if req.plan is not None:
            if req.plan.total_steps > self.max_new:
                raise ValueError(f"plan of {req.plan.total_steps} steps "
                                 f"exceeds engine max_new={self.max_new}")
            base = req.plan
        else:
            total = max(1, min(req.max_new_tokens, self.max_new))
            frac = (self.selective_fraction if req.selective_fraction is None
                    else req.selective_fraction)
            base = GuidancePlan.suffix(total, frac, req.guidance_scale)
        # the bound plan: what admission, reservation and the pass budget
        # price, an upper bound on FULL steps
        return self._policy_for(base).bound_plan()

    def _policy_for(self, plan: GuidancePlan) -> GuidancePolicy:
        return make_policy(self.guidance_policy, plan,
                           threshold=self.divergence_threshold,
                           momentum=self.divergence_momentum,
                           interval=self.interval)

    def _cursor_for(self, plan: GuidancePlan, *, step: int = 0, passes: int = 0,
                    switch_step: int | None = None, ema: float = 0.0) -> PlanCursor:
        """The request's cursor through the configured policy;
        ``switch_step``/``ema`` restore a preemption checkpoint's state."""
        policy = self._policy_for(plan)
        if isinstance(policy, DivergenceGuidancePolicy):
            return policy.cursor(step=step, passes_executed=passes,
                                 switch_step=switch_step, ema=ema)
        return policy.cursor(step=step, passes_executed=passes)

    def _eff_scale(self, uid: str, lstep: int | None = None) -> np.float32:
        """Combine-stage guidance scale for ``uid``'s next sample: flat,
        except under interval combine, where it is 1.0 outside
        ``[start, stop)`` of the plan's steps."""
        state = self._states[uid]
        if self.combine != "interval":
            return np.float32(state.req.guidance_scale)
        if lstep is None:
            lstep = int(self._slots.lstep[state.slot])
        total = state.cursor.plan.total_steps
        a = round_half_up(total * self.interval[0])
        b = round_half_up(total * self.interval[1])
        return np.float32(state.cursor.plan.guidance_scale if a <= lstep < b else 1.0)

    def _combine(self, l_u, l_c, scales):
        """The configured combine with a (n,) float32 scale per row: Eq. 1
        (``cfg``/``interval``; B3) or APG (``apg``; B2). Rows paired with
        themselves (u == c) come out as c exactly."""
        if self.combine == "apg":
            return apg_combine(l_u, l_c, scales, eta=self.apg_eta,
                               threshold=self.apg_threshold)
        return cfg_combine_rowscale(l_u, l_c, scales)

    def _sample(self, logits, uids, temps, keys, steps):
        """Next tokens (n,) on the device from logits (n, V) float32. Rows
        ``i < len(uids)`` are requests, the rest padding. Greedy at
        temperature 0; above, a draw (``_draw``)."""
        return self._draw(logits.argmax(dim=-1), logits, uids, temps, keys, steps)

    def _draw(self, nxt, logits, uids, temps, keys, steps):
        """``nxt`` (the argmax of each row of ``logits``) with the rows at
        temperature > 0 drawn from a generator seeded by the request's key
        and ``steps[i]``, as the reference folds its key with the step.
        The draw is ``torch.multinomial(probs, 1)``'s own one-sample form,
        argmax(probs / q) with q ~ Exp(1) from the generator, without its
        checks of the probabilities, which wait for the device."""
        rows = np.flatnonzero(np.asarray(temps[:len(uids)]) > 0)
        if len(rows):
            nxt = nxt.clone()
        for i in rows:
            gen = torch.Generator(device=logits.device)
            gen.manual_seed((int(keys[i]) << 24) + int(steps[i]))
            probs = torch.softmax(logits[i] / float(temps[i]), dim=-1)
            nxt[i] = (probs / torch.empty_like(probs).exponential_(1, generator=gen)).argmax()
        return nxt

    def _prompt_len_for(self, req: ServeRequest) -> int:
        S = self.prompt_len if req.prompt_len is None else req.prompt_len
        if self.kv == "slot":
            if S != self.prompt_len:
                raise ValueError(f"slot arena serves fixed prompt_len={self.prompt_len}, "
                                 f"got {S}")
        elif not 1 <= S <= self.prompt_len:
            raise ValueError(f"prompt_len {S} outside [1, {self.prompt_len}]")
        return S

    def _tokenize(self, prompt, length: int) -> np.ndarray:
        if isinstance(prompt, str):
            ids = encode(prompt, self.cfg.vocab_size, length)
        else:
            ids = list(prompt)[:length]
            ids = ids + [PAD] * (length - len(ids))
        return np.asarray(ids, np.int32)

    def _admit(self, now: int) -> None:
        """Slot arena: admit up to the quota, one prefill of both streams a
        request at ``prompt_len``, into its rows of the two pools."""
        quota = min(self.scheduler.admission_quota(self.pool.n_free),
                    self.prefills_per_tick)
        for _ in range(quota):
            req = self.queue.pop()
            if req is None:
                return
            plan = self._plan_for(req)
            plan.validate_for_ar()
            cursor = self._cursor_for(plan)
            slot = self._admit_common(req, cursor, self.prompt_len)
            state = self._states[req.uid]
            key = self._fresh_key()
            self._slots.lstep[slot] = 0
            self._slots.key[slot] = key
            if self._pool_c is None:
                self._init_pools()
            tok0 = self._prefill_slot(req, slot, key)
            self.metrics.on_admit(req.uid, now, total_steps=plan.total_steps,
                                  full_steps=plan.denoiser_passes() - plan.total_steps)
            if self.stop_on_eos and tok0 == EOS:
                self._finalize(req.uid, now)
                continue
            self._slots.tok[slot] = tok0
            state.generated.append(tok0)
            self.metrics.on_token(req.uid, now)       # TTFT: prefill emits

    def _rings(self) -> list:
        """Each layer's ring size in the slot arena: its window W where W is
        under the row's capacity, else None (a linear row)."""
        windows = (self.model._window(kind, False) for kind in self.cfg.blocks)
        return [w if w is not None and w < self.capacity else None for w in windows]

    def _pool_specs(self, rows: int, device) -> list:
        """One stream's zero pool of ``rows`` rows a layer, the leaves of
        ``prepare_decode_caches`` a row (``transformer.cache_specs``): GQA
        {k, v} (rows, capacity, K, hd) bf16, or for a windowed layer rings
        {k, v (rows, W, K, hd), slot_pos (rows, W)}; MLA latents {c, k_rope}
        (rows, capacity, *); recurrent states (rows, ...)."""
        specs = T.cache_specs(self.cfg, rows, self.capacity, device=device)
        for i, (kind, W) in enumerate(zip(self.cfg.blocks, self._rings())):
            if kind in T.ATTN and self.cfg.mla is None:
                specs[i] = A.cache_spec(self.cfg, rows, self.capacity, device=device) \
                    if W is None else A.ring_pool_spec(self.cfg, rows, W, device=device)
        return specs

    def _init_pools(self) -> None:
        """The slot arena's cond and uncond pools (``_pool_specs``) of
        ``num_slots + 1`` rows. Row ``num_slots`` is a spare that a group's
        padding rows read and write (the reference's out-of-range slot
        index: reads clamp, writes drop); no live row reads it. On a mesh,
        each rank's share of them, with a spare row of its own."""
        if self.mesh is None:
            self._pool_c, self._pool_u = (self._pool_specs(self.num_slots + 1, self.device)
                                          for _ in range(2))
            return
        specs = pool_partition_specs(self.cfg, self.num_slots, self.capacity,
                                     rules=self.rules, mesh=self._device_mesh())
        self._shard = self._mesh_shard(specs[0]["k"], self.num_slots)
        meta = self._pool_specs(self.num_slots + 1, "meta")
        self._pool_c = self._place("c", meta, specs)
        self._pool_u = self._place("u", meta, specs)

    def _prefill_slot(self, req: ServeRequest, slot: int, key: int) -> int:
        """Both streams' prefill of one request into row ``slot`` of the two
        pools, every leaf: a linear row's or MLA latents' first
        ``prompt_len`` positions (what a row holds past them is never read:
        a step writes each position before it attends to it), a ring row's
        last W positions and their slot positions (``cache_from_prefill``),
        a recurrent state whole; -> token 0. MoE layers route the prompt as
        one group of ``prompt_len`` tokens, as the reference's prefill of
        (1, prompt_len)."""
        S = self.prompt_len
        self._seen(("prefill", _bucket(S), 1), step=False)
        tok = self._dev(self._tokenize(req.prompt, S)[None], torch.long)
        l_c, caches_c = AR.prefill(self.model, tok)
        l_u, caches_u = AR.prefill(self.model, AR.null_prompt(tok))
        row, heads = slot, slice(None)
        if self._shard is not None:
            # this rank's share: the row where it holds it, its kv heads
            row -= self._shard.first()
            heads = slice(*self._shard.head_range(self.cfg.num_kv_heads))
        mine = 0 <= row < (self.num_slots if self._shard is None else self._shard.lead_local)
        for pool, caches in ((self._pool_c, caches_c), (self._pool_u, caches_u)):
            for layer, c in zip(pool, caches if mine else ()):
                if "slot_pos" in layer:
                    c = A.cache_from_prefill(c, window=layer["k"].shape[1], seq_len=S)
                    layer["slot_pos"][row] = c.pop("slot_pos")
                elif "k_scale" in layer:                 # REPRO_KV_QUANT=int8 rows
                    c = A.quantize_linear_cache(c)
                for name, t in c.items():
                    if self._shard is not None:
                        t = t[:, :, heads]
                    layer[name][row][tuple(slice(0, n) for n in t.shape[1:])] = t[0]
        scale = self._dev(np.asarray([self._eff_scale(req.uid, 0)], np.float32))
        logits = self._combine(l_u, l_c, scale)
        return int(self._sample(logits, [req.uid], [req.temperature], [key], [0])[0])

    def _maybe_defrag(self) -> None:
        """Compact the slot pools once holes pass ``defrag_threshold``: the
        rows of every leaf (rings with their slot positions, latents,
        float32 recurrent states) permuted in place, so the captured steps'
        addresses hold; the host arrays and the scheduler re-slotted."""
        if self.pool.fragmentation() <= self.defrag_threshold:
            return
        src = self.pool.defrag_plan()
        if src is None or self._pool_c is None:
            return
        self._seen(("defrag",), step=False)
        idx = self._dev(src, torch.long)
        n = self.num_slots
        sh = self._shard
        split = sh is not None and sh.lead.n > 1
        if split:
            # rows split over ranks: every rank's rows gathered, each rank
            # keeping the ones it now holds
            n, first = sh.lead_local, sh.first()
            idx = idx[first:first + n]
        for layer in self._pool_c + self._pool_u:
            for t in layer.values():
                rows = X.all_gather(t[:n], sh.lead).flatten(0, 1) if split else t[:n]
                t[:n] = rows.index_select(0, idx)
        self._slots.permute(src)
        for slot, uid in self.pool.active():
            self._states[uid].slot = slot
            self.scheduler.reslot(uid, slot)

    def _admit_paged(self, now: int) -> None:
        """Sync admission: decide and prefill, then the bookkeeping, in one
        tick. The async tick runs the same two halves a tick apart."""
        stash = self._admit_collect(now)
        if stash is not None:
            self._admit_bookkeep(stash, now)

    def _admit_collect(self, now: int) -> _AdmitStash | None:
        """The decision half: pop admissible requests, claim their slots
        and pages, and dispatch their prefills in per-length-bucket batches
        (one forward serves k > 1 admissions of a bucket); nothing here
        waits for the device. Eager reservation needs the full worst-case
        page span of both streams; lazy the prompt's pages (a shared uncond
        prefix needs none; a content-cache hit none at all), and a
        preempted request re-admits by copying its pages back from the host
        tier, or through the same prefill, its KV rebuilt from prompt +
        generated tokens, emitting no token. -> the stash for
        ``_admit_bookkeep``, None when nothing was admitted."""
        quota = min(self.scheduler.admission_quota(self.pool.n_free),
                    self.prefills_per_tick)
        batch: list[_PrefillItem] = []
        lazy = self.reservation == "lazy"
        while len(batch) < quota:
            req = self.queue.peek()
            if req is None:
                break
            plan, S = self._plan_for(req), self._prompt_len_for(req)
            if lazy and req.uid in self._resume:
                item = self._try_admit_resume(req, plan, S, now)
            elif lazy:
                item = self._try_admit_lazy(req, plan, S, now)
            else:
                item = self._try_admit_eager(req, plan, S)
            if item is None:
                break                         # head-of-line waits for pages
            batch.append(item)
        if not batch:
            return None
        if self._pool_p is None:
            self._init_paged_pool()
        groups: dict[int, list] = {}
        for item in batch:
            if not item.restore and item.cached is None:   # those run no forward
                groups.setdefault(_bucket(item.true_len), []).append(item)
        return _AdmitStash(batch, [self._prefill_paged_group(Sb, groups[Sb])
                                   for Sb in sorted(groups)])

    def _admit_bookkeep(self, stash: _AdmitStash, now: int) -> None:
        """The bookkeeping half: harvest token 0 of the stashed prefills
        (where the host first waits for them), install the founders'
        pre-combine logits as content entries' payloads, replay each hit's
        token 0, and emit the admission events in queue order: share ->
        hit/miss -> admit -> first token, or share -> swap-in -> resume, a
        request at a time, as the simulator does."""
        tok0_of: dict[str, int] = {}
        for items, tok0, l_c, l_u in stash.groups:
            if self._content is not None:
                for i, it in enumerate(items):
                    if it.publish_key:
                        # a hit is ready only on a later tick than the
                        # publish, so installing here never races a lookup
                        self._content.set_payload(it.publish_key,
                                                  (l_u[i].clone(), l_c[i].clone()))
            tok0_of.update(zip((it.req.uid for it in items), tok0.tolist()))
        for it in stash.batch:
            if it.cached is not None:
                tok0_of[it.req.uid] = int(self._hit_sample(it)[0])
        for it in stash.batch:
            uid = it.req.uid
            if it.shared_pages:
                self.metrics.on_share(uid, now, it.shared_pages)
            if it.hit_pages:
                self.metrics.on_prefix_hit(uid, now, it.hit_pages)
            elif it.miss:
                self.metrics.on_prefix_miss(uid, now)
            state = self._states[uid]
            if not it.emit:                   # a resume: KV rebuilt, no token
                if it.restore:
                    self.metrics.on_swap_in(uid, now, it.restore)
                self.metrics.on_resume(uid, now, full=int(state.cursor.mode is Mode.FULL),
                                       from_host=bool(it.restore))
                continue
            plan = state.cursor.plan
            self.metrics.on_admit(uid, now, total_steps=plan.total_steps,
                                  full_steps=plan.denoiser_passes() - plan.total_steps,
                                  cached=it.cached is not None)
            t0 = tok0_of[uid]
            if self.stop_on_eos and t0 == EOS:
                self._finalize(uid, now)
                continue
            self._slots.tok[it.slot] = t0
            state.generated.append(t0)
            self.metrics.on_token(uid, now)           # TTFT: prefill emits

    def _free_for_admission(self, n: int, uid: str, now: int) -> bool:
        """Make ``n`` pages free for a blocked admission by evicting content
        entries: they outlive their users, so an idle pool can be all cache
        with nothing in flight to trigger ``provision_growth``'s reclaim.
        The length-keyed uncond registry is left alone (its entries die
        with their users)."""
        while self.pages.n_free < n:
            if self._content is None or not self._content.evict_under_pressure():
                return False
            self.metrics.on_cache_evict(uid, now)
        return True

    def _admit_common(self, req: ServeRequest, cursor: PlanCursor, pos: int) -> int:
        """Claim a slot, admit to the scheduler, set the slot's scalars."""
        slot = self.pool.alloc(req.uid)
        assert slot is not None
        self._states[req.uid] = _RequestState(req, cursor, slot)
        self.scheduler.admit(req.uid, slot, cursor, arrival=req.arrival,
                             deadline=req.deadline, priority=req.priority)
        self._slots.pos[slot] = pos
        self._slots.scale[slot] = req.guidance_scale
        self._slots.temp[slot] = req.temperature
        return slot

    def _try_admit_eager(self, req: ServeRequest, plan: GuidancePlan,
                         S: int) -> _PrefillItem | None:
        need_c, need_u = stream_page_needs(plan, S, self.page_size)
        if self.pages.n_free < need_c + need_u:
            return None
        self.queue.pop()
        self.pages.alloc(req.uid, "c", need_c)
        if need_u:
            self.pages.alloc(req.uid, "u", need_u)
        slot = self._admit_common(req, self._cursor_for(plan), S)
        key = self._fresh_key()
        self._slots.lstep[slot] = 0
        self._slots.key[slot] = key
        return _PrefillItem(req, slot, self._tokenize(req.prompt, S), S, key)

    def _try_admit_lazy(self, req: ServeRequest, plan: GuidancePlan, S: int,
                        now: int) -> _PrefillItem | None:
        shared = self._prefix.lookup(S) is not None
        need_c, need_u, wants_u = fresh_lazy_needs(plan, S, self.page_size, shared=shared)
        tokens = self._tokenize(req.prompt, S)
        ckey = content_key(tokens) if self._content is not None else None
        if ckey is not None and self._content.ready(ckey, now) \
                and self._content.matches(ckey, tokens) and (not wants_u or shared):
            # the founder's prefill has run and the uncond side (if any) is
            # servable from the length registry: admit with no forward
            return self._admit_prefix_hit(req, plan, S, tokens, ckey, wants_u)
        if not self._free_for_admission(need_c + need_u, req.uid, now):
            return None
        self.queue.pop()
        self.pages.alloc(req.uid, "c", need_c)
        u_mask: int | None = 0                 # the founder writes everything
        n_share = 0
        if wants_u and shared:
            n_share = len(self._prefix.acquire(S, req.uid))
            u_mask = None                      # canonical content: no writes
        elif wants_u:
            self.pages.alloc(req.uid, "u", need_u)
            self._prefix.publish(S, req.uid)   # this prefill is canonical
        slot = self._admit_common(req, self._cursor_for(plan), S)
        key = self._fresh_key()
        self._slots.lstep[slot] = 0
        self._slots.key[slot] = key
        publish_key = None
        if ckey is not None and self._content.lookup(ckey) is None:
            # the cache was cold for this prompt: this prefill's cond prompt
            # pages become its entry, hittable from the next tick
            self._content.publish(ckey, req.uid, ids=tokens, tick=now)
            publish_key = ckey
        return _PrefillItem(req, slot, tokens, S, key, u_mask_below=u_mask,
                            shared_pages=n_share, miss=ckey is not None,
                            publish_key=publish_key)

    def _admit_prefix_hit(self, req: ServeRequest, plan: GuidancePlan, S: int,
                          tokens: np.ndarray, ckey: str, wants_u: bool) -> _PrefillItem:
        """A content-cache hit: share the entry's cond prompt pages (and the
        length-keyed uncond prefix where the plan has a FULL phase); token
        0 replays from the founder's logits, so the admission costs no
        denoiser pass."""
        self.queue.pop()
        got = self._content.acquire(ckey, req.uid)
        n_share = len(self._prefix.acquire(S, req.uid)) if wants_u else 0
        slot = self._admit_common(req, self._cursor_for(plan), S)
        key = self._fresh_key()
        self._slots.lstep[slot] = 0
        self._slots.key[slot] = key
        payload = self._content.payload(ckey)
        assert payload is not None             # ready() waits for the founder's tick
        return _PrefillItem(req, slot, tokens, S, key, u_mask_below=None,
                            shared_pages=n_share, hit_pages=len(got), cached=payload)

    def _try_admit_resume(self, req: ServeRequest, plan: GuidancePlan, S: int,
                          now: int) -> _PrefillItem | None:
        """Re-admit a preempted request: by copying its checkpoint's pages
        back from the host tier where it still holds them (no forward), else
        by recompute: its pages granted afresh (the whole-page uncond prompt
        prefix shared where a canonical copy exists), its KV rebuilt by one
        prefill over prompt + generated tokens. Its checkpoint is
        restored."""
        rs = self._resume[req.uid]
        restore = 0
        if self._host is not None and self._host.holds(req.uid):
            held = self._host.pages_of(req.uid)
            restore = sum(len(v) for v in held.values())
            if not self._free_for_admission(restore, req.uid, now):
                return None
            self.queue.pop()
            del self._resume[req.uid]
            if self._pool_p is None:
                self._init_paged_pool()
            for stream in sorted(held):
                self._restore_pages(held[stream],
                                    self.pages.alloc(req.uid, stream, len(held[stream])))
            self._host.drop(req.uid)
        else:
            shared = self._prefix.lookup(S) is not None
            need_c, need_u, wants_u, n_share = resume_lazy_needs(
                plan, rs.step, S, self.page_size, shared=shared, switch_step=rs.switch_step)
            if not self._free_for_admission(need_c + need_u, req.uid, now):
                return None
            self.queue.pop()
            del self._resume[req.uid]
            self.pages.alloc(req.uid, "c", need_c)
            u_mask: int | None = None
            if wants_u:
                if n_share:
                    self._prefix.acquire(S, req.uid, count=n_share)
                    if need_u:
                        self.pages.grow(req.uid, "u", need_u)
                    u_mask = n_share           # write only the private tail
                else:
                    self.pages.alloc(req.uid, "u", need_u)
                    u_mask = 0
        L = S + rs.step
        cursor = self._cursor_for(plan, step=rs.step, passes=rs.passes,
                                  switch_step=rs.switch_step, ema=rs.ema)
        slot = self._admit_common(req, cursor, L)
        state = self._states[req.uid]
        state.uncond_dead = rs.uncond_dead
        state.generated = list(rs.generated)
        self._slots.tok[slot] = rs.generated[-1]
        self._slots.lstep[slot] = rs.step
        self._slots.key[slot] = rs.key
        if restore:
            return _PrefillItem(req, slot, np.zeros(0, np.int32), L, rs.key,
                                u_mask_below=None, emit=False, restore=restore)
        row = np.concatenate([self._tokenize(req.prompt, S),
                              np.asarray(rs.generated[:-1], np.int32)])
        # the uncond stream consumed the sampled tokens during decode: null
        # the prompt only, replay the generated suffix
        u_row = row.copy()
        u_row[:S] = PAD
        return _PrefillItem(req, slot, row, L, rs.key, u_mask_below=u_mask, emit=False,
                            u_tokens=u_row, shared_pages=n_share if wants_u else 0)

    def _fresh_key(self) -> int:
        key = int(np.random.SeedSequence([self.seed, self._req_seq]).generate_state(1)[0])
        self._req_seq += 1
        return key

    def _prefill_paged_group(self, Sb: int, items: list[_PrefillItem]) -> tuple:
        """Both streams' prefill of one length bucket, padded to a pow2
        count of rows: the forwards, token 0 from each emitting row's last
        position, and the KV scattered through the rows' block tables
        (padding, masked uncond columns and uncovered positions drop). The
        inputs go up from pinned memory without waiting, and nothing is
        brought back: -> (the emitting items, their token 0 (n,), and the
        last position's cond and uncond logits (n, V) float32), device
        tensors not yet waited for."""
        kb = _bucket(len(items))
        self._seen(("prefill", Sb, kb), step=False)
        nb_pre = pages_for(Sb, self.page_size)
        tokens = np.full((kb, Sb), PAD, np.int32)
        tokens_u = np.full((kb, Sb), PAD, np.int32)    # PAD == the null token
        true_len = np.ones(kb, np.int64)
        btc = np.full((kb, nb_pre), self.num_pages, np.int32)
        btu = np.full((kb, nb_pre), self.num_pages, np.int32)
        for i, it in enumerate(items):
            tokens[i, :it.true_len] = it.tokens
            if it.u_tokens is not None:
                tokens_u[i, :it.true_len] = it.u_tokens
            true_len[i] = it.true_len
            btc[i] = self.pages.table(it.req.uid, "c", nb_pre)
            tu = self.pages.table(it.req.uid, "u", nb_pre)
            tu[:len(tu) if it.u_mask_below is None else it.u_mask_below] = self.num_pages
            btu[i] = tu
        model, ps = self.model, self.page_size
        h_c, caches_c, _ = model(self._dev(tokens, torch.long), want_caches=True)
        h_u, caches_u, _ = model(self._dev(tokens_u, torch.long), want_caches=True)
        col = np.arange(Sb) // ps
        offs = self._dev(np.tile(np.arange(Sb) % ps, kb))
        pages_c = self._dev(btc[:, col].reshape(-1))
        pages_u = self._dev(btu[:, col].reshape(-1))
        for pool, cc, cu in zip(self._pool_p, caches_c, caches_u):
            A.paged_scatter_prefill(pool, cc, pages_c, offs, self._shard)
            A.paged_scatter_prefill(pool, cu, pages_u, offs, self._shard)
        emit = [i for i, it in enumerate(items) if it.emit]
        out = [items[i] for i in emit]
        if not emit:
            empty = torch.zeros(0, device=self.device)
            return out, empty.long(), empty, empty
        rows = self._dev(np.asarray(emit))
        last = self._dev(true_len[emit] - 1)
        l_c = model.unembed(h_c[rows, last][:, None])[:, 0].float()
        l_u = model.unembed(h_u[rows, last][:, None])[:, 0].float()
        scales = np.asarray([self._eff_scale(it.req.uid, 0) for it in out], np.float32)
        logits = self._combine(l_u, l_c, self._dev(scales))
        tok0 = self._sample(logits, [it.req.uid for it in out],
                            [it.req.temperature for it in out], [it.key for it in out],
                            np.zeros(len(out), np.int64))
        return out, tok0, l_c, l_u

    def _hit_sample(self, it: _PrefillItem):
        """Token 0 of a content-cache hit: the configured combine over the
        founder's cached pre-combine logits with the hit's own scale, then
        the hit's own draw at step 0, as its cold prefill would take it. ->
        (1,) on the device."""
        l_u, l_c = it.cached
        scale = self._dev(np.asarray([self._eff_scale(it.req.uid, 0)], np.float32))
        logits = self._combine(l_u[None], l_c[None], scale)
        return self._sample(logits, [it.req.uid], [it.req.temperature], [it.key], [0])

    def _release_uncond(self, uid: str) -> int:
        """Free a request's unconditional pages at the COND transition, and
        its prefix-registry membership with them (canonical pages that this
        frees count too)."""
        freed = self.pages.free(uid, "u")
        if self._prefix is not None:
            freed += self._prefix.release(uid)
        return freed

    def _reclaim_cache(self) -> bool:
        """Pool pressure: evict a cache entry, the content tier first (its
        entries are pure cache, recomputable from the prompt), then a
        length-keyed uncond prefix entry."""
        if self._content is not None and self._content.evict_under_pressure():
            return True
        return self._prefix.evict_under_pressure()

    def _preempt(self, uid: str, now: int) -> None:
        """Evict ``uid`` back to the front of the queue: its pages freed for
        the preemptor, its cursor, tokens and key checkpointed, so that its
        resume is token-identical to an uninterrupted run. With a host tier
        its pages are copied out first, unless ``plan_swap_out`` says
        recompute (events: preempt -> host_evict* -> swap_out, as the
        simulator replays them)."""
        state = self._states.pop(uid)
        self._resume[uid] = _ResumeState(
            step=state.cursor.step, passes=state.cursor.passes_executed,
            generated=list(state.generated), key=int(self._slots.key[state.slot]),
            switch_step=getattr(state.cursor, "switch_step", None),
            ema=getattr(state.cursor, "ema", 0.0), uncond_dead=state.uncond_dead)
        self.pool.free(state.slot)
        self.metrics.on_preempt(uid, now)
        swap = plan_swap_out(self.pages, self._host, uid, min_pages=self._swap_min)
        if swap is not None:
            placed, evicted = self._host.put(uid, swap)     # plan_swap_out checked the fit
            for euid, n_freed in evicted:
                self.metrics.on_host_evict(euid, now, n_freed)
            self._swap_out(uid, swap, placed)
            self.metrics.on_swap_out(uid, now, sum(swap.values()))
        self.pages.free_all(uid)
        self._prefix.release(uid)
        if self._content is not None:
            self._content.release(uid)
        self.scheduler.release(uid)
        self.queue.requeue(state.req)

    def _copy_page(self, src: int, dst: int) -> None:
        """The copy behind a copy-on-write detach: page ``src`` to ``dst`` in
        every layer's pool, values and (int8) scales. With pages split over
        ranks, the owner of ``src`` copies it locally or sends it, every
        leaf in one message, to the owner of ``dst``."""
        sh = self._shard
        leaves = [t for pool in self._pool_p for t in pool.values()]
        if sh is None or sh.lead.n == 1:
            for t in leaves:
                t[dst] = t[src]
            return
        (a, src), (b, dst) = divmod(src, sh.lead_local), divmod(dst, sh.lead_local)
        me = sh.lead.index
        if a == b == me:
            for t in leaves:
                t[dst] = t[src]
        elif a == me:
            X.send(torch.cat([t[src].reshape(-1).view(torch.uint8) for t in leaves]), sh.lead, b)
        elif b == me:
            sizes = [t[dst].numel() * t.element_size() for t in leaves]
            buf = X.recv(sum(sizes), sh.lead, a, self.device)
            for t, part in zip(leaves, buf.split(sizes)):
                t[dst] = part.view(t.dtype).reshape(t[dst].shape)

    def _swap_out(self, uid: str, swap: dict[str, int], placed: dict[str, list[int]]) -> None:
        """Copy a preemption victim's pages into its host slots, stream by
        stream: one gather a leaf of the stream's pages in the order of
        their host slots (so that consecutive slots take one copy), padded
        to a pow2 count with page 0 (values and int8 scales through the
        same indices), then the copies into the arena, none waited for."""
        for stream in sorted(swap):
            slots, pages = _by_slot(placed[stream], self.pages.owned(uid, stream))
            n, nb = len(pages), _bucket(len(pages))
            self._seen(("hgather", nb), step=False)
            idx = np.zeros(nb, np.int64)
            idx[:n] = pages
            idx = self._dev(idx)
            rows = [{name: t.index_select(0, idx) for name, t in layer.items()}
                    for layer in self._pool_p]
            self._host.store(slots, rows)

    def _restore_pages(self, host_slots: list[int], dev_pages: list[int]) -> None:
        """Copy host-tier page rows into freshly granted device pages, read
        in the order of their host slots: one scatter a leaf, padded to a
        pow2 count of rows addressed at the spare page (the out-of-range
        index: the writes drop)."""
        host_slots, dev_pages = _by_slot(host_slots, dev_pages)
        n, nb = len(dev_pages), _bucket(len(dev_pages))
        self._seen(("hscatter", nb), step=False)
        idx = np.full(nb, self.num_pages, np.int64)
        idx[:n] = dev_pages
        idx = self._dev(idx)
        for layer, rows in zip(self._pool_p, self._host.load(host_slots, self.device)):
            for name, t in layer.items():
                src = rows[name]
                if nb > n:
                    src = torch.cat([src, src.new_zeros((nb - n,) + src.shape[1:])])
                t.index_copy_(0, idx, src)

    def _finalize_state(self, uid: str) -> _RequestState:
        """The structural half of completion: free the slot, pages and
        registry memberships and publish the result. The async tick runs it
        before its overlap window and emits ``complete`` at the harvest."""
        state = self._states.pop(uid)
        self.pool.free(state.slot)
        if self.pages is not None:
            self.pages.free_all(uid)
            if self._prefix is not None:
                self._prefix.release(uid)
            if self._content is not None:
                self._content.release(uid)
        self.scheduler.release(uid)
        self.results[uid] = state.generated
        return state

    def _finalize(self, uid: str, now: int) -> None:
        state = self._finalize_state(uid)
        self.metrics.on_complete(uid, now, state.cursor.passes_executed)

    # -- step functions ------------------------------------------------------

    def _dev(self, a, dtype=None):
        """A host array on the engine's device: on a GPU through a pinned
        copy, uploaded without waiting (the host allocator keeps the pinned
        block until the copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device, dtype=dtype)

    def _init_paged_pool(self) -> None:
        """The page pool, and the host tier's arena beside it (pinned for a
        GPU pool: allocated here, not in the tick that first swaps). On a
        mesh, this rank's share of it, with a spare page of its own."""
        if self.mesh is None:
            self._pool_p = T.paged_cache_specs(self.cfg, self.num_pages, self.page_size,
                                               kv_dtype=self.kv_dtype, device=self.device)
        else:
            specs = paged_partition_specs(self.cfg, self.num_pages, self.page_size,
                                          rules=self.rules, mesh=self._device_mesh(),
                                          kv_dtype=self.kv_dtype)
            self._shard = self._mesh_shard(specs[0]["k"], self.num_pages)
            meta = T.paged_cache_specs(self.cfg, self.num_pages, self.page_size,
                                       kv_dtype=self.kv_dtype, device="meta")
            self._pool_p = self._place("p", meta, specs)
        if self._host is not None:
            self._host.attach(self._pool_p)

    def _device_mesh(self):
        if isinstance(self.mesh, MeshShape):
            raise NotImplementedError("a MeshShape has sizes and no devices: the arena cannot "
                                      "be placed on it (ROADMAP §A); pass a DeviceMesh "
                                      "(launch.mesh.make_host_mesh)")
        return self.mesh

    def _place(self, name: str, meta: list, specs: list) -> list:
        """This rank's share of a pool: ``meta`` the meshless pool's leaves
        on the meta device (a spare page or row past the reference's pool
        sizes), ``specs`` their specs at the reference's sizes. Each leaf's
        shard (``local_shape``) is allocated empty on this device with a
        spare page or row of its own past it, and, without the spare, is
        the local tensor of a ``DTensor`` of the reference's shape, kept in
        ``placed[name]``. -> the local tensors with their spares, which
        share the DTensors' storage: what the steps write in place, the
        DTensors hold. No rank allocates more than its shard and spare."""
        from torch.distributed.tensor import DTensor
        sizes = as_mesh_shape(self.mesh)
        local, self.placed[name] = [], []
        for layer, lspecs in zip(meta, specs):
            local.append({})
            self.placed[name].append({})
            for n, t in layer.items():
                full = (t.shape[0] - 1,) + tuple(t.shape[1:])
                part = local_shape(full, lspecs[n], sizes)
                # a ring's slot positions start empty (-1, as ring_pool_spec
                # makes them), every other leaf at zero
                z = torch.full((part[0] + 1,) + part[1:], -1 if n == "slot_pos" else 0,
                               dtype=t.dtype, device=self.device)
                local[-1][n] = z
                self.placed[name][-1][n] = DTensor.from_local(
                    z[:-1], self.mesh, spec_placements(lspecs[n], self.mesh), run_check=False,
                    shape=torch.Size(full), stride=torch.empty(full, device="meta").stride())
        return local

    def _mesh_shard(self, spec, lead: int) -> A.MeshShard | None:
        """This rank's ``MeshShard`` from the spec of a pool's K leaf: (pages,
        page, kv heads, head_dim) or (rows, kv_seq, kv heads, head_dim) over
        ``lead`` pages or rows. None on one device or where nothing splits;
        a slot pool split along kv_seq raises."""
        if self.mesh_devices == 1:
            return None
        spec = tuple(spec) + (None,) * 4
        if X.split_of(self.mesh, spec[1]).n > 1:
            raise NotImplementedError(
                f"a slot pool split along kv_seq ({spec[1]!r}) on a mesh of "
                f"{self.mesh_devices} devices needs a shard form of B5 (ROADMAP §A)")
        first, heads = X.split_of(self.mesh, spec[0]), X.split_of(self.mesh, spec[2])
        if first.n == 1 and heads.n == 1:
            return None
        return A.MeshShard(first, lead // first.n, heads)

    def _seen(self, key: tuple, *, step: bool) -> None:
        """Note the first use of a step shape: what the reference counts as
        a compile at jit-cache-miss time (``step_compiles`` for steps)."""
        if key not in self._shapes:
            self._shapes.add(key)
            if step:
                self.metrics.on_step_compile(self.tick_count)

    def _signature_step(self, f: dict, c: dict):
        """Mixed-phase decode step for one occupancy signature: the FULL
        group's two streams and the COND group's cond stream, each row at
        its own position, read and written in place in its slot's row (B5
        per row) or through its block tables (B9/B10). The groups' rows are
        staged into the bucket's fixed device buffers; the step runs eagerly
        without ``graphs``, else as the bucket's graph, captured at its first
        use (the reference's compile) and replayed after, the rows at
        temperature > 0 drawn after the replay. -> (next tokens of each
        group, FULL divergences), None for an empty group."""
        nf, nc = len(f["tok"]), len(c["tok"])
        key = ("pstep" if self.kv == "paged" else "step", nf, nc)
        self._seen(key, step=True)
        st = self._sig_stagings.get(key)
        if st is None:
            st = self._sig_stagings[key] = self._new_staging(*self._signature_layout(nf, nc))
        for name, view in st["host"].items():
            group, field = name.split("_", 1)
            view[...] = (f if group == "f" else c)[field]
        self._upload(st)
        if not self.graphs:
            out = self._signature_forward(st["dev"], nf, nc)
        elif key not in self._sig_graphs:
            if self._sig_pool is None:
                self._sig_pool = G.pool()
            self._sig_graphs[key], out = G.capture(
                lambda: self._signature_forward(st["dev"], nf, nc, argmax=True), self._sig_pool)
        else:
            out = self._sig_graphs[key].replay()
        f_nxt, f_logits, f_div, c_nxt, c_logits = out
        return (self._pick(f_nxt, f_logits, f) if nf else None,
                self._pick(c_nxt, c_logits, c) if nc else None, f_div)

    def _pick(self, nxt, logits, g: dict):
        """A group's next tokens: sampled from its logits (eager), or the
        graph's argmax with the hot rows drawn (graphed)."""
        if not self.graphs:
            return self._sample(logits, g["uids"], g["temp"], g["key"], 1 + g["lstep"])
        return self._draw(nxt, logits, g["uids"], g["temp"], g["key"], 1 + g["lstep"])

    def _signature_layout(self, nf: int, nc: int) -> tuple[list, list]:
        """(int32, float32) layouts of one signature bucket's device rows:
        each group's tokens, positions, and slot rows (slot arena) or block
        tables (pages); the FULL group's scales."""
        ints = []
        for group, n, streams in (("f", nf, "cu"), ("c", nc, "c")):
            if not n:
                continue
            ints += [(f"{group}_tok", (n,)), (f"{group}_pos", (n,))]
            if self.kv == "slot":
                ints.append((f"{group}_rows", (n,)))
            else:
                ints += [(f"{group}_bt{s}", (n, self.nb_max)) for s in streams]
        return ints, [("f_scale", (nf,))] if nf else []

    def _signature_forward(self, dev: dict, nf: int, nc: int, argmax: bool = False):
        """The signature step on the device rows ``dev``. -> (FULL group's
        argmax or None, combined logits (nf, V) float32, divergences; COND
        group's argmax or None, logits), None for an empty group's."""
        model = self.model
        out = [None] * 5
        if nf:
            emb = model.embed_tokens(dev["f_tok"].long()[:, None])
            h_c, h_u = (self._decode_rows(emb, dev, "f", s) for s in "cu")
            l_c = model.unembed(h_c)[:, 0, :].float()
            l_u = model.unembed(h_u)[:, 0, :].float()
            logits = self._combine(l_u, l_c, dev["f_scale"])
            out[:3] = (logits.argmax(dim=-1) if argmax else None, logits,
                       torch.sqrt(((l_c - l_u) ** 2).sum(-1)))
        if nc:
            emb = model.embed_tokens(dev["c_tok"].long()[:, None])
            logits = model.unembed(self._decode_rows(emb, dev, "c", "c"))[:, 0, :].float()
            out[3:] = (logits.argmax(dim=-1) if argmax else None, logits)
        return tuple(out)

    def _decode_rows(self, emb, dev: dict, group: str, stream: str):
        """One decode forward of ``group``'s rows on ``stream``'s KV. ->
        hidden (n, 1, D)."""
        pos = dev[f"{group}_pos"]
        if self.kv == "slot":
            pool = self._pool_c if stream == "c" else self._pool_u
            return self.model.decode_step(emb, pool, pos, rows=dev[f"{group}_rows"],
                                          shard=self._shard)[0]
        return self.model.decode_step_paged(emb, self._pool_p, dev[f"{group}_bt{stream}"],
                                            pos, shard=self._shard)[0]

    def _ragged_step(self, st: dict, uids: list):
        """One fixed-shape decode step for the whole tick's flat pass list
        (B7/B8): the graph's replay, or, at the step's first use (the
        reference's compile), its capture; eager without ``graphs``."""
        self._seen(("rstep", self.ragged_rows), step=True)
        host = st["host"]
        if not self.graphs:
            nxt, div, combined = self._ragged_forward(st["dev"])
            return self._sample(combined, uids, host["temp"], host["rkey"],
                                1 + host["lstep"]), div
        if self._ragged_graph is None:
            self._ragged_graph, (nxt, div, combined) = G.capture(
                lambda: self._ragged_forward(st["dev"], argmax=True), G.pool())
        else:
            nxt, div, combined = self._ragged_graph.replay()
        return self._draw(nxt, combined, uids, host["temp"], host["rkey"],
                          1 + host["lstep"]), div

    def _ragged_forward(self, dev: dict, argmax: bool = False):
        """The ragged step on the device rows ``dev``. ``u_idx[r]`` names the
        row carrying row r's unconditional logits: the uncond pair row for
        FULL output rows, r itself everywhere else, where the combine
        returns c exactly. -> (argmax of each combined row, or None; per-row
        divergence; the combined logits (R, V) float32)."""
        model = self.model
        emb = model.embed_tokens(dev["tok"].long()[:, None])
        h, _ = model.decode_step_paged(emb, self._pool_p, dev["bt"], dev["pos"],
                                       phase=dev["phase"], shard=self._shard)
        logits = model.unembed(h)[:, 0, :].float()
        u_idx = dev["u_idx"].long()
        combined = self._combine(logits[u_idx], logits, dev["scale"])
        # per-output-row divergence; self-paired rows read exactly 0
        div = torch.sqrt(((logits - logits[u_idx]) ** 2).sum(-1))
        return (combined.argmax(dim=-1) if argmax else None), div, combined

    # -- execution ---------------------------------------------------------

    def _execute(self, plan: TickPlan) -> tuple[list[int], list[float]]:
        """Run one mixed-phase step; returns sampled next-tokens and the
        per-entry cond/uncond divergence norms (0.0 for COND entries), both
        aligned with ``plan.full + plan.cond``."""
        self.metrics.on_step_launch(self.tick_count)
        if self.step_mode == "ragged":
            return self._harvest_ragged(*self._dispatch_ragged(plan))
        nf_b = _bucket(plan.n_full) if self.bucket else plan.n_full
        nc_b = _bucket(plan.n_cond) if self.bucket else plan.n_cond
        f_next, c_next, f_div = self._signature_step(self._group(plan.full, nf_b, full=True),
                                                     self._group(plan.cond, nc_b, full=False))
        toks = [] if f_next is None else f_next[:plan.n_full].tolist()
        toks += [] if c_next is None else c_next[:plan.n_cond].tolist()
        divs = [] if f_div is None else f_div[:plan.n_full].tolist()
        return toks, divs + [0.0] * plan.n_cond

    def _group(self, entries, n: int, *, full: bool) -> dict:
        """Host rows of one signature group, padded to ``n`` with
        out-of-range tables (reads clamp, writes drop), or in the slot arena
        with the spare row."""
        slots = np.asarray([e.slot for e in entries], np.int64)
        pad = n - len(slots)

        def take(a):
            return np.concatenate([a[slots], np.zeros(pad, a.dtype)])

        g = {"uids": [e.uid for e in entries], "tok": take(self._slots.tok),
             "pos": take(self._slots.pos), "temp": take(self._slots.temp),
             "key": take(self._slots.key), "lstep": take(self._slots.lstep)}
        if full:
            if self.combine == "interval":
                g["scale"] = np.asarray([self._eff_scale(e.uid) for e in entries] + [0.0] * pad,
                                        np.float32)
            else:
                g["scale"] = take(self._slots.scale)
        if self.kv == "slot":
            g["rows"] = np.concatenate([slots, np.full(pad, self.num_slots)]).astype(np.int32)
            return g
        for stream in ("c", "u") if full else ("c",):
            bt = np.full((n, self.nb_max), self.num_pages, np.int32)
            for i, e in enumerate(entries):
                bt[i] = self.pages.table(e.uid, stream, self.nb_max)
            g["bt" + stream] = bt
        return g

    def _new_staging(self, ints: list, floats: list) -> dict:
        """A step's rows: one int32 and one float32 host buffer (pinned on a
        GPU) laid out as ``ints`` and ``floats`` (``_views``), and the fixed
        device buffers that each tick's rows are copied into (a captured
        step reads them there), with named views of both."""
        pin = self.device.type == "cuda"
        bufs = {}
        for name, layout, dtype in (("ibuf", ints, torch.int32), ("fbuf", floats, torch.float32)):
            n = max(1, sum(int(np.prod(shape)) for _, shape in layout))
            bufs[name] = torch.zeros(n, dtype=dtype, pin_memory=pin)
            bufs["dev_" + name] = torch.zeros(n, dtype=dtype, device=self.device)
        return dict(bufs, host={**_views(bufs["ibuf"].numpy(), ints),
                                **_views(bufs["fbuf"].numpy(), floats)},
                    dev={**_views(bufs["dev_ibuf"], ints), **_views(bufs["dev_fbuf"], floats)})

    @staticmethod
    def _upload(st: dict) -> None:
        """The staged rows to the device: two copies that do not wait."""
        st["dev_ibuf"].copy_(st["ibuf"], non_blocking=True)
        st["dev_fbuf"].copy_(st["fbuf"], non_blocking=True)

    def _ragged_staging(self) -> dict:
        """The ragged step's rows: block tables (R, nb), R int32 values per
        name of ``_RAGGED_INT``, scales and temperatures; the sampling keys
        on the host alone."""
        if self._staging is None:
            R = self.ragged_rows
            self._staging = self._new_staging(
                [("bt", (R, self.nb_max))] + [(name, (R,)) for name in _RAGGED_INT],
                [("scale", (R,)), ("temp", (R,))])
            self._staging["host"]["rkey"] = np.zeros(R, np.uint32)
        return self._staging

    def _stage_ragged(self, rows: list, n_full: int) -> dict:
        """Write a tick's pass rows into the ragged step's staging and copy
        them up, without waiting. Row layout (``TickPlan.pass_rows``): the
        output rows first, every entry's cond pass in ``plan.full +
        plan.cond`` order, then the FULL entries' uncond passes; the rest
        padding (phase 0, out-of-range tables). -> the staging."""
        R = self.ragged_rows
        assert len(rows) <= R, (len(rows), R)
        n_out = len(rows) - n_full
        st = self._ragged_staging()
        h = st["host"]
        h["bt"].fill(self.num_pages)
        for name in ("tok", "pos", "lstep", "phase", "scale", "temp", "rkey"):
            h[name].fill(0)
        h["u_idx"][:] = np.arange(R, dtype=np.int32)   # self-pair: Eq. 1 identity
        for r, pr in enumerate(rows):
            slot = pr.entry.slot
            h["bt"][r] = self.pages.table(pr.entry.uid, pr.stream, self.nb_max)
            h["tok"][r] = self._slots.tok[slot]
            h["pos"][r] = self._slots.pos[slot]
            h["scale"][r] = self._eff_scale(pr.entry.uid) \
                if self.combine == "interval" else self._slots.scale[slot]
            h["temp"][r] = self._slots.temp[slot]
            h["rkey"][r] = self._slots.key[slot]
            h["lstep"][r] = self._slots.lstep[slot]
            h["phase"][r] = 1
        h["u_idx"][:n_full] = n_out + np.arange(n_full)
        self._upload(st)
        return st

    def _dispatch_ragged(self, plan: TickPlan) -> tuple:
        """Stage the tick's rows and launch the ragged step; nothing here
        waits for the device. -> (next tokens, divergences, n_out), device
        tensors not yet waited for."""
        rows = plan.pass_rows()
        st = self._stage_ragged(rows, plan.n_full)
        n_out = plan.in_flight
        nxt, div = self._ragged_step(st, [pr.entry.uid for pr in rows[:n_out]])
        return nxt, div, n_out

    def _harvest_ragged(self, nxt, div, n_out: int) -> tuple:
        """Bring the step's outputs to the host: the only point where the
        host waits for the device in ragged mode."""
        return nxt[:n_out].tolist(), div[:n_out].tolist()
