"""Arena state of the serve stack: slot pool, ref-counted page allocator,
prefix-share registries and the host tier's bookkeeping.

Copy of the framework-free part of ``repro/serve/state.py``:
``StatePool``, ``pages_for``, ``page_nbytes``, ``kv_page_bytes`` (computed
from the config here, not from abstract specs), ``pages_for_pool_bytes``,
the eager and lazy page needs, ``PageAllocator`` with the share registries
and ``content_key``, ``HostPagePool`` (its bookkeeping, and its storage
arena on torch tensors, pinned beside a GPU pool) with ``plan_swap_out``.
The pooled arenas' sharding helpers (``pooled_cache_axes``,
``pool_partition_specs``, ``paged_partition_specs``, ``pages_shard_count``,
``paged_pool_shardings``) over ``repro_torch.dist``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.selective import Mode, PlanCursor
from repro_torch.dist.sharding import (AxisRules, as_mesh_shape, logical_to_spec, mesh_sizes,
                                       tree_shardings)
from repro_torch.models import transformer as T
from repro_torch.models.layers import is_axes_leaf, map_axes
from repro_torch.models.transformer import check_pageable

class StatePool:
    """Allocator over ``num_slots`` arena rows. Lowest-index-first alloc
    keeps the active set near the front, which slows fragmentation."""

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError(num_slots)
        self.num_slots = num_slots
        self._uid_of: dict[int, str] = {}
        self._slot_of: dict[str, int] = {}

    # -- alloc / free ------------------------------------------------------

    @property
    def n_active(self) -> int:
        return len(self._uid_of)

    @property
    def n_free(self) -> int:
        return self.num_slots - self.n_active

    def alloc(self, uid: str) -> int | None:
        """Claim the lowest free slot for ``uid``; None when full."""
        if uid in self._slot_of:
            raise ValueError(f"uid {uid!r} already resident")
        if self.n_free == 0:
            return None
        slot = min(s for s in range(self.num_slots) if s not in self._uid_of)
        self._uid_of[slot] = uid
        self._slot_of[uid] = slot
        return slot

    def free(self, slot: int) -> None:
        uid = self._uid_of.pop(slot)
        del self._slot_of[uid]

    def slot_of(self, uid: str) -> int:
        return self._slot_of[uid]

    def uid_of(self, slot: int) -> str:
        return self._uid_of[slot]

    def active(self) -> list[tuple[int, str]]:
        """(slot, uid) pairs, slot-ordered."""
        return sorted(self._uid_of.items())

    # -- defragmentation ---------------------------------------------------

    def fragmentation(self) -> float:
        """Fraction of holes below the highest active slot (0 = compact)."""
        if not self._uid_of:
            return 0.0
        top = max(self._uid_of)
        holes = (top + 1) - self.n_active
        return holes / (top + 1)

    def defrag_plan(self) -> np.ndarray | None:
        """Permutation ``src`` compacting active slots to a prefix, or None
        if already compact.

        ``new_pool[i] = old_pool[src[i]]``: the first ``n_active`` entries
        of ``src`` are the old active slots in order; the remainder are the
        old free slots (their contents are garbage either way). Applying
        the plan also remaps this pool's own slot table.
        """
        active = [s for s, _ in self.active()]
        if active == list(range(len(active))):
            return None
        free = [s for s in range(self.num_slots) if s not in self._uid_of]
        src = np.asarray(active + free, np.int32)
        remap = {old: new for new, old in enumerate(active)}
        self._uid_of = {remap[s]: u for s, u in self._uid_of.items()}
        self._slot_of = {u: s for s, u in self._uid_of.items()}
        return src


# ---------------------------------------------------------------------------
# Paged arena: ref-counted page allocator + block-table registry
# ---------------------------------------------------------------------------


def pages_for(span: int, page_size: int) -> int:
    """Pages needed to cover ``span`` positions (0 positions -> 0 pages)."""
    if span <= 0:
        return 0
    return -(-span // page_size)


def page_nbytes(page_size: int, kv_heads: int, head_dim: int,
                n_layers: int, kv_dtype: str = "bf16") -> int:
    """Physical HBM bytes one page pins across the whole stack — the
    model-free form shared by the simulator and the golden-trace harness
    (the engine derives the same number from its abstract specs;
    ``tests/test_quant.py`` pins that they agree).

    Per (position, kv-head): K+V values at 2 bytes (bf16) or 1 byte
    (int8), plus two fp32 scales when int8 (DESIGN.md §11). The pool is
    per-layer, so the page spans ``n_layers`` copies.
    """
    if kv_dtype == "bf16":
        per_poshead = 2 * head_dim * 2
    elif kv_dtype == "int8":
        per_poshead = 2 * head_dim * 1 + 2 * 4
    else:
        raise ValueError(kv_dtype)
    return n_layers * page_size * kv_heads * per_poshead


def kv_page_bytes(cfg, page_size: int, kv_dtype: str = "bf16") -> int:
    """Per-page device bytes of ``cfg``'s paged pool over all layers: the
    unit the engine's admission and byte accounting multiply page counts
    by. Raises ``ValueError`` for stacks the paged arena cannot hold (MLA
    latents, recurrent or xLSTM blocks), as the reference's spec walk does
    (``transformer.check_pageable``)."""
    check_pageable(cfg)
    return page_nbytes(page_size, cfg.num_kv_heads, cfg.resolved_head_dim,
                       cfg.num_layers, kv_dtype)


def pages_for_pool_bytes(cfg, pool_bytes: int, page_size: int,
                         kv_dtype: str = "bf16", *, shards: int = 1) -> int:
    """How many pages of ``kv_dtype`` fit a fixed HBM budget — int8 pages
    are ~2x denser, which is exactly the admission headroom the
    ``--kv-dtype`` benchmark measures.

    ``shards`` rounds the count down to a multiple of the mesh's page-axis
    shard count so every shard holds the same number of whole pages (the
    per-shard leaf shapes stay uniform); a budget smaller than one page per
    shard floors at ``shards`` — one page per shard — rather than produce a
    pool the mesh cannot split.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    n = max(1, int(pool_bytes // kv_page_bytes(cfg, page_size, kv_dtype)))
    if shards > 1:
        n = max(shards, (n // shards) * shards)
    return n


def stream_page_needs(plan, prompt_len: int,
                      page_size: int) -> tuple[int, int]:
    """Worst-case ``(cond, uncond)`` pages one request can ever touch.

    The cond stream spans the whole generation; the uncond stream only
    its FULL prefix — and none at all under an all-COND plan, so
    selective guidance halves a late-phase request's HBM from admission.
    The single definition shared by engine admission, submit-time
    validation and the simulator (``reservation="eager"``: all pages are
    granted up front, so a request can never wedge mid-decode).
    """
    n_full = sum(s.length for s in plan.segments if s.mode is Mode.FULL)
    need_c = pages_for(prompt_len + plan.total_steps, page_size)
    need_u = pages_for(prompt_len + n_full, page_size) if n_full else 0
    return need_c, need_u


def fresh_lazy_needs(plan, prompt_len: int, page_size: int, *,
                     shared: bool) -> tuple[int, int, bool]:
    """Pages a *fresh* lazy admission grants up front.

    Returns ``(need_c, need_u_fresh, wants_u)``: prompt pages only — the
    decode span is grown on demand at tick boundaries. ``wants_u`` is
    whether the plan has a FULL prefix at all; when ``shared`` a canonical
    uncond prefix of this length exists and the request shares *all* its
    uncond prompt pages instead of allocating them (``need_u_fresh = 0``).
    The single definition shared by the engine and the simulator so their
    admission decisions (and therefore ``pages_grown``/``preemptions``
    counts) agree tick for tick.
    """
    wants_u = any(s.mode is Mode.FULL for s in plan.segments)
    need_c = pages_for(prompt_len, page_size)
    need_u = 0 if (not wants_u or shared) else pages_for(prompt_len, page_size)
    return need_c, need_u, wants_u


def resume_lazy_needs(plan, step: int, prompt_len: int, page_size: int, *,
                      shared: bool,
                      switch_step: int | None = None) -> tuple[int, int, bool, int]:
    """Pages a preempted request needs to re-admit at plan ``step``.

    The cond KV must cover every position already generated
    (``L = prompt_len + step``); the uncond stream is rebuilt only when
    the cursor still sits in the FULL prefix. ``switch_step`` is the
    checkpointed dynamic-policy switch (DESIGN.md §15): a request that
    already dropped its uncond stream mid-flight must not rebuild dead
    uncond pages on resume, even though the *plan* still says FULL. A
    resumed request shares only the *fully prompt-covered* prefix pages
    (``prompt_len // page_size``): its partial prompt page must be private
    because the resume forward re-scatters generated positions into it.
    Returns ``(need_c, need_u_fresh, wants_u, n_share)``.
    """
    cursor = PlanCursor(plan, step=step)
    wants_u = ((not cursor.done) and cursor.mode is Mode.FULL
               and (switch_step is None or step < switch_step))
    L = prompt_len + step
    need_c = pages_for(L, page_size)
    if not wants_u:
        return need_c, 0, False, 0
    n_share = (prompt_len // page_size) if shared else 0
    return need_c, pages_for(L, page_size) - n_share, True, n_share


class PageAllocator:
    """Ref-counted allocator over a pool of ``num_pages`` fixed-size pages.

    Each request-stream (``(uid, stream)``) owns an ordered list of pages
    — its block table. Frees are O(1) returns to a free list (the slot
    arena's defrag gather-permute has no paged equivalent: there is
    nothing to compact). Pages are ref-counted so read-only pages (e.g. a
    shared prompt prefix) can be granted to several owners via
    :meth:`share`; a page returns to the free list only when its last
    owner releases it.

    Invariants (property-tested in ``tests/test_paged.py``):

    * a free page has refcount 0; a granted page has refcount >= 1 and is
      never handed out again by :meth:`alloc` (no double-grant);
    * ``sum(refcounts) == sum(len(owned pages) over owners)``;
    * ``n_free + len({pages with ref > 0}) == num_pages``.

    ``kv_dtype`` records what the device pool this allocator fronts
    stores per page: ``"bf16"`` (values only) or ``"int8"`` (int8 values
    **paired** with per-(position, kv-head) fp32 scale arrays, DESIGN.md
    §11). A physical page index addresses the values and the scales
    together — one refcount governs the pair — so every grant / grow /
    share / cow / free above is dtype-agnostic and the paired arrays can
    never diverge: a CoW detach copies both payloads through the same
    ``(src, dst)``, and a page returning to the free list frees both.
    """

    KV_DTYPES = ("bf16", "int8")

    def __init__(self, num_pages: int, page_size: int, *,
                 kv_dtype: str = "bf16"):
        if num_pages < 1 or page_size < 1:
            raise ValueError((num_pages, page_size))
        if kv_dtype not in self.KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} not in {self.KV_DTYPES}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_dtype = kv_dtype
        # LIFO free list, initialized so alloc hands out low indices first
        self._free = list(range(num_pages - 1, -1, -1))
        self._ref = np.zeros(num_pages, np.int32)
        self._owned: dict[tuple[str, str], list[int]] = {}

    # -- accounting --------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return self.num_pages - self.n_free

    def owners(self) -> list[tuple[str, str]]:
        return sorted(self._owned)

    def owned(self, uid: str, stream: str) -> list[int]:
        return list(self._owned.get((uid, stream), ()))

    # -- grant / release ---------------------------------------------------

    def alloc(self, uid: str, stream: str, n: int) -> list[int] | None:
        """Grant ``n`` fresh pages to ``(uid, stream)``; None when fewer
        than ``n`` are free (no partial grants — admission control must be
        all-or-nothing so a request can never wedge mid-decode)."""
        key = (uid, stream)
        if key in self._owned:
            raise ValueError(f"{key} already owns pages")
        if n < 0:
            raise ValueError(n)
        if len(self._free) < n:
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self._ref[p] == 0
            self._ref[p] = 1
        self._owned[key] = pages
        return list(pages)

    def grow(self, uid: str, stream: str, n: int = 1) -> list[int] | None:
        """Append ``n`` fresh pages to an *existing* owner's block table —
        the on-demand growth path (``reservation="lazy"``): admission
        grants only prompt pages and the engine grows the decode span one
        page at a time at tick boundaries. All-or-nothing like
        :meth:`alloc`; None when the pool is dry (the caller preempts or
        defers)."""
        key = (uid, stream)
        if key not in self._owned:
            raise ValueError(f"{key} owns no pages (use alloc)")
        if n < 1:
            raise ValueError(n)
        if len(self._free) < n:
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self._ref[p] == 0
            self._ref[p] = 1
        self._owned[key].extend(pages)
        return list(pages)

    def share(self, uid: str, stream: str, pages: list[int]) -> list[int]:
        """Register ``(uid, stream)`` as an additional owner of already-
        granted pages (refcount++). Used for read-only prefix sharing."""
        key = (uid, stream)
        if key in self._owned:
            raise ValueError(f"{key} already owns pages")
        for p in pages:
            if not 0 <= p < self.num_pages or self._ref[p] < 1:
                raise ValueError(f"page {p} is not granted")
        for p in pages:
            self._ref[p] += 1
        self._owned[key] = list(pages)
        return list(pages)

    def cow(self, uid: str, stream: str, idx: int) -> tuple[int, int] | None:
        """Copy-on-write: detach the *shared* page at block-table index
        ``idx`` from ``(uid, stream)``, granting a fresh private page in
        its place. Returns ``(src, dst)`` so the caller can issue the
        device copy, or None when the pool is dry. Refuses (raises) when
        the page is not actually shared — unsharing an exclusively-owned
        page to refcount zero would orphan it."""
        key = (uid, stream)
        if key not in self._owned:
            raise ValueError(f"{key} owns no pages")
        pages = self._owned[key]
        if not 0 <= idx < len(pages):
            raise ValueError(f"table index {idx} outside {key}'s "
                             f"{len(pages)} pages")
        src = pages[idx]
        if self._ref[src] < 2:
            raise ValueError(f"page {src} is not shared (refcount "
                             f"{int(self._ref[src])}): cow would unshare "
                             "to zero")
        if not self._free:
            return None
        dst = self._free.pop()
        assert self._ref[dst] == 0
        self._ref[dst] = 1
        self._ref[src] -= 1
        pages[idx] = dst
        return src, dst

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def free(self, uid: str, stream: str) -> int:
        """Release ``(uid, stream)``'s pages; returns how many physical
        pages actually went back to the free list (refcount hit 0)."""
        pages = self._owned.pop((uid, stream), None)
        if pages is None:
            return 0
        reclaimed = 0
        for p in pages:
            self._ref[p] -= 1
            assert self._ref[p] >= 0
            if self._ref[p] == 0:
                self._free.append(p)
                reclaimed += 1
        return reclaimed

    def free_all(self, uid: str) -> int:
        return sum(self.free(uid, stream) for stream in ("c", "u"))

    # -- block tables ------------------------------------------------------

    def table(self, uid: str, stream: str, width: int) -> np.ndarray:
        """Block table of ``width`` entries: the stream's pages in logical
        order, padded with the out-of-range index ``num_pages`` (device
        writes drop, reads clamp and are position-masked)."""
        pages = self._owned.get((uid, stream), ())
        out = np.full(width, self.num_pages, np.int32)
        n = min(len(pages), width)
        out[:n] = pages[:n]
        return out

    # -- audit -------------------------------------------------------------

    def check(self) -> None:
        """Assert the allocator's conservation invariants (the serve
        harness calls this every simulated tick): refcounts balance
        ownership exactly, the free list and granted pages partition the
        pool, no page is freed twice (free-list duplicates), and no owner
        holds the same page twice."""
        owned = [p for pages in self._owned.values() for p in pages]
        assert sum(len(v) for v in self._owned.values()) == int(self._ref.sum())
        assert len(self._free) == len(set(self._free)), "double-freed page"
        assert sorted(self._free) == sorted(
            p for p in range(self.num_pages) if self._ref[p] == 0)
        assert self.n_free + len(set(owned)) == self.num_pages
        for key, pages in self._owned.items():
            assert len(pages) == len(set(pages)), key


class ShareRegistry:
    """Canonical-page share registry, generalized over the key space.

    The machinery built for length-keyed uncond prefix sharing —
    a registry that itself holds a :meth:`PageAllocator.share` on the
    canonical pages (owner uid ``~prefix``) so their content survives the
    founder, with per-key user sets, pressure eviction and CoW-safe
    un-sharing — is key-agnostic. This base class carries it; subclasses
    fix three knobs:

    * ``STREAM`` — which per-uid stream canonical pages come from and are
      shared back into (``"u"`` for the null stream, ``"c"`` for prompts);
    * ``PERSISTENT`` — whether an entry survives its last user leaving
      (a *true cache*, evicted only under pressure or explicitly) or dies
      with it (the no-leak-at-drain contract);
    * ``_eviction_order`` — deterministic pressure-eviction order, which
      must be reproducible between the engine and the simulator.
    """

    OWNER = "~prefix"
    STREAM = "u"
    PERSISTENT = False

    def __init__(self, alloc: PageAllocator):
        self.alloc = alloc
        self._users: dict = {}          # key -> set of user uids
        self._of_uid: dict[str, object] = {}
        self._seq: dict = {}            # key -> publish order (monotonic)
        self._next_seq = 0
        self.evictions = 0           # entries dropped under pool pressure
        self.evicted_pages = 0       # physical pages those drops returned

    def _canon(self, key) -> str:
        """The registry owner's stream name for ``key`` — distinct per
        key so one ``OWNER`` uid can hold many canonical entries."""
        return f"{self.STREAM}{key}"

    def lookup(self, key) -> list[int] | None:
        """Canonical pages for ``key``, or None."""
        if key not in self._users:
            return None
        return self.alloc.owned(self.OWNER, self._canon(key))

    def publish(self, key, uid: str) -> None:
        """Make ``uid``'s freshly-prefilled ``STREAM`` pages the canonical
        entry for ``key`` (founder path)."""
        if key in self._users:
            raise ValueError(f"prefix for {key!r} already published")
        pages = self.alloc.owned(uid, self.STREAM)
        self.alloc.share(self.OWNER, self._canon(key), pages)
        self._users[key] = {uid}
        self._of_uid[uid] = key
        self._seq[key] = self._next_seq
        self._next_seq += 1

    def acquire(self, key, uid: str, *,
                count: int | None = None) -> list[int] | None:
        """Share the first ``count`` canonical pages (default: all) into
        ``(uid, STREAM)`` and register ``uid`` as a user; None on miss."""
        pages = self.lookup(key)
        if pages is None:
            return None
        take = pages if count is None else pages[:count]
        self.alloc.share(uid, self.STREAM, take)
        self._users[key].add(uid)
        self._of_uid[uid] = key
        return list(take)

    def release(self, uid: str) -> int:
        """Drop ``uid``'s registry membership (idempotent). Non-persistent
        entries free their canonical pages once the last user leaves;
        persistent entries linger as cache. Returns the physical pages
        that freeing the canonical entry returned to the pool (0 while
        other users remain), so the COND-transition reclaim can count
        them."""
        key = self._of_uid.pop(uid, None)
        if key is None:
            return 0
        users = self._users[key]
        users.discard(uid)
        if users or self.PERSISTENT:
            return 0
        del self._users[key]
        self._seq.pop(key, None)
        self._drop_payload(key)
        return self.alloc.free(self.OWNER, self._canon(key))

    def reclaimable(self, key) -> int:
        """Canonical pages held *only* by the registry (refcount 1) —
        physical pages an eviction would actually return. Nonzero once
        every user has CoW-detached or released a page the registry still
        pins (e.g. the partial prompt page after the founder diverges)."""
        pages = self.lookup(key)
        if pages is None:
            return 0
        return sum(1 for p in pages if self.alloc.refcount(p) == 1)

    def evict(self, key) -> int:
        """Drop a canonical entry under pool pressure (the registry is a
        cache: losing it costs future sharing, never correctness — users
        keep their own shares). Returns physical pages freed."""
        users = self._users.pop(key)
        for uid in users:
            del self._of_uid[uid]
        self._seq.pop(key, None)
        self._drop_payload(key)
        return self.alloc.free(self.OWNER, self._canon(key))

    def _drop_payload(self, key) -> None:
        """Hook: subclasses drop any per-entry payload here."""

    def _eviction_order(self) -> list:
        return sorted(self._users)

    def evict_under_pressure(self) -> bool:
        """Evict one entry because the pool ran dry; False when the
        registry is already empty. Entries that pin registry-only pages
        go first (eviction returns physical pages), then any entry in
        ``_eviction_order`` (eviction un-shares its pages, which can
        dissolve the very CoW that needed the free page — a request
        whose worst-case span equals the whole pool must not wedge on its
        own published prefix). ``provision_growth`` exhausts this before
        resorting to preemption: dropping cache beats killing work.

        Pressure evictions are counted on the registry (``evictions`` /
        ``evicted_pages``) — note a 0-page eviction still helps, by
        un-sharing the page whose CoW needed the grant, which is why the
        return type stays bool (did anything change), not pages-freed."""
        for key in self._eviction_order():
            if self.reclaimable(key):
                self.evictions += 1
                self.evicted_pages += self.evict(key)
                return True
        for key in self._eviction_order():
            self.evictions += 1
            self.evicted_pages += self.evict(key)
            return True
        return False


class PrefixShareRegistry(ShareRegistry):
    """Canonical uncond prompt-prefix pages, keyed by prompt length.

    The CFG null stream is the *same* null conditioning for every request
    (``null_prompt`` zeroes the tokens), so two requests with equal prompt
    length have bit-identical unconditional prompt KV — the prefix pages
    the founder's prefill wrote can back every later request's uncond
    block table via :meth:`PageAllocator.share`.

    The entry is dropped — and the registry's refs released — when the
    last *user* (founder or sharer) stops referencing it, which is what
    keeps the no-leak-at-drain invariant intact. Pressure eviction walks
    entries in deterministic length order. (Keys are prompt lengths and
    ``_canon`` yields ``u<len>``, bit-compatible with the length-keyed layout.)
    """

    STREAM = "u"
    PERSISTENT = False


def content_key(ids) -> str:
    """Content hash of a token-id sequence — the key the cond-stream
    prefix cache dedupes identical prompts by (DESIGN.md §14).

    sha1 over the little-endian int32 id bytes (length is implicit in the
    byte count), truncated to 16 hex chars: collision-improbable for a
    cache, and cheap to compare/sort. The registry still *verifies* the
    stored ids on every hit, so even a manufactured collision degrades to
    a miss, never to serving another prompt's KV.
    """
    import hashlib

    arr = np.ascontiguousarray(np.asarray(ids, np.int32))
    return hashlib.sha1(arr.tobytes()).hexdigest()[:16]


class ContentPrefixRegistry(ShareRegistry):
    """Content-addressed canonical *cond* prompt pages (DESIGN.md §14).

    Extends the length-only uncond sharing to the conditional stream:
    identical prompts (same token ids, keyed by :func:`content_key`) have
    bit-identical cond prompt KV, so later arrivals share the founder's
    prompt pages and skip their prefill forward entirely. Differences
    from :class:`PrefixShareRegistry`:

    * **persistent** — entries outlive their users (popular prompts
      arrive staggered; a cache that dies with the founder never hits),
      so canonical pages are only returned by pressure eviction or an
      explicit :meth:`evict`/:meth:`drop_all`;
    * **verified** — each entry stores the exact token ids; a lookup must
      :meth:`matches` them, so hash collisions degrade to misses;
    * **warm-up gated** — an entry is :meth:`ready` only strictly after
      its publish tick: the founder's prefill runs later in the same
      tick, and the model-free simulator must reproduce the engine's
      hit/miss decisions without seeing device state;
    * **payload** — the founder's last-position cond/uncond logits ride
      along so a hit can replay token 0 bit-exactly with zero passes;
    * pressure eviction walks **publish order** (oldest first), not key
      order: hash keys sort differently between the engine (hex digests)
      and the simulator (raw content labels), publish order is identical.
    """

    STREAM = "c"
    PERSISTENT = True

    def __init__(self, alloc: PageAllocator):
        super().__init__(alloc)
        self._ids: dict = {}        # key -> verified token ids
        self._tick: dict = {}       # key -> publish tick (warm-up gate)
        self._payload: dict = {}    # key -> founder logits (engine only)
        self.hits = 0
        self.misses = 0

    def _canon(self, key) -> str:
        return f"c@{key}"

    @staticmethod
    def _norm(ids):
        if ids is None or isinstance(ids, (str, bytes)):
            return ids
        return tuple(int(t) for t in ids)

    def publish(self, key, uid: str, *, ids=None, tick: int = 0) -> None:
        super().publish(key, uid)
        self._ids[key] = self._norm(ids)
        self._tick[key] = int(tick)

    def matches(self, key, ids) -> bool:
        """True when the stored ids equal ``ids`` exactly — the collision
        guard every hit must pass."""
        want = self._ids.get(key)
        return want is not None and want == self._norm(ids)

    def ready(self, key, now: int) -> bool:
        """Hittable: published strictly before ``now`` (founder's prefill
        has run and its logits payload is installed)."""
        return key in self._users and self._tick.get(key, 0) < int(now)

    def set_payload(self, key, payload) -> None:
        if key in self._users:
            self._payload[key] = payload

    def payload(self, key):
        return self._payload.get(key)

    def _drop_payload(self, key) -> None:
        self._ids.pop(key, None)
        self._tick.pop(key, None)
        self._payload.pop(key, None)

    def _eviction_order(self) -> list:
        return sorted(self._users, key=self._seq.__getitem__)

    def drop_all(self) -> int:
        """Evict every entry (drain/teardown); returns pages freed."""
        return sum(self.evict(key) for key in self._eviction_order())


# ---------------------------------------------------------------------------
# Host tier: byte-budgeted page pool for swapped-out KV (DESIGN.md §14)
# ---------------------------------------------------------------------------


def host_pages_for_bytes(host_bytes: int, page_bytes: int) -> int:
    """Host-tier pages a byte budget affords (0 disables the tier)."""
    if page_bytes <= 0:
        return 0
    return max(0, int(host_bytes // page_bytes))


class HostPagePool:
    """Byte-budgeted host tier for preemption-victim KV pages.

    A slot allocator over ``num_pages`` host pages with per-``(uid,
    stream)`` ownership, whole-checkpoint LRU eviction, and a :meth:`check`
    conservation audit mirroring :meth:`PageAllocator.check`; that half is
    model-free (the simulator uses it alone). The engine also
    :meth:`attach`es a storage arena that mirrors its page pool and copies
    pages in (:meth:`store`) and out (:meth:`load`). Beside a CUDA pool the
    arena is pinned host memory and both copies are ``non_blocking`` on the
    current stream: the host never reads the stored bytes, so stream order
    alone keeps a load behind the store it reads.

    Unlike the device allocator there is no refcounting: a checkpoint's
    host pages have exactly one owner (sharing is a device-tier concept),
    and eviction is all-or-nothing per uid — a half-present checkpoint
    could not be restored anyway.
    """

    def __init__(self, num_pages: int, *, page_bytes: int = 0):
        if num_pages < 1:
            raise ValueError(num_pages)
        self.num_pages = num_pages
        self.page_bytes = int(page_bytes)
        self._free = list(range(num_pages - 1, -1, -1))
        self._owned: dict[tuple[str, str], list[int]] = {}
        self._lru: dict[str, int] = {}   # uid -> recency stamp
        self._stamp = 0
        self.evictions = 0           # checkpoints LRU-evicted by put()

    # -- accounting --------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return self.num_pages - self.n_free

    @property
    def bytes_in_use(self) -> int:
        return self.n_in_use * self.page_bytes

    def holds(self, uid: str) -> bool:
        return uid in self._lru

    def pages_of(self, uid: str) -> dict[str, list[int]]:
        """``{stream: host slots}`` for a held checkpoint (stream-sorted)."""
        return {s: list(v) for (u, s), v in sorted(self._owned.items())
                if u == uid}

    def lru_order(self) -> list[str]:
        """Held uids, least-recently stored first (the eviction order)."""
        return sorted(self._lru, key=self._lru.__getitem__)

    # -- put / drop --------------------------------------------------------

    def put(self, uid: str, needs: dict[str, int]):
        """Reserve host slots for ``uid``'s streams, LRU-evicting whole
        older checkpoints until the new one fits. Returns
        ``(slots_by_stream, evicted)`` where ``evicted`` is
        ``[(uid, pages_freed), ...]`` in eviction order, or None when the
        checkpoint exceeds the tier outright (caller falls back to the
        recompute path)."""
        if uid in self._lru:
            raise ValueError(f"uid {uid!r} already held")
        total = sum(needs.values())
        if total <= 0 or total > self.num_pages:
            return None
        evicted = []
        while self.n_free < total:
            victim = self.lru_order()[0]
            evicted.append((victim, self.drop(victim)))
            self.evictions += 1
        placed = {}
        for stream in sorted(needs):
            n = needs[stream]
            if n < 1:
                raise ValueError((stream, n))
            slots = [self._free.pop() for _ in range(n)]
            self._owned[(uid, stream)] = slots
            placed[stream] = list(slots)
        self._lru[uid] = self._stamp
        self._stamp += 1
        return placed, evicted

    def touch(self, uid: str) -> None:
        """Refresh LRU recency (e.g. when a resume is deferred but the
        checkpoint stays hot)."""
        if uid in self._lru:
            self._lru[uid] = self._stamp
            self._stamp += 1

    def drop(self, uid: str) -> int:
        """Release a checkpoint's host pages (idempotent); returns pages
        freed. Both the consume path (restore) and the eviction paths
        (TTL expiry, LRU pressure) land here — a dropped checkpoint's
        uid simply resumes through recompute."""
        if uid not in self._lru:
            return 0
        del self._lru[uid]
        freed = 0
        for key in [k for k in self._owned if k[0] == uid]:
            slots = self._owned.pop(key)
            self._free.extend(slots)
            freed += len(slots)
        return freed

    # -- audit -------------------------------------------------------------

    def check(self) -> None:
        """Conservation invariants, mirroring ``PageAllocator.check``:
        free and owned slots partition the tier, nothing double-freed or
        double-owned, every held uid owns at least one stream, and the
        byte budget is never exceeded (structural: the partition bounds
        ``n_in_use`` by ``num_pages``)."""
        owned = [s for v in self._owned.values() for s in v]
        assert len(self._free) == len(set(self._free)), "double-freed slot"
        assert len(owned) == len(set(owned)), "double-owned slot"
        assert sorted(self._free + owned) == list(range(self.num_pages))
        assert {u for u, _ in self._owned} == set(self._lru)
        assert 0 <= self.n_in_use <= self.num_pages

    # -- storage (engine-side; the simulator never attaches) ---------------

    arena = None

    def attach(self, template) -> None:
        """Allocate the host arena mirroring ``template`` (the engine's pool:
        a list per layer of ``{name: (P + 1, ...)}`` tensors, values and
        int8 scales alike), each leaf's pages axis (0) resized to the host
        tier's ``num_pages``; pinned when the pool is on a GPU."""
        def mirror(t):
            return torch.zeros((self.num_pages,) + tuple(t.shape[1:]), dtype=t.dtype,
                               pin_memory=t.device.type == "cuda")

        self.arena = [{name: mirror(t) for name, t in layer.items()} for layer in template]

    def store(self, slots: list[int], rows) -> None:
        """Write gathered page rows into host slots: ``rows`` mirrors the
        arena, each leaf's first ``len(slots)`` entries along the pages
        axis going to ``slots`` (the rest, gather padding, is ignored). One
        copy per leaf and run of consecutive slots, ``non_blocking``."""
        for dst_layer, src_layer in zip(self.arena, rows):
            for name, dst in dst_layer.items():
                src = src_layer[name]
                for at, slot, n in _runs(slots):
                    dst[slot:slot + n].copy_(src[at:at + n], non_blocking=True)

    def load(self, slots: list[int], device=None):
        """Read host slots back as page rows mirroring the arena, on
        ``device`` (None: the host, a copy): one ``non_blocking`` copy per
        leaf and run of consecutive slots."""
        device = torch.device("cpu") if device is None else torch.device(device)
        out = []
        for layer in self.arena:
            rows = {}
            for name, src in layer.items():
                dst = torch.empty((len(slots),) + tuple(src.shape[1:]), dtype=src.dtype,
                                  device=device)
                for at, slot, n in _runs(slots):
                    dst[at:at + n].copy_(src[slot:slot + n], non_blocking=True)
                rows[name] = dst
            out.append(rows)
        return out


def _runs(slots: list[int]) -> list[tuple[int, int, int]]:
    """``slots`` as runs of consecutive slots: (index in ``slots``, first
    slot, length) each."""
    out: list[tuple[int, int, int]] = []
    for i, s in enumerate(slots):
        s = int(s)
        if out and out[-1][1] + out[-1][2] == s:
            at, first, n = out[-1]
            out[-1] = (at, first, n + 1)
        else:
            out.append((i, s, 1))
    return out


def plan_swap_out(pages: PageAllocator, host: HostPagePool | None, uid: str,
                  *, min_pages: int = 0) -> dict[str, int] | None:
    """Decide whether a preemption victim's KV swaps to the host tier.

    Returns ``{stream: n_pages}`` needs (the exact per-stream page counts
    a later restore must re-grant) or None for the recompute path: no
    host tier, nothing resident, a suffix shorter than ``min_pages``
    (the autotuner's restore-vs-recompute break-even, DESIGN.md §14), or
    a checkpoint larger than the whole tier. The single definition shared
    by the engine and the simulator — like ``provision_growth`` — so
    their swap counters agree tick for tick.
    """
    if host is None:
        return None
    needs = {}
    for stream in ("c", "u"):
        n = len(pages.owned(uid, stream))
        if n:
            needs[stream] = n
    total = sum(needs.values())
    if total == 0 or total < min_pages or total > host.num_pages:
        return None
    return needs


# ---------------------------------------------------------------------------
# Pooled-arena sharding
# ---------------------------------------------------------------------------


def _meta(shape) -> torch.Tensor:
    return torch.empty(tuple(shape), device="meta")


def _pool_leaf(names: tuple) -> tuple:
    """A cache leaf's names as a pool row's: the row axis plays ``batch``.
    The reference stacks batch-1 caches under a new slot axis and
    neutralises their interior batch dim; the port's rows are that dim."""
    return ("batch",) + (names[1:] if names[:1] == ("batch",) else names)


def _pool_shape(names: tuple, shape, rows: int) -> tuple:
    return (rows,) + (tuple(shape)[1:] if names[:1] == ("batch",) else tuple(shape))


def pooled_cache_axes(cfg, capacity: int, *, long_ctx: bool = False) -> list:
    """Logical axes of the slot arena's pools, layer by layer: each leaf of
    ``transformer.cache_axes`` with the row axis as ``batch`` (a ring's
    slot positions get one a row)."""
    return map_axes(_pool_leaf, T.cache_axes(cfg, capacity, long_ctx=long_ctx))


def _walk2(fn, axes, specs):
    if is_axes_leaf(axes):
        return fn(axes, specs)
    if isinstance(axes, dict):
        return {k: _walk2(fn, axes[k], specs[k]) for k in axes}
    return [_walk2(fn, a, s) for a, s in zip(axes, specs)]


def pool_partition_specs(cfg, num_slots: int, capacity: int, *, rules: AxisRules, mesh,
                         long_ctx: bool = False, dtype=None) -> list:
    """The ``P`` tree of the slot arena's pools of ``num_slots`` rows under
    ``rules`` on ``mesh``: the allocator on each leaf's pooled names and
    shape, so the divisibility fallbacks (``kv_heads -> kv_seq``) act as on
    the unpooled decode caches."""
    axes = T.cache_axes(cfg, capacity, long_ctx=long_ctx)
    specs = T.cache_specs(cfg, 1, capacity, long_ctx=long_ctx, device="meta")

    def one(names, spec):
        return logical_to_spec(_pool_leaf(names), rules,
                               shape=_pool_shape(names, spec.shape, num_slots), mesh=mesh)

    return _walk2(one, axes, specs)


def _paged_leaves(cfg, num_pages: int, page_size: int, kv_dtype: str) -> list:
    """Meta tensors of the reference's pool shapes, ``num_pages`` pages (the
    port's pool adds one spare page past them, which no spec names)."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    layer = {"k": _meta((num_pages, page_size, K, hd)), "v": _meta((num_pages, page_size, K, hd))}
    if kv_dtype == "int8":
        layer.update(k_scale=_meta((num_pages, page_size, K, 1)),
                     v_scale=_meta((num_pages, page_size, K, 1)))
    return [dict(layer) for _ in range(cfg.num_layers)]


def paged_partition_specs(cfg, num_pages: int, page_size: int, *, rules: AxisRules, mesh,
                          dtype=None, kv_dtype: str = "bf16") -> list:
    """The ``P`` tree of the paged KV pool under ``rules``: the pool's own
    ``pages``/``page`` names are rule-table entries, and int8 scale leaves
    carry them too, so a page's values and scales land on one device."""
    axes = T.paged_cache_axes(cfg, kv_dtype=kv_dtype)
    return tree_shardings(axes, _paged_leaves(cfg, num_pages, page_size, kv_dtype),
                          as_mesh_shape(mesh), rules)


def pages_shard_count(rules: AxisRules, mesh) -> int:
    """How many ways ``rules``/``mesh`` split the page-pool axis: the product
    of the sizes of the ``pages`` rule's candidate axes present on the mesh
    (the fully absorbed count, which page-count divisibility must meet for
    uniform shard shapes). 1 without a mesh or such axes."""
    if mesh is None:
        return 1
    rule = rules.rule("pages")
    if rule is None:
        return 1
    sizes = mesh_sizes(mesh)
    n = 1
    for ax in rule.axes:
        n *= sizes.get(ax, 1)
    return max(1, n)


def paged_pool_shardings(cfg, num_pages: int, page_size: int, *, rules: AxisRules, mesh,
                         dtype=None, kv_dtype: str = "bf16") -> list:
    """The paged pool's DTensor placements on ``mesh`` (a ``DeviceMesh``),
    leaf for leaf: ``paged_partition_specs`` resolved against it."""
    axes = T.paged_cache_axes(cfg, kv_dtype=kv_dtype)
    return tree_shardings(axes, _paged_leaves(cfg, num_pages, page_size, kv_dtype), mesh,
                          rules)

