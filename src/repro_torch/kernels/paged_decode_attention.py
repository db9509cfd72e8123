"""Block-table flash-decode attention over a paged KV pool: the wrappers over
``csrc/paged_decode_attention.cu``, with the plain PyTorch version beside
them. Replaces the four Pallas kernels of
``repro/kernels/paged_decode_attention.py``:

* ``ragged_paged_decode_attention``       ragged pass list, bf16 pages (B7);
* ``ragged_paged_decode_attention_int8``  ragged pass list, int8 pages (B8);
* ``paged_decode_attention``              per-row positions, bf16 pages (B9);
* ``paged_decode_attention_int8``         per-row positions, int8 pages (B10).

One decode query per row, q (R,H,hd), against a page pool k, v
(P, page_size, K, hd) through a block table (R, nb) int32 with per-row
positions ``pos`` (R,): key ``kpos`` of row r is valid iff ``kpos <=
pos[r]`` and, with a window, ``kpos > pos[r] - window``. Table entries
outside [0, P) are clamped into it (the position mask kills the padding
past a row's span). Int8 pools hold int8 values with float32 scales
(P, page_size, K, 1) per (position, kv head). The ragged forms take
``phase`` (R,): rows at phase 0 are padding and come out as exact zeros.
``block_k`` is checked as the reference checks it (it must divide
``page_size``) but picks nothing: the CUDA kernel has no sub-page tile.
All four launch one kernel, which splits each row's keys over a cluster
of blocks in tiles of 64 keys with a bf16 q (tensor-core products) or 32
with a float32 q (CUDA-core products), several pages a tile
(``paged_split_plan``), whatever ``block_k``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The plain version mirrors the reference's default paged path
(``attn_decode_paged``'s gather, the one it runs unless
``REPRO_PAGED_ATTN=pallas``): scores from a product in q's dtype, softmax
in float32, weights cast to q's dtype, int8 pages dequantized to q's dtype.
The kernels compute as the Pallas kernels do: float32 scores and
accumulators, p rounded to the pages' dtype before the PV product for
bf16/float32 pages, float32 throughout for int8 pages (with a bf16 q the
tensor-core PV takes the float32 p * v_scale as a bf16 pair hi + lo, within
2^-16 of it). ``LAUNCHES`` counts kernel launches by name.

``paged_decode_attention_shard`` is the four kernels' shard form, for a
pool split by pages over ranks: the table holds this rank's local page ids,
an entry outside [0, P) marks a page another rank owns, and such a page is
neither read nor attended (never clamped to a real page). It returns o in
float32 and each (row, head)'s log-sum-exp of the attended scores, float32
(R, H); a live row with no local key gives o = 0 and lse = -inf, a row at
phase 0 zeros and -inf. ``dist.exchange.merge_partials`` merges the ranks'
(o, lse) into the whole pool's attention. Its launches count under the
kernel's name in ``LAUNCHES`` and again in ``SHARD_LAUNCHES``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import grouped_attention_plain
from repro_torch.kernels.quant import dequantize_kv

LAUNCHES = {"ragged_paged_decode_attention": 0, "ragged_paged_decode_attention_int8": 0,
            "paged_decode_attention": 0, "paged_decode_attention_int8": 0}
SHARD_LAUNCHES = dict(LAUNCHES)   # the shard form's launches, also counted in LAUNCHES
MAX_HEAD_DIM = 128  # kMaxHeadDim in csrc/paged_decode_attention.cu
MAX_GROUP = 8      # query heads per kv head; kMaxRep there
TILE = {torch.bfloat16: 64, torch.float32: 32}   # keys per tile, by q's dtype; split_tile
MAX_CLUSTER = 8    # blocks per (kv head, row) cluster, the portable most; kMaxCluster
MAX_STAGES = 3     # tiles of a block in flight at once; kMaxStages
SPLIT_WARPS = 4    # warps per block of the split kernel; kSplitWarps


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        SHARD_LAUNCHES[k] = 0


def resolve_block_k(block_k, page_size: int) -> int:
    """``block_k`` (None: whole pages) must divide ``page_size``."""
    bk = page_size if block_k is None else int(block_k)
    if bk < 1 or page_size % bk:
        raise ValueError(f"block_k {block_k!r} must divide page_size={page_size}")
    return bk


def local_table(block_table, first: int, num_pages: int):
    """A global block table as the rank holding pages [first, first +
    num_pages) reads it: local page ids, -1 for a page another rank holds;
    the shard form's table."""
    local = block_table - first
    return torch.where((local >= 0) & (local < num_pages), local, -1).contiguous()


def paged_attention_plain(q, k_pages, v_pages, block_table, pos, *, window=None,
                          phase=None, k_scales=None, v_scales=None, shard: bool = False):
    """The plain version of all four kernels: gather each row's pages through
    its clamped table into (R, nb*page_size, K, hd), then masked grouped
    attention. With scales the pages are int8 and are dequantized to q's
    dtype; with ``phase`` the rows at phase 0 are zeros. With ``shard``, the
    shard form: entries outside [0, P) are other ranks' pages, gathered as
    zeros and masked, and -> (o float32 (R,H,hd), lse float32 (R,H)), o the
    same attention as the whole form's over the keys left (its very values,
    widened), zeros and -inf where a row attends no key."""
    R, H, hd = q.shape
    P, ps, K = k_pages.shape[:3]
    nb = block_table.shape[1]
    bt = block_table.long()
    own = (bt >= 0) & (bt < P) if shard else None
    bt = torch.where(own, bt, 0) if shard else bt.clamp(0, P - 1)
    k, v = k_pages[bt], v_pages[bt]
    if k_scales is not None:
        k = dequantize_kv(k, k_scales[bt], q.dtype)
        v = dequantize_kv(v, v_scales[bt], q.dtype)
    if shard:
        mine = own[:, :, None, None, None]
        k, v = torch.where(mine, k, torch.zeros_like(k)), torch.where(mine, v, torch.zeros_like(v))
    k = k.reshape(R, nb * ps, K, hd)
    v = v.reshape(R, nb * ps, K, hd)
    kpos = torch.arange(nb * ps, device=q.device)
    pos = pos.long()
    valid = kpos[None, :] <= pos[:, None]
    if window is not None:
        valid = valid & (kpos[None, :] > pos[:, None] - window)
    if shard:
        valid = valid & own.repeat_interleave(ps, dim=1)
    mask = valid[:, None, None, None, :]
    if not shard:
        ctx = grouped_attention_plain(q[:, None], k, v, mask)[:, 0]
        if phase is not None:
            ctx = torch.where((phase > 0)[:, None, None], ctx, torch.zeros_like(ctx))
        return ctx
    ctx, lse = grouped_attention_plain(q[:, None], k, v, mask, lse=True)
    live = valid.any(dim=1) if phase is None else valid.any(dim=1) & (phase > 0)
    return (torch.where(live[:, None, None], ctx[:, 0].float(), 0.0),
            torch.where(live[:, None], lse[:, 0], -math.inf))


class PagedPlan(NamedTuple):
    """The split kernel's launch: ``cluster`` blocks per (kv head, row), each
    taking up to ``per_block`` tiles of ``tile`` keys, ``stages`` of them in
    flight, in ``smem_bytes`` of dynamic shared memory."""
    tile: int
    cluster: int
    per_block: int
    stages: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def paged_split_plan(nb: int, page_size: int, window: int | None, rep: int, hd: int,
                     int8: bool = False, dtype: torch.dtype = torch.bfloat16) -> PagedPlan:
    """The kernel's plan for q of ``dtype``, from shapes alone (never from
    ``pos``, which lives on the device): the keys a row can reach, ``nb *
    page_size`` and at most ``window``, in ``TILE[dtype]``-key tiles over at
    most ``MAX_CLUSTER`` blocks, as many as an even split needs; each block
    finds its own range from its row's position on the device. The shared
    memory mirrors ``split_smem_bytes`` in ``csrc/paged_decode_attention.cu``:
    the ring of stages (K and V rows of hd padded to 64 or 128, bf16 and
    float32 at 16 bytes past a multiple of 128, int8 at 8 past a multiple of
    16 with float32 scales), then q in float32 (float32 q) or the warps'
    bf16 scratch (int8 pages, bf16 q), or the merge's (m, l, acc) if
    larger."""
    tile, f32 = TILE[dtype], dtype == torch.float32
    reach = nb * page_size if window is None else min(nb * page_size, window)
    tiles = -(-reach // tile)
    per = -(-tiles // MAX_CLUSTER)
    stages = min(per, MAX_STAGES)
    dims = 64 if hd <= 64 else 128     # hd padded with zeros
    esize = 1 if int8 else 4 if f32 else 2
    row = esize * dims + (8 if int8 else 16)
    stage = 2 * tile * (row + (4 if int8 else 0))
    extra = 4 * rep * hd if f32 else SPLIT_WARPS * 32 * (2 * dims + 16) if int8 else 0
    loop = stages * stage + extra
    merge = 4 * (SPLIT_WARPS + 1) * rep * (hd + 2)
    return PagedPlan(tile, -(-tiles // per), per, stages, max(loop, merge))


def _check(q, k_pages, v_pages, block_table, pos, phase, k_scales, v_scales, window):
    if q.ndim != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[3] != q.shape[2] or q.shape[1] % k_pages.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, pages {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}: need q (R,H,hd) and pages "
                         "(P, page_size, K, hd) with H % K == 0")
    R = q.shape[0]
    if block_table.ndim != 2 or block_table.shape[0] != R or tuple(pos.shape) != (R,) \
            or (phase is not None and tuple(phase.shape) != (R,)):
        raise ValueError(f"block_table {tuple(block_table.shape)}, pos {tuple(pos.shape)}"
                         f"{'' if phase is None else f', phase {tuple(phase.shape)}'} "
                         f"for {R} rows")
    if k_scales is None:
        if q.dtype != k_pages.dtype or q.dtype != v_pages.dtype:
            raise TypeError(f"q, k, v dtypes {q.dtype}, {k_pages.dtype}, "
                            f"{v_pages.dtype} differ")
    else:
        want = (*k_pages.shape[:3], 1)
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8 \
                or tuple(k_scales.shape) != want or tuple(v_scales.shape) != want:
            raise TypeError(f"int8 pages with float32 scales {want} expected, got "
                            f"{k_pages.dtype} pages, scales {tuple(k_scales.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")


def _launch(name, q, k_pages, v_pages, block_table, pos, phase, k_scales, v_scales,
            window, block_k, shard: bool = False):
    _check(q, k_pages, v_pages, block_table, pos, phase, k_scales, v_scales, window)
    resolve_block_k(block_k, k_pages.shape[1])
    tensors = [q, k_pages, v_pages, block_table, pos] + [
        t for t in (phase, k_scales, v_scales) if t is not None]
    if not build.on_cuda(*tensors):
        return paged_attention_plain(q, k_pages, v_pages, block_table, pos, window=window,
                                     phase=phase, k_scales=k_scales, v_scales=v_scales,
                                     shard=shard)
    build.check_inputs(q)
    int8 = k_scales is not None
    for t in (block_table, pos) + (() if phase is None else (phase,)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError("block_table, pos and phase must be contiguous int32")
    if int8:
        for t in (k_scales, v_scales):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise TypeError("scales must be contiguous float32")
    else:
        build.check_inputs(k_pages, v_pages)
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("kernel takes contiguous pages")
    R, H, hd = q.shape
    P, ps, K = k_pages.shape[:3]
    if hd % 8 or hd > MAX_HEAD_DIM or H // K > MAX_GROUP:
        raise ValueError(f"kernel takes hd a multiple of 8 up to {MAX_HEAD_DIM} and H/K up "
                         f"to {MAX_GROUP}, got hd {hd}, H/K {H // K}")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("kernel takes 16-byte aligned q and pages")
    nb = block_table.shape[1]
    plan = paged_split_plan(nb, ps, window, H // K, hd, int8, q.dtype)
    lib = build.load()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ptr(k_scales), ptr(v_scales),
            block_table.data_ptr(), pos.data_ptr(), ptr(phase))
    tail = (R, H, K, hd, P, ps, nb, window or 0, *plan, 1.0 / math.sqrt(hd),
            build.DTYPES[q.dtype], int(int8), build.stream(q))
    if shard:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty(R, H, dtype=torch.float32, device=q.device)
        code = lib.paged_decode_attention_shard(*args, out.data_ptr(), lse.data_ptr(), *tail)
    else:
        out = torch.empty_like(q)
        code = lib.paged_decode_attention(*args, out.data_ptr(), *tail)
    build.check(lib, name, code)
    LAUNCHES[name] += 1
    if shard:
        SHARD_LAUNCHES[name] += 1
        return out, lse
    return out


def ragged_paged_decode_attention(q, k_pages, v_pages, block_table, pos, phase, *,
                                  window: int | None = None, block_k: int | None = None):
    """B7. q (R,H,hd) float32/bfloat16; pages (P, page_size, K, hd) of q's
    dtype; block_table (R, nb), pos (R,), phase (R,) int32 -> (R,H,hd).
    A live row walks its pages up to ``pos // page_size``; a row at phase
    0 reads no page and is zeros."""
    return _launch("ragged_paged_decode_attention", q, k_pages, v_pages, block_table, pos,
                   phase, None, None, window, block_k)


def ragged_paged_decode_attention_int8(q, k_pages, k_scales, v_pages, v_scales,
                                       block_table, pos, phase, *,
                                       window: int | None = None,
                                       block_k: int | None = None):
    """B8: B7 over int8 pages with float32 scales (P, page_size, K, 1)."""
    return _launch("ragged_paged_decode_attention_int8", q, k_pages, v_pages, block_table,
                   pos, phase, k_scales, v_scales, window, block_k)


def paged_decode_attention(q, k_pages, v_pages, block_table, pos, *,
                           window: int | None = None, block_k: int | None = None):
    """B9: B7 without phase; every row is live."""
    return _launch("paged_decode_attention", q, k_pages, v_pages, block_table, pos, None,
                   None, None, window, block_k)


def paged_decode_attention_int8(q, k_pages, k_scales, v_pages, v_scales, block_table, pos,
                                *, window: int | None = None, block_k: int | None = None):
    """B10: B9 over int8 pages with float32 scales (P, page_size, K, 1)."""
    return _launch("paged_decode_attention_int8", q, k_pages, v_pages, block_table, pos,
                   None, k_scales, v_scales, window, block_k)


def paged_decode_attention_shard(q, k_pages, v_pages, block_table, pos, *, phase=None,
                                 k_scales=None, v_scales=None, window: int | None = None,
                                 block_k: int | None = None):
    """The shard form of B7-B10, the kernel picked as the whole form picks
    it: ragged with ``phase``, int8 with scales. block_table (R, nb) int32
    holds local page ids, entries outside [0, P) other ranks' pages. -> (o
    (R,H,hd) float32, lse (R,H) float32). ``local_table`` makes the table
    from a global one."""
    name = ("ragged_" if phase is not None else "") + "paged_decode_attention" + (
        "_int8" if k_scales is not None else "")
    return _launch(name, q, k_pages, v_pages, block_table, pos, phase, k_scales, v_scales,
                   window, block_k, shard=True)


# -- block size ---------------------------------------------------------------


def block_k_candidates(page_size: int) -> list[int]:
    """Power-of-two divisors of ``page_size``, whole pages first."""
    return [bk for bk in (page_size, page_size // 2, page_size // 4)
            if bk >= 1 and page_size % bk == 0]


def autotune_block_k(candidates) -> int:
    """The ``block_k`` to run at: the first candidate (whole pages, from
    ``block_k_candidates``). The reference times its Pallas kernels at each
    candidate; here every candidate launches the same kernel with the same
    tiles (64 keys with a bf16 q, 32 with a float32 q, several pages a
    tile), so there is nothing to time."""
    if not candidates:
        raise ValueError("no block_k candidates")
    return candidates[0]
