"""Roofline of the port's decode steps on one NVIDIA H100.

The reference prices a serve step by running ``repro.roofline.analyze`` on
the compiled XLA executable, with TPU constants. The port has no executable
to analyse, so it counts the step from the engine's geometry: the FLOPs of
its matmuls, attention and combine, and the HBM bytes it must move, each
input read once and each output written once. A step's roofline is
``max(compute_s, memory_s)`` at the card's published peaks; it is a floor
under the card's time, never a prediction of it.

The constants are NVIDIA's H100 SXM5 80GB data sheet figures (dense rates,
no sparsity, at the full 700 W power limit):

* ``H100_BF16_FLOPS``: 989e12 FLOP/s, bf16 on the tensor cores, dense;
* ``H100_HBM_BYTES_S``: 3.35e12 B/s, HBM3;
* ``H100_HOST_LINK_BYTES_S``: 64e9 B/s, PCIe Gen5 x16 in one direction
  (the data sheet's 128 GB/s counts both), the link a host-tier swap
  crosses;
* ``H100_HBM_CAPACITY``: 80e9 B, the card's memory (the dry-run's count of
  cards a step's arguments need).
"""

from __future__ import annotations

from dataclasses import dataclass

H100_BF16_FLOPS = 989e12          # H100 SXM5 data sheet: bf16 tensor cores, dense
H100_HBM_BYTES_S = 3.35e12        # H100 SXM5 data sheet: HBM3
H100_HOST_LINK_BYTES_S = 64e9     # H100 SXM5 data sheet: PCIe Gen5 x16, one direction
H100_HBM_CAPACITY = 80e9          # H100 SXM5 data sheet: 80 GB of HBM3

_KV_BYTES = {"bf16": 2, "int8": 1}


@dataclass(frozen=True)
class StepCost:
    """A step's work: ``flops`` and HBM ``bytes`` moved."""

    flops: float
    bytes: float

    @property
    def compute_s(self) -> float:
        return self.flops / H100_BF16_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes / H100_HBM_BYTES_S

    @property
    def seconds(self) -> float:
        """The roofline: the larger of the two times."""
        return max(self.compute_s, self.memory_s)


def _ffn_params(cfg, i: int, kind: str) -> int:
    """Multiply-adds a row of layer i's FFN takes: SwiGLU; or a MoE layer as
    ``moe_forward`` runs it, the router and every expert's SwiGLU over its
    C = top_k buffer slots a row (a decode row is one routing group of one
    token), and the shared expert."""
    if kind not in ("attn", "swa", "rglru") or cfg.d_ff <= 0:
        return 0
    d, m = cfg.d_model, cfg.moe
    if m is None or i < m.first_k_dense:
        return 3 * d * cfg.d_ff
    n = d * m.num_experts + m.top_k * m.num_experts * 3 * d * m.expert_d_ff
    if m.num_shared_experts:
        n += 3 * d * (m.shared_d_ff or m.expert_d_ff)
    return n


def _mix_params(cfg, kind: str) -> int:
    """Multiply-adds a row of a block's mixer takes through its weights."""
    d, H = cfg.d_model, cfg.num_heads
    if kind in ("attn", "swa") and cfg.mla is not None:
        a = cfg.mla
        dn, dr, dv, r = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim, a.kv_lora_rank
        # wq, w_dkv, the absorbed q_nope . W_uk and ctx . W_uv, wo
        return d * H * (dn + dr) + d * (r + dr) + r * H * dn + r * H * dv + H * dv * d
    if kind in ("attn", "swa"):
        hd = cfg.resolved_head_dim
        return d * H * hd * 2 + d * cfg.num_kv_heads * hd * 2
    if kind == "rglru":
        return 5 * d * d                   # w_in, w_gate_br, w_a, w_x, w_out
    if kind == "mlstm":
        di = 2 * d                         # xlstm.PROJ_FACTOR
        return 2 * d * di + 3 * di * di + 2 * di * H + di * d
    if kind == "slstm":
        return 4 * d * d + 4 * d * (d // H) + 2 * d * 2 * d
    raise ValueError(f"unknown block kind {kind!r}")


def matmul_params(cfg) -> int:
    """Multiply-adds one token's decode forward takes through weights: each
    layer's mixer (q, k, v and o projections; MLA's projections in the
    absorbed form; a recurrent block's), its FFN (``_ffn_params``), and the
    unembedding. For a dense GQA stack, the weights it multiplies by."""
    n = sum(_mix_params(cfg, kind) + _ffn_params(cfg, i, kind)
            for i, kind in enumerate(cfg.blocks))
    return n + cfg.d_model * cfg.vocab_size


def _row_cost(cfg, kind: str, kv_tokens: int, kv_dtype: str) -> tuple[int, int]:
    """(FLOPs, bytes) a row of one layer spends on its cache beyond the
    weights: for GQA, 4 per head, head dim and key, the keys capped at a
    window, and each key's K and V values (int8: and their float32 scales
    per kv head); for MLA, 2 per head and latent value for the scores over
    the r + dr values of a key and 2 per head and r for the context, each
    key's bf16 latent; for a recurrent layer no keys, its state read and
    written once and 6 FLOPs per state element (mLSTM's decay, outer
    product, sum and C q; the elementwise gates of the rest)."""
    d, H = cfg.d_model, cfg.num_heads
    if kind in ("attn", "swa") and cfg.mla is not None:
        r, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
        return (2 * H * (r + dr) + 2 * H * r) * kv_tokens, (r + dr) * 2 * kv_tokens
    if kind in ("attn", "swa"):
        K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        keys = kv_tokens if kind == "attn" or cfg.sliding_window is None \
            else min(kv_tokens, cfg.sliding_window)
        per_key = 2 * K * hd * _KV_BYTES[kv_dtype] + (2 * K * 4 if kv_dtype == "int8" else 0)
        return 4 * H * hd * keys, per_key * keys
    if kind == "rglru":
        elems, nbytes = 4 * d, 3 * d * 2 + 4 * d              # conv (3, W) bf16, h float32
    elif kind == "mlstm":
        dh = 2 * d // H
        elems = H * dh * dh + H * dh + H                      # C, n, m float32
        nbytes = 4 * elems
    else:
        elems, nbytes = 4 * d, 4 * 4 * d                      # c, n, m, h float32
    return 6 * elems, 2 * nbytes


def decode_step(cfg, *, forwards: tuple[int, ...], kv_tokens: int, weight_bytes: int,
                out_rows: int, kv_dtype: str = "bf16") -> StepCost:
    """One decode step of the serve engine: ``forwards`` lists the rows of
    each decode forward it runs (the ragged step one forward of R rows; a
    signature step one a FULL group's stream and one for its COND group),
    every row attending ``kv_tokens`` keys (its block table's capacity, or
    its slot row's), and ``out_rows`` rows go through the combine.

    FLOPs: 2 per multiply-add of ``matmul_params`` and row, each layer's
    cache work per row (``_row_cost``), 5 per logit of a combined row.
    Bytes: ``weight_bytes`` (the weights the forward reads, the embedding
    table once, every expert) per forward; each row's cache bytes per layer
    (``_row_cost``); each forward's float32 logits written, and the
    combine's output."""
    if kv_dtype not in _KV_BYTES:
        raise ValueError(f"kv_dtype {kv_dtype!r} not in {tuple(_KV_BYTES)}")
    rows = sum(forwards)
    V = cfg.vocab_size
    cache = [_row_cost(cfg, kind, kv_tokens, kv_dtype) for kind in cfg.blocks]
    flops = (2 * matmul_params(cfg) + sum(f for f, _ in cache)) * rows + 5 * V * out_rows
    nbytes = weight_bytes * len(forwards) + sum(b for _, b in cache) * rows
    nbytes += 4 * V * (rows + out_rows)
    return StepCost(float(flops), float(nbytes))
