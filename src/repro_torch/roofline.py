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
  crosses.
"""

from __future__ import annotations

from dataclasses import dataclass

H100_BF16_FLOPS = 989e12          # H100 SXM5 data sheet: bf16 tensor cores, dense
H100_HBM_BYTES_S = 3.35e12        # H100 SXM5 data sheet: HBM3
H100_HOST_LINK_BYTES_S = 64e9     # H100 SXM5 data sheet: PCIe Gen5 x16, one direction

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


def matmul_params(cfg) -> int:
    """Weights one token's decode forward multiplies by: each layer's q, k,
    v and o projections and SwiGLU, and the unembedding."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2
    mlp = 3 * d * cfg.d_ff if cfg.d_ff > 0 else 0
    return cfg.num_layers * (attn + mlp) + d * cfg.vocab_size


def decode_step(cfg, *, forwards: tuple[int, ...], kv_tokens: int, weight_bytes: int,
                out_rows: int, kv_dtype: str = "bf16") -> StepCost:
    """One decode step of the serve engine: ``forwards`` lists the rows of
    each decode forward it runs (the ragged step one forward of R rows; a
    signature step one a FULL group's stream and one for its COND group),
    every row attending ``kv_tokens`` keys (its block table's capacity),
    and ``out_rows`` rows go through the combine.

    FLOPs: 2 per weight and row, 4 per head, head dim, key and row for the
    attention, 5 per logit of a combined row. Bytes: ``weight_bytes`` (the
    weights the forward reads, the embedding table once) per forward; per
    row, layer and key the K and V values at the pool's dtype and, for
    int8, their float32 scales per kv head; each forward's float32 logits
    written, and the combine's output."""
    if kv_dtype not in _KV_BYTES:
        raise ValueError(f"kv_dtype {kv_dtype!r} not in {tuple(_KV_BYTES)}")
    rows = sum(forwards)
    K, hd, L, V = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers, cfg.vocab_size
    flops = 2 * matmul_params(cfg) * rows
    flops += 4 * cfg.num_heads * hd * kv_tokens * rows * L
    flops += 5 * V * out_rows
    kv_per_key = 2 * K * hd * _KV_BYTES[kv_dtype] + (2 * K * 4 if kv_dtype == "int8" else 0)
    nbytes = weight_bytes * len(forwards)
    nbytes += kv_per_key * kv_tokens * rows * L
    nbytes += 4 * V * (rows + out_rows)
    return StepCost(float(flops), float(nbytes))
