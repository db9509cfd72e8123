"""Config dataclasses and the dry-run's input shapes. Copy of
``repro/configs/base.py``."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    expert_d_ff: int = 0            # routed expert hidden dim
    shared_d_ff: int = 0            # shared expert hidden dim
    first_k_dense: int = 0          # leading dense layers (DeepSeek)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # block pattern, repeated to num_layers. entries:
    #   attn | swa | rglru | slstm | mlstm
    block_pattern: tuple = ("attn",)
    sliding_window: Optional[int] = None       # native SWA width (swa blocks)
    long_context_window: int = 4096            # SWA width substituted for
                                               # full-attn blocks on long_500k
    qk_norm: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    is_encoder: bool = False
    # [audio]/[vlm] frontends are stubs: inputs arrive as embeddings
    embedding_inputs: bool = False
    # guided decoding defaults (the paper's technique)
    guidance_scale: float = 7.5
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def blocks(self) -> tuple:
        """Per-layer block kinds, pattern repeated/truncated to num_layers."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def reduced(self, **kw) -> "ModelConfig":
        """Smoke-test variant: <=2 pattern periods, small dims, <=4 experts."""
        period = len(self.block_pattern)
        n_layers = min(self.num_layers, max(2, period))
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        hd = max(16, d_model // heads)
        moe = self.moe
        if moe is not None:
            moe = replace(moe, num_experts=min(4, moe.num_experts),
                          top_k=min(2, moe.top_k),
                          num_shared_experts=min(1, moe.num_shared_experts),
                          expert_d_ff=min(128, moe.expert_d_ff or 128),
                          shared_d_ff=min(128, moe.shared_d_ff or 128),
                          first_k_dense=min(1, moe.first_k_dense))
        mla = self.mla
        if mla is not None:
            mla = replace(mla, kv_lora_rank=64, qk_nope_head_dim=32,
                          qk_rope_head_dim=16, v_head_dim=32)
        base = replace(
            self, name=self.name + "-smoke", num_layers=n_layers,
            d_model=d_model, num_heads=heads, num_kv_heads=kv, head_dim=hd,
            d_ff=min(self.d_ff, 512), vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            long_context_window=64, moe=moe, mla=mla)
        return replace(base, **kw)


@dataclass(frozen=True)
class UNetConfig:
    """SD-style latent-diffusion denoiser (the paper's own model family)."""

    name: str = "sd-unet"
    in_channels: int = 4
    out_channels: int = 4
    base_channels: int = 128
    channel_mults: tuple = (1, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: tuple = (2, 4)   # downsample factors at which attention runs
    num_heads: int = 8
    text_dim: int = 512
    text_len: int = 77
    latent_size: int = 32
    time_dim: int = 512
    norm_groups: int = 32
    source = "arXiv:2112.10752 (SD), scaled for CPU validation"

    def reduced(self) -> "UNetConfig":
        return UNetConfig(name="sd-unet-smoke", base_channels=32,
                          channel_mults=(1, 2), num_res_blocks=1,
                          attn_resolutions=(2,), num_heads=2, text_dim=64,
                          text_len=16, latent_size=8, time_dim=64,
                          norm_groups=8)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
