# Copy of repro/configs/qwen3_14b.py (framework-free).
"""Qwen3-14B — dense decoder with qk-norm + GQA [hf:Qwen/Qwen3-8B]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)
