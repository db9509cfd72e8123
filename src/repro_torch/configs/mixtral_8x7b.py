# Copy of repro/configs/mixtral_8x7b.py (framework-free).
"""Mixtral-8x7B — sparse MoE decoder [arXiv:2401.04088].

8 experts, top-2 routing, GQA kv=8, SWA per the assignment.
"""

from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("swa",),
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=14336),
    rope_theta=1e6,
    source="arXiv:2401.04088",
)
