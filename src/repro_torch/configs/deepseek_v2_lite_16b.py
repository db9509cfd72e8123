# Copy of repro/configs/deepseek_v2_lite_16b.py (framework-free).
"""DeepSeek-V2-Lite (16B total) — MLA + fine-grained MoE [arXiv:2405.04434].

MLA with kv_lora_rank=512 (compressed KV cache); 2 shared + 64 routed
experts, top-6, expert hidden 1408; first layer dense. The assignment
bracket mentions "160 routed" (that is full V2); the headline spec
"MoE 64e top-6" matches the actual V2-Lite card and is what we implement.
"""

from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,          # dense-layer hidden; routed experts use 1408
    vocab_size=102400,
    block_pattern=("attn",),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  expert_d_ff=1408, shared_d_ff=2816, first_k_dense=1),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    source="arXiv:2405.04434",
)
