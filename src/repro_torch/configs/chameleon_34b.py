# Copy of repro/configs/chameleon_34b.py (framework-free).
"""Chameleon-34B — early-fusion VLM decoder [arXiv:2405.09818].

Early fusion: images arrive as VQ tokens inside the same vocab (65536), so
the "frontend stub" is the VQ tokenizer — ``input_specs`` provides token ids
with an interleaved-modality mask. Backbone is a dense decoder with qk-norm
(chameleon's stability fix). CFG over image tokens is standard for this
family, so the paper's selective guidance applies directly.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    source="arXiv:2405.09818",
)
