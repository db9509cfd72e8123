# Copy of repro/configs/hubert_xlarge.py (framework-free).
"""HuBERT-XLarge — audio encoder backbone [arXiv:2106.07447].

Encoder-only (wav2vec2-family) transformer. The conv waveform feature
extractor is a stub per the assignment carve-out: ``input_specs`` provides
precomputed frame embeddings of shape (batch, frames, d_model). vocab=504 is
the masked-prediction target codebook. No decode shapes (encoder-only) —
see DESIGN.md §5.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    block_pattern=("attn",),
    is_encoder=True,
    embedding_inputs=True,
    guidance_scale=1.0,   # CFG inapplicable (encoder) — see DESIGN.md
    source="arXiv:2106.07447",
)
