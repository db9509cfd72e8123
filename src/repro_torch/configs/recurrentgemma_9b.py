# Copy of repro/configs/recurrentgemma_9b.py (framework-free).
"""RecurrentGemma-9B — Griffin hybrid: RG-LRU + local attention, 1:2
attention:recurrent [arXiv:2402.19427].

Pattern (rglru, rglru, swa) repeated; 38 layers = 12 full periods + 2
remainder recurrent blocks. MQA (kv=1) on the local-attention blocks.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "swa"),
    sliding_window=2048,
    source="arXiv:2402.19427",
)
