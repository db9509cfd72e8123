# Copy of repro/configs/xlstm_350m.py (framework-free).
"""xLSTM-350M — sLSTM + mLSTM blocks [arXiv:2405.04517].

d_ff=0: xLSTM blocks carry their own up/down projections (no separate FFN).
Pattern: 3 mLSTM : 1 sLSTM per period (the paper's 350M uses a mostly-mLSTM
mix); 24 layers = 6 periods.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    source="arXiv:2405.04517",
)
