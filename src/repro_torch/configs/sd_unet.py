# Copy of repro/configs/sd_unet.py (framework-free).
"""The paper's own model family: Stable-Diffusion-style latent diffusion
UNet + text encoder.

``CONFIG`` (default) is the CPU-validation scale used by the paper-claim
benchmarks; ``PRODUCTION`` is an SD-1.5-scale UNet (~860M params, 64x64x4
latents, 77x768 text context), the width ``chip_smoke.py`` runs on the card.
"""

from repro_torch.configs.base import UNetConfig

CONFIG = UNetConfig()

PRODUCTION = UNetConfig(
    name="sd-unet-prod",
    base_channels=320,
    channel_mults=(1, 2, 4, 4),
    num_res_blocks=2,
    attn_resolutions=(2, 4, 8),
    num_heads=8,
    text_dim=768,
    text_len=77,
    latent_size=64,
    time_dim=1280,
    norm_groups=32,
)
