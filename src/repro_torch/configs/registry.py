"""Architecture registry: all ten of the reference's architectures.
Counterpart of ``repro/configs/registry.py`` (``sd-unet`` has its own
config, ``configs/sd_unet.py``)."""

from __future__ import annotations

from repro_torch.configs import (
    chameleon_34b,
    deepseek_v2_lite_16b,
    h2o_danube3_4b,
    hubert_xlarge,
    llama3_2_1b,
    mixtral_8x7b,
    qwen3_14b,
    recurrentgemma_9b,
    xlstm_350m,
    yi_9b,
)

ARCHS = {
    "hubert-xlarge": hubert_xlarge.CONFIG,
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b.CONFIG,
    "qwen3-14b": qwen3_14b.CONFIG,
    "xlstm-350m": xlstm_350m.CONFIG,
    "yi-9b": yi_9b.CONFIG,
    "llama3.2-1b": llama3_2_1b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "h2o-danube-3-4b": h2o_danube3_4b.CONFIG,
}


def list_archs() -> list[str]:
    return sorted(ARCHS)


def get_config(arch: str):
    try:
        return ARCHS[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; the port has {list_archs()}") from None


def get_smoke_config(arch: str):
    return get_config(arch).reduced()
