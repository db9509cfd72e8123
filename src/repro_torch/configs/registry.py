"""Architecture registry for the dense decoders the port runs. Counterpart
of ``repro/configs/registry.py``, limited to the stacks whose blocks are all
``attn``/``swa`` (the MoE, MLA and recurrent families come with later
slices)."""

from __future__ import annotations

from repro_torch.configs import h2o_danube3_4b, llama3_2_1b, qwen3_14b, yi_9b

ARCHS = {
    "llama3.2-1b": llama3_2_1b.CONFIG,
    "qwen3-14b": qwen3_14b.CONFIG,
    "yi-9b": yi_9b.CONFIG,
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
