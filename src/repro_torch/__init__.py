"""PyTorch/CUDA port of the selective-guidance SD pipeline (``repro``).

Imports ``torch`` only; never ``jax`` and nothing of the ``repro`` package.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. A CUDA device without CUDA raises: nothing
    drops to the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run on the CPU")
    return dev
