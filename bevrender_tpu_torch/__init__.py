"""PyTorch + CUDA port of bevrender_tpu for NVIDIA Hopper (H100).

The module layout mirrors ``bevrender_tpu`` so each counterpart is easy to
find. This package imports ``torch`` and never JAX, flax or anything of the
JAX package. Entry points run on ``device="cuda"`` unless the caller asks
for the CPU, where every hand-written kernel is replaced by its plain
PyTorch version.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    an entry point never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
