"""Hand-written CUDA kernels of the port (sources in ``csrc/``, built by
``build.py``). Each wrapper counts its launches in a module-level integer
``launches``; ``counts`` and ``reset_counts`` read and clear them all."""

from bevrender_tpu_torch.ops.kernels import fused_site, lattice_bias

_WRAPPERS = {"lattice_bias": lattice_bias, "fused_site": fused_site}


def counts() -> dict:
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0
