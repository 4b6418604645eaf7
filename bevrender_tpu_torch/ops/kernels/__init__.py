"""Hand-written CUDA kernels of the port (sources in ``csrc/``, built by
``build.py``). Each wrapper counts its launches in a module-level integer;
``counts`` and ``reset_counts`` read and clear them all."""

from bevrender_tpu_torch.ops.kernels import (
    fused_site,
    fused_site_bwd,
    lattice_bias,
    lattice_bias_bwd,
)

# kernel name -> (wrapper module, name of its counter)
_COUNTERS = {
    "lattice_bias": (lattice_bias, "launches"),
    "fused_site": (fused_site, "launches"),
    "lattice_bias_bwd": (lattice_bias_bwd, "launches"),
    "fused_site_lse": (fused_site, "launches_lse"),
    "fused_site_bwd": (fused_site_bwd, "launches"),
    "lattice_bias_wide": (lattice_bias, "launches_wide"),
    "lattice_bias_wide_bwd": (lattice_bias_bwd, "launches_wide"),
}


def counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
