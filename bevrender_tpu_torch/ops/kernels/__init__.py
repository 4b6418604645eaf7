"""Hand-written CUDA kernels of the port (sources in ``csrc/``, built by
``build.py``). Each wrapper counts its launches in a module-level integer;
``counts`` and ``reset_counts`` read and clear them all."""

from bevrender_tpu_torch.ops.kernels import (
    fused_site,
    fused_site_bwd,
    fused_site_fold,
    fused_site_wide,
    lattice_bias,
    lattice_bias_bwd,
    lattice_windows,
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
    "fused_site_wide": (fused_site_wide, "launches"),
    "fused_site_wide_lse": (fused_site_wide, "launches_lse"),
    "fused_site_wide_prefetch": (fused_site_wide, "launches_prefetch"),
    "lattice_bias_wide_prefetch": (lattice_bias, "launches_wide_prefetch"),
    "fused_site_fold_rows": (fused_site_fold, "launches_rows"),
    "fused_site_fold_heads": (fused_site_fold, "launches_heads"),
    "fused_site_fold_heads_lse": (fused_site_fold, "launches_heads_lse"),
    "lattice_windows": (lattice_windows, "launches"),
    "lattice_windows_bwd": (lattice_windows, "launches_bwd"),
}


def counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
