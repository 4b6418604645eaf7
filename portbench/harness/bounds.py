"""The yardstick of the kernels: the H100's published peaks, the least time
the card could take for each attention site's work, and the sites a step
or a request holds.

The bound functions are frozen copies of ``chip_smoke.py``'s
``bias_bounds`` (:1043) and ``site_bound`` (:692), with the heads a group
and the BEV side passed in. A site's work is what its kernels must do,
whichever kernel does it: in an eval pass a head width of 4 or 8 is a
whole site (bias, scores, softmax and AV), any other head width the bias
alone (the plain consumer does the rest); a training pass is the bias
forward and its backward at every site (the recompute under
``site_remat`` is not work). Later kernels for the same site are held to
the same bound.
"""

from __future__ import annotations

from portbench.reference.geometry import voxel_centres

# NVIDIA H100 SXM data sheet, dense rates
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
FUSED_HEAD_WIDTHS = (4, 8)


def site_bound(B, G, Hpg, ch, N, Wt, side) -> float:
    """Seconds of a whole site forward at BEV side x side: bytes (q, k, v,
    the table, the key geometry, the output) against 4 ch bf16 FLOP per
    (query, key) pair at the tensor-core rate plus 18 float32 operations."""
    M = side * side
    pairs = B * G * Hpg * M * N
    q_el, kv_el = B * G * Hpg * M * ch, B * G * Hpg * N * ch
    nbytes = ((q_el + 2 * kv_el) * 2 + G * Hpg * (2 * side - 1) * Wt * 2
              + B * G * N * 16 + side * 8 + q_el * 4)
    t_ops = pairs * 4 * ch / BF16_FLOPS + pairs * 18 / F32_FLOPS
    return max(nbytes / HBM_BPS, t_ops)


def bias_bound(B, G, Hpg, N, Wt, H, backward: bool) -> float:
    """Seconds of the bias forward or backward: each input read once, each
    output written once, against float32 operations (12 an element
    forward, 28 backward)."""
    elems = B * G * Hpg * N * H * H
    table = G * Hpg * (2 * H - 1) * Wt
    if backward:
        nbytes = elems * 2 + table * (2 + 4) + B * G * N * (16 + 8) + H * 8
        ops = elems * 28
    else:
        nbytes = elems * 2 + table * 2 + B * G * N * 16 + H * 8
        ops = elems * 12
    return max(nbytes / HBM_BPS, ops / F32_FLOPS)


def sites(m: dict, rows: int):
    """Every attention site of one encoder pass at ``rows`` samples:
    (rows of the call, G, Hpg, ch, N, Wt, H), one entry a call."""
    out = []
    V, d = m["num_views"], m["bev_depth_dim"]
    for s in range(m["n_stages"]):
        H, C = m["bev_shapes"][s], m["embed_dims"][s]
        G, nh = m["n_groups"][s], m["n_heads"][s]
        Hpg, ch = nh // G, C // nh
        k, st = m["kernel_sizes"][s], m["strides"][s]
        pad = k // 2 if k != st else 0
        hk = (H + 2 * pad - k) // st + 1
        h2 = voxel_centres(m["bev_bound"], H, d, m["sample_z_shift"]).shape[1]
        for _ in range(m["depths"][s]):
            out.append((rows, G, Hpg, ch, hk * hk, 2 * H - 1, H))
            sca = (rows, G, Hpg, ch, h2 * H * d, 2 * H * d - 1, H)
            if G >= 4:
                out.append((rows * V,) + sca[1:])
            else:
                out.extend([sca] * V)
    return out


def eval_pass_s(m: dict, rows: int) -> float:
    total = 0.0
    for B, G, Hpg, ch, N, Wt, H in sites(m, rows):
        if ch in FUSED_HEAD_WIDTHS:
            total += site_bound(B, G, Hpg, ch, N, Wt, H)
        else:
            total += bias_bound(B, G, Hpg, N, Wt, H, False)
    return total


def train_pass_s(m: dict, rows: int) -> float:
    return sum(bias_bound(B, G, Hpg, N, Wt, H, False)
               + bias_bound(B, G, Hpg, N, Wt, H, True)
               for B, G, Hpg, ch, N, Wt, H in sites(m, rows))


def step_s(m: dict, rows: int, window: int) -> float:
    """Least kernel seconds of a training step: T - 1 eval history passes
    and one training pass."""
    return (window - 1) * eval_pass_s(m, rows) + train_pass_s(m, rows)


def request_s(m: dict, rows: int, window: int) -> float:
    """Least kernel seconds of a registration request: T eval passes."""
    return window * eval_pass_s(m, rows)
