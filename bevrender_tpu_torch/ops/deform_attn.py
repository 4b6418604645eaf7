"""Deformable attention over sampled keys with the lattice rpe bias.

Counterpart of the lattice branch of bevrender_tpu/ops/deform_attn.py
(``_static_comb`` :193, ``_lattice_geometry`` :207, ``_lattice_bias`` :79,
``_lattice_bias_nm`` :474, ``_site_xla`` :531, ``streamed_deform_attention``
:866-917). Per site::

    bias[b, g, h, n, m] = bilinear(rpe_table[g, h], 0.5 * (q_pos[m] - k_pos[b, g, n]))
    out = softmax_n(scale * k . q + bias) @ v

The queries are the regular ``H x W`` lattice and the table height is
``2H - 1``, so the table coordinates separate per key into integer window
starts plus fractions (``lattice_geometry``). Window starts are clipped, so
a key displaced past the pad reads a clamped window, not zeros.

Two hand-written CUDA kernels carry this on the card (``ops/kernels``):
``lattice_bias`` computes the bias alone (sites with head width > 8, whose
scores, softmax and AV stay plain PyTorch here), and ``fused_site`` computes
bias, scores, an online softmax and AV in one pass (head width <= 8). The
functions ``lattice_bias`` and ``fused_site`` below launch them for CUDA
tensors and run their plain versions for CPU tensors.

Shapes (B batch, G groups, Hpg heads per group, ch head width, M = H * W
queries, N keys): q (B, G, Hpg, M, ch); k, v (B, G, Hpg, N, ch);
k_pos (B, G, N, 2) in (y, x) order; rpe_table (G, Hpg, 2H - 1, Wt).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bevrender_tpu_torch.ops.kernels import fused_site as _fused_site_kernel
from bevrender_tpu_torch.ops.kernels import lattice_bias as _bias_kernel

PAD = 4


def static_comb(table_shape, W: int):
    """Per-column integer starts ``u0``, fractions ``g`` and the window
    width ``m_max`` of the lattice lookup (numpy, static per shape)."""
    Wt = table_shape[3]
    Ax = (Wt - 1) / 4.0
    u_shift = Ax * (-1.0 + 2.0 * np.arange(W) / (W - 1)) + Ax
    u0 = np.floor(u_shift).astype(np.int32)
    g = (u_shift - u0).astype(np.float32)
    m_max = int(np.ceil((Wt - 1) / 2.0)) + 3 + PAD
    return u0, g, m_max


def padded_width(Wt: int, W: int) -> int:
    """Columns of the zero-padded table that the window reads come from:
    PAD on the left, max(PAD, m_max) on the right."""
    _, _, m_max = static_comb((0, 0, 0, Wt), W)
    return Wt + PAD + max(PAD, m_max)


@functools.lru_cache(maxsize=None)
def _comb_tensors(Wt: int, W: int, device: torch.device):
    u0, g, _ = static_comb((0, 0, 0, Wt), W)
    return (torch.from_numpy(u0).to(device), torch.from_numpy(g).to(device))


def lattice_geometry(table_shape, k_pos: torch.Tensor, H: int, W: int):
    """Per-key clipped window starts ``ys``, ``ms`` (int32, in the padded
    table) and fractions ``wy``, ``f`` (float32, from the unclipped starts).
    Arithmetic runs in ``k_pos``'s dtype, as in the JAX package."""
    _, _, Ht, Wt = table_shape
    if Ht != 2 * H - 1:
        raise ValueError(f"lattice bias requires Ht == 2H-1, got {Ht} vs H={H}")
    _, _, m_max = static_comb(table_shape, W)
    Ay = (Ht - 1) / 4.0
    Ax = (Wt - 1) / 4.0
    sy = -Ay * k_pos[..., 0] + (Ht - 1) / 2.0 - (H - 1) / 2.0
    sx = -Ax * k_pos[..., 1] + (Wt - 1) / 2.0 - Ax
    y0 = torch.floor(sy)
    s0 = torch.floor(sx)
    ys = torch.clamp(y0.to(torch.int32) + PAD, 0, Ht + 2 * PAD - (H + 1))
    ms = torch.clamp(s0.to(torch.int32) + PAD, 0, m_max - 3)
    return (ys.to(torch.int32), ms.to(torch.int32),
            (sy - y0).float(), (sx - s0).float())


def lattice_bias_plain(table: torch.Tensor, k_pos: torch.Tensor, H: int,
                       W: int, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the ``lattice_bias`` kernel: the n-major bias
    (B, G, Hpg, N, H*W) in float32. Both lerps run in ``compute_dtype``
    (the JAX package's default is bf16); the kernel lerps in float32 from a
    bf16 table, which is this function on the bf16-rounded table with
    ``compute_dtype=torch.float32``."""
    G, Hpg, Ht, Wt = table.shape
    B, _, N, _ = k_pos.shape
    dev = table.device
    ys, ms, wy, f = lattice_geometry(table.shape, k_pos, H, W)
    u0, g = _comb_tensors(Wt, W, dev)
    tp = torch.nn.functional.pad(
        table.to(compute_dtype), (PAD, padded_width(Wt, W) - Wt - PAD, PAD, PAD)
    )  # (G, Hpg, Yp, Xp), zero padded
    Yp, Xp = tp.shape[2], tp.shape[3]
    flat = tp.permute(0, 2, 3, 1).reshape(G * Yp * Xp, Hpg)
    rows = ys.long()[..., None] + torch.arange(H + 1, device=dev)  # (B,G,N,H+1)
    cols = (u0.long()[:, None] + torch.arange(3, device=dev)
            + ms.long()[..., None, None])  # (B, G, N, W, 3)
    gbase = torch.arange(G, device=dev).view(1, G, 1, 1, 1, 1) * Yp
    idx = (gbase + rows[..., None, None]) * Xp + cols[:, :, :, None]
    win = flat[idx]  # (B, G, N, H+1, W, 3, Hpg)

    phi = g + f[..., None]  # (B, G, N, W)
    cross = torch.floor(phi)
    wx = (phi - cross)[:, :, :, None, :, None].to(compute_dtype)
    cb = (cross > 0.5)[:, :, :, None, :, None]
    left = torch.where(cb, win[..., 1, :], win[..., 0, :])
    right = torch.where(cb, win[..., 2, :], win[..., 1, :])
    xin = (1.0 - wx) * left + wx * right  # (B, G, N, H+1, W, Hpg)
    wyc = wy.to(compute_dtype)[..., None, None, None]
    bias = (1.0 - wyc) * xin[:, :, :, :H] + wyc * xin[:, :, :, 1:]
    return bias.permute(0, 1, 5, 2, 3, 4).reshape(B, G, Hpg, N, H * W).float()


def site_consumer(q, k, v, bias, scale: float) -> torch.Tensor:
    """Scores, softmax over keys and AV on an n-major bias (``_site_xla``):
    K, Q, p and V are rounded to bf16 and multiplied with float32 sums. The
    softmax is written out as ``jax.nn.softmax`` computes it; over the keys
    axis (-2) it also avoids PyTorch's slow softmax path for a non-last
    axis. Returns (B, G, Hpg, M, ch) float32."""
    bf = torch.bfloat16
    s = torch.matmul(k.to(bf).float(), q.to(bf).float().transpose(-1, -2))
    s = s * scale + bias.float()  # (B, G, Hpg, N, M)
    e = torch.exp(s - s.amax(dim=-2, keepdim=True))
    p = e / e.sum(dim=-2, keepdim=True)
    return torch.matmul(p.to(bf).float().transpose(-1, -2), v.to(bf).float())


def site_consumer_online(q, k, v, bias, scale: float) -> torch.Tensor:
    """The ``fused_site`` kernel's own arithmetic, in PyTorch: an online
    softmax over tiles of ``KEY_TILE`` keys in base 2, with p = exp2(s - running
    max) rounded to bf16 before it multiplies V and the sum l taken from
    the unrounded p. Every float32 rounding of the kernel happens here in
    the same order: float64 holds each exact product and sum before it is
    rounded once, as an ``fmaf`` rounds it, and l and O accumulate one key
    at a time. The same function as ``site_consumer`` up to where p is
    rounded; used to hold the kernel to its own arithmetic."""
    bf, f64 = torch.bfloat16, torch.float64
    qd = q.to(bf).to(f64)
    kd = k.to(bf).to(f64)
    vd = v.to(bf).to(f64)
    bt = bias.float().transpose(-1, -2)  # (B, G, Hpg, M, N)
    sc = float(np.float32(scale))
    log2e = float(np.float32(1.4426950408889634))
    mrun = torch.full(q.shape[:-1], -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(mrun)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    tile = _fused_site_kernel.KEY_TILE
    for n0 in range(0, k.shape[-2], tile):
        kt = kd[..., n0:n0 + tile, :].unsqueeze(-3)  # (..., 1, nk, ch)
        qk = (qd[..., :, None, 0] * kt[..., 0]).float()  # exact
        for c in range(1, q.shape[-1]):  # fmaf per channel
            qk = (qk.to(f64) + qd[..., :, None, c] * kt[..., c]).float()
        s = (sc * qk.to(f64) + bt[..., n0:n0 + tile].to(f64)).float() * log2e
        mnew = torch.maximum(mrun, s.amax(dim=-1))
        alpha = torch.exp2(mrun - mnew)
        l = l * alpha
        o = o * alpha[..., None]
        p = torch.exp2(s - mnew[..., None])  # (..., M, nk)
        pb = p.to(bf).to(f64)
        for j in range(p.shape[-1]):
            l = l + p[..., j]
            o = (o.to(f64) + pb[..., j, None]
                 * vd[..., None, n0 + j, :]).float()  # fmaf per key
        mrun = mnew
    return o / torch.clamp(l, min=1e-30)[..., None]


def site_plain(q, k, v, k_pos, table, H: int, W: int, scale: float,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the ``fused_site`` kernel (``_site_xla`` with the
    plain bias)."""
    bias = lattice_bias_plain(table, k_pos, H, W, compute_dtype)
    return site_consumer(q, k, v, bias, scale)


def _kernel_args(table, k_pos, H: int, W: int):
    for t in (table, k_pos):
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "the lattice CUDA kernels are forward-only; run under "
                "torch.no_grad()"
            )
    ys, ms, wy, f = lattice_geometry(table.shape, k_pos, H, W)
    u0, g = _comb_tensors(table.shape[3], W, table.device)
    tb = table.detach().to(torch.bfloat16).contiguous()
    return (tb, ys.contiguous(), ms.contiguous(), wy.contiguous(),
            f.contiguous(), u0, g, padded_width(table.shape[3], W))


def lattice_bias(table, k_pos, H: int, W: int) -> torch.Tensor:
    """n-major rpe bias (B, G, Hpg, N, H*W): the CUDA kernel (bf16 out) for
    CUDA tensors, the plain version (bf16 lerps, float32 out) for CPU."""
    if not table.is_cuda:
        return lattice_bias_plain(table, k_pos, H, W)
    return _bias_kernel.lattice_bias_cuda(*_kernel_args(table, k_pos, H, W), H, W)


def fused_site(q, k, v, k_pos, table, H: int, W: int,
               scale: float) -> torch.Tensor:
    """Whole attention site (B, G, Hpg, M, ch) float32: the fused CUDA
    kernel for CUDA tensors, the plain version for CPU."""
    if not q.is_cuda:
        return site_plain(q, k, v, k_pos, table, H, W, scale)
    for t in (q, k, v):
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "the fused site kernel is forward-only; run under torch.no_grad()"
            )
    bf = torch.bfloat16
    return _fused_site_kernel.fused_site_cuda(
        *_kernel_args(table, k_pos, H, W),
        q.detach().to(bf).contiguous(), k.detach().to(bf).contiguous(),
        v.detach().to(bf).contiguous(), H, W, float(scale),
    )


def streamed_deform_attention(q, k, v, k_pos, rpe_table, H: int, W: int, *,
                              scale: float, fuse_site: bool) -> torch.Tensor:
    """One lattice attention site. ``fuse_site`` (eval) with head width
    <= 8 takes the fused kernel (built for widths 4 and 8; another width
    raises on the card); every other site computes the bias alone and the
    plain consumer does the rest (deform_attn.py:866-917)."""
    if fuse_site and q.shape[-1] <= 8:
        return fused_site(q, k, v, k_pos, rpe_table, H, W, scale)
    return site_consumer(q, k, v, lattice_bias(rpe_table, k_pos, H, W), scale)
