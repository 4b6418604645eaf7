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

Hand-written CUDA kernels carry this on the card (``ops/kernels``):
``lattice_bias`` computes the bias alone (sites of head widths other than
4 and 8, and every site of a training pass unless ``fused_bwd`` is chosen;
scores, softmax and AV stay plain PyTorch there) and ``lattice_bias_bwd`` is
its backward, or ``lattice_bias_wide`` and ``lattice_bias_wide_bwd`` where the
table does not fit their shared memory (``bias_route``); ``fused_site``
computes bias, scores, an online softmax and AV in one pass (head width 4
or 8, no gradient), ``fused_site_lse`` also returns the logsumexp and
``fused_site_bwd`` is the flash-style backward of that site;
``fused_site_wide`` and ``fused_site_wide_lse`` are the fused site on a
table that does not fit ``fused_site``'s shared memory (``site_route``).
``SiteOptions.lattice_route="wide"`` sends every site to the wide kernels,
and ``site_prefetch`` / ``bias_forward="prefetch"`` take their variants
that stage the key windows in shared memory by asynchronous copies
(``fused_site_wide_prefetch``, ``lattice_bias_wide_prefetch``).
``site_fold_rows`` and ``site_fold_heads`` take the folded kernels, whose
block serves every head of a (b, g) cell (``fused_site_fold_rows`` in place
of ``fused_site``, ``fused_site_fold_heads`` in place of
``fused_site_wide_prefetch``, and ``fused_site_fold_heads_lse`` as the
forward of a ``fused_bwd`` site under ``fused_fwd_fold``).
``SiteOptions.bias_forward="windows"`` takes the JAX package's windowed
bias at every bias site instead (``lattice_bias_windowed``:
``lattice_windows`` cuts each key's window of the rearranged table,
``lattice_windows_bwd`` adds the windows' cotangents back).
``site_kernels`` makes every choice, from the shapes and the options
alone.
The functions ``lattice_bias``, ``fused_site`` and ``fused_site_train``
below launch the kernels for CUDA tensors and run their plain versions,
with autograd, for CPU tensors.

Shapes (B batch, G groups, Hpg heads per group, ch head width, M = H * W
queries, N keys): q (B, G, Hpg, M, ch); k, v (B, G, Hpg, N, ch);
k_pos (B, G, N, 2) in (y, x) order; rpe_table (G, Hpg, 2H - 1, Wt).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from bevrender_tpu_torch.ops.kernels import fused_site as _fused_site_kernel
from bevrender_tpu_torch.ops.kernels import fused_site_bwd as _site_bwd_kernel
from bevrender_tpu_torch.ops.kernels import fused_site_fold as _fold_kernel
from bevrender_tpu_torch.ops.kernels import fused_site_wide as _wide_site_kernel
from bevrender_tpu_torch.ops.kernels import lattice_bias as _bias_kernel
from bevrender_tpu_torch.ops.kernels import lattice_bias_bwd as _bias_bwd_kernel
from bevrender_tpu_torch.ops.kernels import lattice_windows as _win_kernel
from bevrender_tpu_torch.ops.kernels._launch import (
    PAD,
    SMEM_PER_BLOCK,
    padded_width,
    window_width,
)
from bevrender_tpu_torch.parallel import dist as pdist

# float32 constants of the site kernels, which keep their scores in base 2
LOG2E = float(np.float32(1.4426950408889634))
LN2 = float(np.float32(0.6931471805599453))


def static_comb(table_shape, W: int):
    """Per-column integer starts ``u0``, fractions ``g`` and the window
    width ``m_max`` of the lattice lookup (numpy, static per shape)."""
    Wt = table_shape[3]
    Ax = (Wt - 1) / 4.0
    u_shift = Ax * (-1.0 + 2.0 * np.arange(W) / (W - 1)) + Ax
    u0 = np.floor(u_shift).astype(np.int32)
    g = (u_shift - u0).astype(np.float32)
    m_max = window_width(Wt)
    return u0, g, m_max


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


def lattice_t3(table: torch.Tensor, W: int,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The column-rearranged table the windows are cut from (``T3`` of
    ``_lattice_bias``, deform_attn.py:131-145): the table in
    ``compute_dtype``, zero-padded (PAD rows above and below, PAD columns on
    the left, up to ``padded_width`` on the right), with per query column ix
    the ``m_max`` columns from its start ``u0[ix]``:
    ``t3[g, y, m, ix * Hpg + h] = padded[g, h, y, u0[ix] + m]``, (G, Ht + 2
    PAD, m_max, W * Hpg). Plain ops, so autograd carries the gradient back
    to ``table``."""
    G, Hpg, Ht, Wt = table.shape
    u0, _ = _comb_tensors(Wt, W, table.device)
    _, _, m_max = static_comb(table.shape, W)
    tp = torch.nn.functional.pad(
        table.to(compute_dtype), (PAD, padded_width(Wt) - Wt - PAD, PAD, PAD)
    )  # (G, Hpg, Yp, Xp)
    cols = u0.long() + torch.arange(m_max, device=table.device)[:, None]
    t3 = tp[:, :, :, cols]  # (G, Hpg, Yp, m_max, W)
    return t3.permute(0, 2, 3, 4, 1).reshape(G, Ht + 2 * PAD, m_max, W * Hpg)


def lattice_mix(win, wy, f, g, H: int, W: int,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The bias from each key's windows ``win`` (B, G, N, 3, H + 1, W * Hpg),
    m-major as ``lattice_windows`` cuts them, its fractions wy, f (B, G, N)
    and the per-column fractions ``g`` (W,) of ``static_comb``: per query
    column the two x-lerps between the window columns its fraction selects,
    then the y-lerp between neighbouring rows, each in ``compute_dtype``
    (deform_attn.py:178-189). Returns the n-major bias (B, G, Hpg, N, H * W)
    in float32."""
    B, G, N = wy.shape
    win = win.reshape(B, G, N, 3, H + 1, W, -1)
    Hpg = win.shape[-1]
    phi = g + f[..., None]  # (B, G, N, W)
    cross = torch.floor(phi)
    wx = (phi - cross)[:, :, :, None, :, None].to(compute_dtype)
    cb = (cross > 0.5)[:, :, :, None, :, None]
    left = torch.where(cb, win[:, :, :, 1], win[:, :, :, 0])
    right = torch.where(cb, win[:, :, :, 2], win[:, :, :, 1])
    xin = (1.0 - wx) * left + wx * right  # (B, G, N, H+1, W, Hpg)
    wyc = wy.to(compute_dtype)[..., None, None, None]
    bias = (1.0 - wyc) * xin[:, :, :, :H] + wyc * xin[:, :, :, 1:]
    return bias.permute(0, 1, 5, 2, 3, 4).reshape(B, G, Hpg, N, H * W).float()


def lattice_bias_plain(table: torch.Tensor, k_pos: torch.Tensor, H: int,
                       W: int, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the bias kernels (``lattice_bias``,
    ``lattice_bias_wide``, ``lattice_bias_wide_prefetch``) and of the
    windowed bias: the n-major bias (B, G, Hpg, N, H*W) in float32, from
    the windows of ``lattice_t3`` mixed by ``lattice_mix``. Both lerps run
    in ``compute_dtype`` (the JAX package's default is bf16); the kernels
    lerp in float32 from a bf16 table, which is this function on the
    bf16-rounded table with ``compute_dtype=torch.float32``."""
    ys, ms, wy, f = lattice_geometry(table.shape, k_pos, H, W)
    _, g = _comb_tensors(table.shape[3], W, table.device)
    win = _win_kernel.lattice_windows_plain(
        lattice_t3(table, W, compute_dtype), ys, ms, H + 1)
    return lattice_mix(win, wy, f, g, H, W, compute_dtype)


def site_consumer(q, k, v, bias, scale: float, keep=None,
                  dropout_rate: float = 0.0) -> torch.Tensor:
    """Scores, softmax over keys and AV on an n-major bias (``_site_xla``):
    K, Q, p and V are rounded to bf16 and multiplied with float32 sums. The
    softmax is written out as ``jax.nn.softmax`` computes it; over the keys
    axis (-2) it also avoids PyTorch's slow softmax path for a non-last
    axis. ``keep`` (bool, the shape of the scores) is an attention-dropout
    mask: kept probabilities are divided by ``1 - dropout_rate``. Autograd
    runs through it: the training path differentiates this function.
    Returns (B, G, Hpg, M, ch) float32."""
    bf = torch.bfloat16
    s = torch.matmul(k.to(bf).float(), q.to(bf).float().transpose(-1, -2))
    s = s * scale + bias.float()  # (B, G, Hpg, N, M)
    e = torch.exp(s - s.amax(dim=-2, keepdim=True))
    p = e / e.sum(dim=-2, keepdim=True)
    if keep is not None:
        p = torch.where(keep, p / (1.0 - dropout_rate), torch.zeros_like(p))
    return torch.matmul(p.to(bf).float().transpose(-1, -2), v.to(bf).float())


def site_consumer_online(q, k, v, bias, scale: float, return_lse: bool = False):
    """The fused site kernels' own arithmetic (``fused_site``,
    ``fused_site_wide``, ``fused_site_wide_prefetch`` and the folded
    ``fused_site_fold_rows`` and ``fused_site_fold_heads``), in PyTorch: an
    online softmax over tiles of ``KEY_TILE`` keys in base 2, with p =
    exp2(s - running max) rounded to bf16 before it multiplies V and the sum
    l taken from the unrounded p. Every float32 rounding of the kernel happens here in
    the same order: float64 holds each exact product and sum before it is
    rounded once, as an ``fmaf`` rounds it, and l and O accumulate one key
    at a time. The same function as ``site_consumer`` up to where p is
    rounded; used to hold the kernel to its own arithmetic. With
    ``return_lse`` also the logsumexp (B, G, Hpg, M) in natural-log units as
    the ``fused_site_lse`` instance writes it."""
    bf, f64 = torch.bfloat16, torch.float64
    qd = q.to(bf).to(f64)
    kd = k.to(bf).to(f64)
    vd = v.to(bf).to(f64)
    bt = bias.float().transpose(-1, -2)  # (B, G, Hpg, M, N)
    sc = float(np.float32(scale))
    mrun = torch.full(q.shape[:-1], -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(mrun)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    tile = _fused_site_kernel.KEY_TILE
    for n0 in range(0, k.shape[-2], tile):
        kt = kd[..., n0:n0 + tile, :].unsqueeze(-3)  # (..., 1, nk, ch)
        qk = (qd[..., :, None, 0] * kt[..., 0]).float()  # exact
        for c in range(1, q.shape[-1]):  # fmaf per channel
            qk = (qk.to(f64) + qd[..., :, None, c] * kt[..., c]).float()
        s = (sc * qk.to(f64) + bt[..., n0:n0 + tile].to(f64)).float() * LOG2E
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
    lsafe = torch.clamp(l, min=1e-30)
    out = o / lsafe[..., None]
    if return_lse:
        return out, (mrun + torch.log2(lsafe)) * LN2
    return out


def site_plain(q, k, v, k_pos, table, H: int, W: int, scale: float,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the fused site kernels (``fused_site``,
    ``fused_site_wide``, ``fused_site_wide_prefetch``,
    ``fused_site_fold_rows``, ``fused_site_fold_heads``; ``_site_xla`` with
    the plain bias). Autograd through it is the plain version of the
    ``fused_site_bwd`` kernel."""
    bias = lattice_bias_plain(table, k_pos, H, W, compute_dtype)
    return site_consumer(q, k, v, bias, scale)


def site_plain_lse(q, k, v, k_pos, table, H: int, W: int, scale: float,
                   compute_dtype=torch.bfloat16):
    """Plain version of the logsumexp instances (``fused_site_lse``,
    ``fused_site_wide_lse``, ``fused_site_fold_heads_lse``): ``site_plain``
    and the logsumexp of the scores over the keys, (B, G, Hpg, M)."""
    bf = torch.bfloat16
    bias = lattice_bias_plain(table, k_pos, H, W, compute_dtype)
    s = torch.matmul(k.to(bf).float(), q.to(bf).float().transpose(-1, -2))
    lse = torch.logsumexp(s * scale + bias, dim=-2)
    return site_consumer(q, k, v, bias, scale), lse


def site_bwd_online(q, k, v, k_pos, table, H: int, W: int, scale: float,
                    dout, lse, dsum):
    """The ``fused_site_bwd`` kernel's own roundings, in PyTorch, on whole
    (B, G, Hpg, N, M) tensors: the bias lerped in float32 from the
    bf16-rounded table, scores in base 2, p = exp2(s - lse) from the given
    logsumexp, p, ds and dO rounded to bf16 before they multiply, float32
    sums, and the unrounded ds as the cotangent of the bias. Scores, p, dp
    and ds repeat the kernel's float32 roundings one by one (its q . k and
    v . dO are fmaf chains); only the order of the float32 sums of the
    outputs differs from the kernel (tensor-core sums, atomics), so the two
    agree far more closely than either does with autograd through
    ``site_plain``, which rounds elsewhere. ``dsum`` is rowsum(dO * O).
    Returns (dq, dk, dv, dtable, dk_pos), float32."""
    bf, f64 = torch.bfloat16, torch.float64
    tb = table.detach().to(bf).float().requires_grad_()
    kp = k_pos.detach().clone().requires_grad_()
    with torch.enable_grad():
        bias = lattice_bias_plain(tb, kp, H, W, torch.float32)
    with torch.no_grad():
        qd, kd, vd = (t.detach().to(bf).to(f64) for t in (q, k, v))
        dob = dout.to(bf).to(f64)  # (B, G, Hpg, M, ch)
        # q . k and v . dO as the kernel's fmaf chains: float64 holds each
        # exact product and sum before it is rounded once
        qk = (kd[..., :, None, 0] * qd[..., None, :, 0]).float()  # (.., N, M)
        dp = (vd[..., :, None, 0] * dob[..., None, :, 0]).float()
        for c in range(1, q.shape[-1]):
            qk = (qk.to(f64) + kd[..., :, None, c] * qd[..., None, :, c]).float()
            dp = (dp.to(f64) + vd[..., :, None, c] * dob[..., None, :, c]).float()
        sc = float(np.float32(scale))
        s2 = (sc * qk.to(f64) + bias.to(f64)).float() * LOG2E
        p = torch.exp2(s2 - (lse * LOG2E)[..., None, :])
        ds = p * (dp - dsum[..., None, :])
        dsb = ds.to(bf).float()
        qf, kf = qd.float(), kd.float()
        dv = torch.matmul(p.to(bf).float(), dob.float())
        dk = sc * torch.matmul(dsb, qf)
        dq = sc * torch.matmul(dsb.transpose(-1, -2), kf)
    dtable, dkpos = torch.autograd.grad(bias, (tb, kp), ds)
    return dq, dk, dv, dtable, dkpos


def _geometry_args(table, k_pos, H: int, W: int):
    """(ys, ms, wy, f, u0, g, Xp) as the kernels take them; wy and f carry
    the graph back to ``k_pos`` (the integer starts carry no gradient)."""
    ys, ms, wy, f = lattice_geometry(table.shape, k_pos, H, W)
    u0, g = _comb_tensors(table.shape[3], W, table.device)
    return (ys.contiguous(), ms.contiguous(), wy.contiguous(), f.contiguous(),
            u0, g, padded_width(table.shape[3]))


def _kernel_args(table, k_pos, H: int, W: int):
    """The kernels' leading arguments, detached: the bf16 table and
    ``_geometry_args``."""
    return (table.detach().to(torch.bfloat16).contiguous(),
            *_geometry_args(table, k_pos.detach(), H, W))


def bias_route(table_shape, H: int, W: int) -> str:
    """Which bias kernels a site takes on the card, from its shapes alone:
    "whole" (``lattice_bias`` / ``lattice_bias_bwd``) when a group's
    zero-padded bf16 table (Hpg heads) fits in the shared memory of one
    block, and so does one head's table with its float32 gradient (6 bytes
    an entry); "wide" (``lattice_bias_wide`` / ``lattice_bias_wide_bwd``)
    when not. The padded table is (2H - 1 + 2 PAD) x ``padded_width``; a
    block may use ``SMEM_PER_BLOCK`` (227 KB on an H100). Of the pyramid's
    sites only SCA at BEV 56 is wide (2 x 119 x 849 x 2 B = 404 KB
    forward); its TSA at BEV 56 (84 KB forward, 126 KB backward) and every
    flagship site are whole."""
    _, Hpg, Ht, Wt = table_shape
    padded = (Ht + 2 * PAD) * padded_width(Wt)
    fits = max(Hpg * padded * 2, padded * 6) <= SMEM_PER_BLOCK
    return "whole" if fits else "wide"


def site_route(table_shape, H: int, W: int, ch: int) -> str:
    """Which fused-site kernel a narrow-head site takes on the card, from
    its shapes alone: "whole" (``fused_site``) when one head's zero-padded
    bf16 table and the two key stages of the whole-table template (K and V
    in bf16, four words of geometry a key) fit in the shared memory of one
    block, as csrc/fused_site.cu lays them out
    (``fused_site_fold.whole_smem`` at one head); "wide"
    (``fused_site_wide``, which then reads the raw table through L1, its
    path "raw") when not. A route of the shapes, not a fallback. Every
    shipped site is whole: the largest table, the pyramid's SCA at BEV 56,
    needs 202 KB; a narrow head at BEV 64 with depth 5 (127 x 639) would
    need 262 KB. The stages take 640 bytes more than the float32 key tile
    of the kernel before the template, so a table within those 640 bytes
    of the limit, which took "whole" then, takes "wide"."""
    _, _, Ht, Wt = table_shape
    need = _fold_kernel.whole_smem(1, Ht, padded_width(Wt), ch)
    return "whole" if need <= SMEM_PER_BLOCK else "wide"


def _site_bwd_fits(table_shape, W: int, ch: int) -> bool:
    """Whether csrc/fused_site_bwd.cu's shared memory fits one block at its
    smallest (``fused_site_bwd.smem_bytes`` at one warp): one head's
    zero-padded table in bf16 with its gradient in float32 (6 B an entry),
    a strip of 32 queries (q and dO in float32, four words of geometry a
    query) and the warp's float32 (32, ch) dq buffer. That is the size of
    the kernel before its redesign, so the same sites fit; a block runs
    more warps, each with its own dq buffer, only as far as shared memory
    has room (``fused_site_bwd.tiling``)."""
    _, _, Ht, Wt = table_shape
    need = _site_bwd_kernel.smem_bytes(Ht, padded_width(Wt), ch)
    return need <= SMEM_PER_BLOCK


SITE_REMAT_MODES = ("nothing", "dots", "none")
LATTICE_ROUTES = ("auto", "wide")
BIAS_FORWARDS = ("kernel", "prefetch", "windows")


@dataclasses.dataclass(frozen=True)
class SiteOptions:
    """The kernel choice of an attention site, from the port's config in
    place of the JAX package's trace-time environment knobs: ``fused_bwd``,
    ``site_remat`` and ``fused_fwd_fold`` (``TrainConfig``) replace
    BEVRENDER_FUSED_BWD, BEVRENDER_SITE_REMAT and BEVRENDER_TRAIN_FWD_V2;
    ``lattice_route``, ``site_prefetch``, ``bias_forward="prefetch"``,
    ``site_fold_heads`` and ``site_fold_rows`` (``ModelConfig``) replace
    BEVRENDER_SHIFT_REPLICA, BEVRENDER_SITE_DMA=1, BEVRENDER_BIAS_DMA=1,
    BEVRENDER_SITE_DMA=2 and BEVRENDER_SITE_SH2=1 (``site_kernels``).
    ``site_fold_heads`` folds the window-prefetch site, so it needs
    ``site_prefetch``; ``fused_fwd_fold=None`` follows it.
    ``bias_forward="windows"`` takes the JAX package's windowed bias,
    ``_lattice_bias(use_kernel=True)``, at every site that takes the bias:
    the parity route of the JAX package's window kernels, slower than the
    bias kernels."""

    fused_bwd: bool = False
    site_remat: str = "nothing"
    lattice_route: str = "auto"
    site_prefetch: bool = False
    bias_forward: str = "kernel"
    site_fold_heads: bool = False
    site_fold_rows: bool = False
    fused_fwd_fold: bool | None = None

    def __post_init__(self):
        if self.site_remat not in SITE_REMAT_MODES:
            raise ValueError(f"site_remat must be one of {SITE_REMAT_MODES}, "
                             f"got {self.site_remat!r}")
        if self.lattice_route not in LATTICE_ROUTES:
            raise ValueError(f"lattice_route must be one of {LATTICE_ROUTES}, "
                             f"got {self.lattice_route!r}")
        if self.bias_forward not in BIAS_FORWARDS:
            raise ValueError(f"bias_forward must be one of {BIAS_FORWARDS}, "
                             f"got {self.bias_forward!r}")
        if self.site_fold_heads and not self.site_prefetch:
            raise ValueError("site_fold_heads folds the window-prefetch site: "
                             "it needs site_prefetch=True")

    @property
    def fold_train_forward(self) -> bool:
        """Whether a ``fused_bwd`` site's forward folds the heads."""
        return (self.site_fold_heads if self.fused_fwd_fold is None
                else self.fused_fwd_fold)


def site_kernels(q_shape, table_shape, H: int, W: int, options: SiteOptions,
                 training: bool, dropout: bool = False) -> tuple:
    """The kernels one lattice site launches on the card, one name (of
    ``ops.kernels.counts``) per launch, in order: those of its forward when
    ``training`` is false, those of a forward and its backward when it is
    true. A site whose head width has a fused-site instance (4 or 8,
    ``fused_site.HEAD_WIDTHS``) and no attention ``dropout`` takes the fused
    site in eval, and in training under ``fused_bwd`` its logsumexp
    instance and the site backward where ``fused_site_bwd.cu``'s shared
    memory holds one head's table and its float32 gradient
    (``_site_bwd_fits``). Every other site takes the bias (and, training,
    the bias again in the backward under ``site_remat`` "nothing" or
    "dots", and the bias backward) with the plain consumer: other head widths, dropout, a
    training site without ``fused_bwd``, and a ``fused_bwd`` site whose
    table the site backward cannot hold, which so trains on the route it
    takes without ``fused_bwd``. These are routes of the shapes, not
    fallbacks. The route is ``site_route``'s or ``bias_route``'s under
    ``lattice_route="auto"`` and "wide" under "wide"; on the wide route
    ``site_prefetch`` and ``bias_forward="prefetch"`` take the prefetch
    variants of the eval fused site and of the bias forward.
    ``bias_forward="windows"`` takes the windowed bias on either route:
    ``lattice_windows`` forward and ``lattice_windows_bwd`` backward,
    which need no shared memory. Where
    the heads fold (``fused_site_fold``: Hpg * W <= 128 and the shared
    memory fits, the JAX package's shape rule), ``site_fold_rows`` takes
    ``fused_site_fold_rows`` for ``fused_site``, ``site_fold_heads``
    ``fused_site_fold_heads`` for ``fused_site_wide_prefetch``, and
    ``fold_train_forward`` the forward ``fused_site_fold_heads_lse`` of a
    ``fused_bwd`` site on either route. ``streamed_deform_attention``
    dispatches on the first name, so a run's launch counts follow from the
    shapes and the options alone."""
    ch = q_shape[-1]
    wide = options.lattice_route == "wide"
    _, Hpg, Ht, Wt = table_shape
    fused = (ch in _fused_site_kernel.HEAD_WIDTHS and not dropout
             and (not training
                  or (options.fused_bwd and _site_bwd_fits(table_shape, W, ch))))
    if fused:
        route = "wide" if wide else site_route(table_shape, H, W, ch)
        heads_fold = _fold_kernel.heads_fit(Hpg, Wt, H, W, ch)
        if not training:
            if route == "whole":
                rows_fold = _fold_kernel.rows_fit(
                    Hpg, Ht, padded_width(Wt), W, ch)
                return ("fused_site_fold_rows"
                        if options.site_fold_rows and rows_fold
                        else "fused_site",)
            if not options.site_prefetch:
                return ("fused_site_wide",)
            return ("fused_site_fold_heads"
                    if options.site_fold_heads and heads_fold
                    else "fused_site_wide_prefetch",)
        if options.fold_train_forward and heads_fold:
            fwd = "fused_site_fold_heads_lse"
        else:
            fwd = "fused_site_lse" if route == "whole" else "fused_site_wide_lse"
        return (fwd, "fused_site_bwd")
    if options.bias_forward == "windows":
        fwd, bwd = "lattice_windows", "lattice_windows_bwd"
    elif wide or bias_route(table_shape, H, W) == "wide":
        fwd = ("lattice_bias_wide_prefetch"
               if options.bias_forward == "prefetch" else "lattice_bias_wide")
        bwd = "lattice_bias_wide_bwd"
    else:
        fwd, bwd = "lattice_bias", "lattice_bias_bwd"
    if not training:
        return (fwd,)
    # "nothing" and "dots" both recompute the bias in the backward: the
    # bias's autograd Function is not a matrix product
    return (fwd, bwd) if options.site_remat == "none" else (fwd, fwd, bwd)


def _bias_forward(kernel: str, tb, ys, ms, wy, f, u0, g, Xp: int, H: int,
                  W: int):
    if kernel == "lattice_bias":
        return _bias_kernel.lattice_bias_cuda(tb, ys, ms, wy, f, u0, g, Xp,
                                              H, W)
    if kernel == "lattice_bias_wide":
        return _bias_kernel.lattice_bias_wide_cuda(tb, ys, ms, wy, f, u0, g,
                                                   H, W)
    if kernel == "lattice_bias_wide_prefetch":
        return _bias_kernel.lattice_bias_wide_prefetch_cuda(
            tb, ys, ms, wy, f, u0, g, H, W)
    raise ValueError(f"no bias forward kernel {kernel!r}")


class _LatticeBiasFn(torch.autograd.Function):
    """Bias forward kernel ``kernel``, and the backward kernel of its route
    as the backward. Differentiable inputs: the table and the fractions wy,
    f."""

    @staticmethod
    def forward(ctx, table, wy, f, ys, ms, u0, g, Xp, H, W, kernel):
        tb = table.to(torch.bfloat16).contiguous()
        ctx.save_for_backward(tb, ys, ms, wy, f, u0, g)
        ctx.meta = (Xp, H, W, table.dtype, kernel != "lattice_bias")
        return _bias_forward(kernel, tb, ys, ms, wy, f, u0, g, Xp, H, W)

    @staticmethod
    def backward(ctx, gout):
        Xp, H, W, dtype, wide = ctx.meta
        bwd = (_bias_bwd_kernel.lattice_bias_wide_bwd_cuda if wide
               else _bias_bwd_kernel.lattice_bias_bwd_cuda)
        dtable, dwy, df = bwd(*ctx.saved_tensors, Xp, gout.contiguous(), H, W)
        return (dtable.to(dtype), dwy, df) + (None,) * 8


class _FusedSiteTrainFn(torch.autograd.Function):
    """``fused_site_lse``, ``fused_site_wide_lse`` or
    ``fused_site_fold_heads_lse`` kernel forward, ``fused_site_bwd`` kernel
    backward. Saves q, k, v in bf16, the geometry, the output and the
    logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, table, wy, f, ys, ms, u0, g, Xp, H, W, scale,
                kernel):
        bf = torch.bfloat16
        tb = table.to(bf).contiguous()
        qb, kb, vb = (t.to(bf).contiguous() for t in (q, k, v))
        if kernel == "fused_site_lse":
            out, lse = _fused_site_kernel.fused_site_lse_cuda(
                tb, ys, ms, wy, f, u0, g, Xp, qb, kb, vb, H, W, scale)
        else:
            launch = {
                "fused_site_wide_lse": _wide_site_kernel.fused_site_wide_lse_cuda,
                "fused_site_fold_heads_lse":
                    _fold_kernel.fused_site_fold_heads_lse_cuda}.get(kernel)
            if launch is None:
                raise ValueError(f"no fused training site kernel {kernel!r}")
            out, lse = launch(tb, ys, ms, wy, f, u0, g, qb, kb, vb, H, W, scale)
        ctx.save_for_backward(tb, ys, ms, wy, f, u0, g, qb, kb, vb, out, lse)
        ctx.meta = (Xp, H, W, scale, q.dtype, k.dtype, v.dtype, table.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        Xp, H, W, scale, qd, kd, vd, td = ctx.meta
        *args, out, lse = ctx.saved_tensors
        dout = dout.float().contiguous()
        dsum = (dout * out).sum(dim=-1)  # D of the flash backward
        dq, dk, dv, dtable, dwy, df = _site_bwd_kernel.fused_site_bwd_cuda(
            *args[:7], Xp, *args[7:], dout, lse, dsum, H, W, scale)
        return (dq.to(qd), dk.to(kd), dv.to(vd), dtable.to(td), dwy,
                df) + (None,) * 9


def lattice_bias(table, k_pos, H: int, W: int,
                 kernel: str | None = None) -> torch.Tensor:
    """n-major rpe bias (B, G, Hpg, N, H*W): for CUDA tensors the CUDA
    kernel ``kernel`` (by default the one of the site's ``bias_route``; bf16
    out), with the backward kernel of its route as the backward; the plain
    version (bf16 lerps, float32 out, autograd) for CPU."""
    if not table.is_cuda:
        return lattice_bias_plain(table, k_pos, H, W)
    if kernel is None:
        kernel = ("lattice_bias" if bias_route(table.shape, H, W) == "whole"
                  else "lattice_bias_wide")
    ys, ms, wy, f, u0, g, Xp = _geometry_args(table, k_pos, H, W)
    return _LatticeBiasFn.apply(table, wy, f, ys, ms, u0, g, Xp, H, W, kernel)


class _LatticeWindowsFn(torch.autograd.Function):
    """``lattice_windows`` kernel forward, ``lattice_windows_bwd`` kernel
    backward (the custom VJP ``lattice_windows``, lattice_win.py:100); their
    plain versions for CPU tensors. Differentiable input: t3; the dt3 it
    returns is in t3's dtype, as the JAX backward casts it (:137)."""

    @staticmethod
    def forward(ctx, t3, ys, ms, h1):
        ctx.save_for_backward(ys, ms)
        ctx.meta = (tuple(t3.shape), t3.dtype)
        if t3.is_cuda:
            return _win_kernel.lattice_windows_cuda(t3.contiguous(), ys, ms, h1)
        return _win_kernel.lattice_windows_plain(t3, ys, ms, h1)

    @staticmethod
    def backward(ctx, gout):
        ys, ms = ctx.saved_tensors
        shape, dtype = ctx.meta
        if gout.is_cuda:
            dt3 = _win_kernel.lattice_windows_bwd_cuda(gout.contiguous(), ys,
                                                       ms, shape, dtype)
        else:
            dt3 = _win_kernel.lattice_windows_bwd_plain(gout, ys, ms, shape,
                                                        dtype)
        return dt3, None, None, None


def lattice_windows(t3, ys, ms, h1: int) -> torch.Tensor:
    """Each key's window of ``t3`` (B, G, N, 3, h1, WH), differentiable in
    t3: the CUDA kernels for CUDA tensors, their plain versions for CPU
    ones (``_LatticeWindowsFn``)."""
    return _LatticeWindowsFn.apply(t3, ys, ms, h1)


def lattice_bias_windowed(table, k_pos, H: int, W: int) -> torch.Tensor:
    """The JAX package's ``_lattice_bias(use_kernel=True)``
    (deform_attn.py:79-190): the bf16 table rearranged into ``lattice_t3``
    by plain ops, each key's window cut by ``lattice_windows`` (the
    ``lattice_windows`` kernel and its scatter-add backward on the card),
    and the corners mixed in bf16 by ``lattice_mix``. Returns the n-major
    bias (B, G, Hpg, N, H*W) in float32; gradients reach ``table`` and
    ``k_pos``. The windows are exact copies, so this equals
    ``lattice_bias_plain(table, k_pos, H, W)`` bit for bit; the bias
    kernels, which lerp in float32, differ from it by the bf16 lerps'
    roundings."""
    ys, ms, wy, f = lattice_geometry(table.shape, k_pos, H, W)
    _, g = _comb_tensors(table.shape[3], W, table.device)
    win = lattice_windows(lattice_t3(table, W, torch.bfloat16),
                          ys.contiguous(), ms.contiguous(), H + 1)
    return lattice_mix(win, wy, f, g, H, W, torch.bfloat16)


def fused_site(q, k, v, k_pos, table, H: int, W: int, scale: float,
               kernel: str | None = None) -> torch.Tensor:
    """Whole attention site (B, G, Hpg, M, ch) float32, no gradient: for
    CUDA tensors the fused CUDA kernel ``kernel`` ("fused_site",
    "fused_site_wide", "fused_site_wide_prefetch", "fused_site_fold_rows" or
    "fused_site_fold_heads"; by default as ``site_kernels`` chooses in
    eval), the plain version for CPU. The site that trains is
    ``fused_site_train``."""
    if not q.is_cuda:
        return site_plain(q, k, v, k_pos, table, H, W, scale)
    for t in (q, k, v, k_pos, table):
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "the fused site kernel is forward-only; run under "
                "torch.no_grad(), or take fused_site_train"
            )
    if kernel is None:
        kernel = site_kernels(q.shape, table.shape, H, W, SiteOptions(),
                              training=False)[0]
    bf = torch.bfloat16
    *geo, Xp = _kernel_args(table, k_pos, H, W)
    qkv = tuple(t.detach().to(bf).contiguous() for t in (q, k, v))
    with_xp = {"fused_site": _fused_site_kernel.fused_site_cuda,
               "fused_site_fold_rows": _fold_kernel.fused_site_fold_rows_cuda}
    if kernel in with_xp:
        return with_xp[kernel](*geo, Xp, *qkv, H, W, float(scale))
    launch = {"fused_site_wide": _wide_site_kernel.fused_site_wide_cuda,
              "fused_site_wide_prefetch":
                  _wide_site_kernel.fused_site_wide_prefetch_cuda,
              "fused_site_fold_heads":
                  _fold_kernel.fused_site_fold_heads_cuda}.get(kernel)
    if launch is None:
        raise ValueError(f"no fused site kernel {kernel!r}")
    return launch(*geo, *qkv, H, W, float(scale))


def fused_site_train(q, k, v, k_pos, table, H: int, W: int, scale: float,
                     kernel: str | None = None) -> torch.Tensor:
    """The fused site with a fused backward (``fused_site_attention_train``,
    deform_attn.py:689-807): on CUDA tensors the ``kernel`` forward
    ("fused_site_lse", "fused_site_wide_lse" or "fused_site_fold_heads_lse";
    by default as ``site_kernels`` chooses under ``fused_bwd``) and the
    ``fused_site_bwd`` kernel backward, with the chain from dwy, df to
    ``k_pos`` left to autograd; on CPU tensors the plain version with
    autograd."""
    if not q.is_cuda:
        return site_plain(q, k, v, k_pos, table, H, W, scale)
    if kernel is None:
        kernel = site_kernels(q.shape, table.shape, H, W,
                              SiteOptions(fused_bwd=True), training=True)[0]
    ys, ms, wy, f, u0, g, Xp = _geometry_args(table, k_pos, H, W)
    return _FusedSiteTrainFn.apply(q, k, v, table, wy, f, ys, ms, u0, g, Xp,
                                   H, W, float(scale), kernel)


# the operations a matrix product on the plain consumer reaches once
# ``torch.matmul`` has decomposed (a trace of ``site_consumer`` and
# ``_dense_chunk``: expand, view, bmm, _unsafe_view; mm for 2-d operands)
_DOT_OPS = (torch.ops.aten.bmm.default, torch.ops.aten.mm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def _maybe_remat(fn, site_remat: str, *tensors):
    """Run ``fn(*tensors)`` under ``site_remat`` when there is a gradient to
    take (``_site_remat``, deform_attn.py:810-834): "nothing" saves only
    the inputs and recomputes the rest in the backward
    (``jax.checkpoint(nothing_saveable)``); "dots" also saves the outputs
    of the matrix products (``_DOT_OPS``: the scores and AV of the plain
    consumer) and recomputes the elementwise tail and the bias, whose
    autograd Function is no product (``jax.checkpoint(dots_saveable)``);
    "none" lets autograd keep what it wants. The recompute draws nothing
    at random: a dropout mask is drawn outside (``_keep_mask``)."""
    if site_remat not in SITE_REMAT_MODES:
        raise ValueError(f"site_remat must be one of {SITE_REMAT_MODES}, "
                         f"got {site_remat!r}")
    if (site_remat != "none" and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        kw = {"context_fn": _dots_contexts} if site_remat == "dots" else {}
        return checkpoint(fn, *tensors, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return fn(*tensors)


def _keep_mask(shape, rate: float, generator, device,
               rows_per_sample: int = 1):
    """Dropout mask drawn outside any recomputed region, so a backward that
    recomputes sees the same mask; with a process group of W > 1, this
    rank's rows of the global batch's mask (``parallel.dist.local_rand``)."""
    return pdist.local_rand(shape, generator, device,
                            rows_per_sample) < 1.0 - rate


def streamed_deform_attention(q, k, v, k_pos, rpe_table, H: int, W: int, *,
                              scale: float, fuse_site: bool,
                              fused_bwd: bool = False,
                              site_remat: str = "nothing",
                              lattice_route: str = "auto",
                              site_prefetch: bool = False,
                              bias_forward: str = "kernel",
                              site_fold_heads: bool = False,
                              site_fold_rows: bool = False,
                              fused_fwd_fold: bool | None = None,
                              dropout_rate: float = 0.0,
                              generator=None,
                              rows_per_sample: int = 1) -> torch.Tensor:
    """One lattice attention site (deform_attn.py:866-917), on the kernels
    that ``site_kernels`` names for the ``SiteOptions`` of the keyword
    arguments from ``fused_bwd`` to ``fused_fwd_fold``; ``fuse_site`` says
    that the pass is an eval one (no gradient).

    The fused site (eval) and the fused training site are built for head
    widths 4 and 8; a site of another head width takes the bias route, as
    wider heads do. A site that takes the bias computes it alone (with the
    bias kernels, or the windowed bias under ``bias_forward="windows"``)
    and the plain consumer does the rest, under ``site_remat``: "nothing"
    saves the site's inputs only and recomputes bias, scores and softmax
    in the backward, "dots" also saves the scores and AV products and
    recomputes the bias and the elementwise tail, "none" lets autograd
    keep what it wants (``_maybe_remat``). Attention dropout
    (``dropout_rate`` > 0, drawn from ``generator``) always takes the plain
    consumer; ``rows_per_sample`` is the number of leading rows of q, k and
    v that one sample of the batch holds (its views, where they are folded
    into the batch), for the mask of a data-parallel rank."""
    use_dropout = dropout_rate > 0.0
    options = SiteOptions(
        fused_bwd=fused_bwd, site_remat=site_remat, lattice_route=lattice_route,
        site_prefetch=site_prefetch, bias_forward=bias_forward,
        site_fold_heads=site_fold_heads, site_fold_rows=site_fold_rows,
        fused_fwd_fold=fused_fwd_fold)
    kernel = site_kernels(q.shape, rpe_table.shape, H, W, options,
                          training=not fuse_site, dropout=use_dropout)[0]
    if kernel.endswith("_lse"):
        return fused_site_train(q, k, v, k_pos, rpe_table, H, W, scale, kernel)
    if kernel.startswith("fused_site"):
        return fused_site(q, k, v, k_pos, rpe_table, H, W, scale, kernel)
    keep = None
    if use_dropout:
        keep = _keep_mask(k.shape[:-1] + (q.shape[-2],), dropout_rate,
                          generator, q.device, rows_per_sample)

    def full_site(q, k, v, k_pos, table):
        if kernel == "lattice_windows":
            bias = lattice_bias_windowed(table, k_pos, H, W)
        else:
            bias = lattice_bias(table, k_pos, H, W, kernel)
        return site_consumer(q, k, v, bias, scale, keep, dropout_rate)

    return _maybe_remat(full_site, site_remat, q, k, v, k_pos, rpe_table)


def bilinear_table_lookup(table, disp) -> torch.Tensor:
    """Bilinear read of the rpe table (G, Hpg, Ht, Wt) at displacements
    ``disp`` (B, G, m, N, 2), (y, x) in [-1, 1], zeros outside, as
    ``F.grid_sample(align_corners=True)`` (``_bilinear_table_lookup``,
    deform_attn.py:43). Returns (B, G, Hpg, m, N)."""
    G, Hpg, Ht, Wt = table.shape
    rows = table.permute(0, 2, 3, 1).reshape(G * Ht * Wt, Hpg)
    gbase = (torch.arange(G, device=table.device) * (Ht * Wt)).view(1, G, 1, 1)
    py = (disp[..., 0] + 1.0) * 0.5 * (Ht - 1)
    px = (disp[..., 1] + 1.0) * 0.5 * (Wt - 1)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy1 = py - y0
    wx1 = px - x0

    def corner(yc, xc, w):
        inb = (yc >= 0.0) & (yc <= Ht - 1.0) & (xc >= 0.0) & (xc <= Wt - 1.0)
        yi = torch.clamp(yc, 0.0, Ht - 1.0).long()
        xi = torch.clamp(xc, 0.0, Wt - 1.0).long()
        vals = rows[gbase + yi * Wt + xi]  # (B, G, m, N, Hpg)
        return vals * torch.where(inb, w, torch.zeros_like(w))[..., None]

    out = (corner(y0, x0, (1 - wy1) * (1 - wx1))
           + corner(y0, x0 + 1.0, (1 - wy1) * wx1)
           + corner(y0 + 1.0, x0, wy1 * (1 - wx1))
           + corner(y0 + 1.0, x0 + 1.0, wy1 * wx1))
    return out.permute(0, 1, 4, 2, 3)


def _dense_chunk(qc, qpos_c, k, v, k_pos, table, scale):
    s = torch.matmul(qc, k.transpose(-1, -2)) * scale  # (B, G, Hpg, m, N)
    disp = (qpos_c[None, None, :, None, :] - k_pos[:, :, None, :, :]) * 0.5
    p = torch.softmax(s + bilinear_table_lookup(table, disp), dim=-1)
    return torch.matmul(p, v)


def chunked_deform_attention(q, k, v, q_pos, k_pos, rpe_table, *,
                             scale: float, chunk: int = 512,
                             site_remat: str = "nothing") -> torch.Tensor:
    """The non-lattice branch of the JAX package's
    ``streamed_deform_attention`` (deform_attn.py:918-965), without its
    dropout: any query positions ``q_pos`` (M, 2), the bias by
    ``bilinear_table_lookup``, the queries in chunks of ``chunk`` so that
    scores exist for one chunk at a time (each chunk under ``site_remat``).
    Plain PyTorch; the oracle of the lattice path's gradient tests."""
    M = q.shape[-2]
    outs = []
    for m0 in range(0, M, min(chunk, M)):
        def one_chunk(qc, k, v, k_pos, table, qpos_c=q_pos[m0:m0 + chunk]):
            return _dense_chunk(qc, qpos_c, k, v, k_pos, table, scale)

        outs.append(_maybe_remat(one_chunk, site_remat,
                                 q[..., m0:m0 + chunk, :], k, v, k_pos,
                                 rpe_table))
    return torch.cat(outs, dim=-2)


def dense_deform_attention_reference(q, k, v, q_pos, k_pos, rpe_table, *,
                                     scale: float) -> torch.Tensor:
    """Unchunked reference (deform_attn.py:968): the whole (M, N) scores and
    bias at once."""
    return _dense_chunk(q, q_pos, k, v, k_pos, rpe_table, scale)
