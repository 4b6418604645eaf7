"""Wrappers of the bias backward kernels: ``lattice_bias_bwd`` (csrc/
lattice_bias_bwd.cu), the counterpart of bevrender_tpu/ops/pallas/
lattice_bias.py::_bwd_call_sh, and ``lattice_bias_wide_bwd`` (csrc/
lattice_bias_wide_bwd.cu), the counterpart of ``_bwd_call`` there, at the
sites whose bias forward takes the wide kernel (``ops.deform_attn.
bias_route``). Both are instances of one row-owned template with no float
atomic (csrc/bias_bwd_rows.cuh), launched by ``plan``: a block owns one
(b, g, h), a run of keys and a band of rows of the padded table, each warp
some of the band's rows. Their plain version is autograd through
``ops.deform_attn.lattice_bias_plain``; ``lattice_bias_bwd_ordered`` repeats
their order of float32 sums in PyTorch."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from bevrender_tpu_torch.ops.kernels._launch import (
    PAD,
    SMEM_PER_BLOCK,
    SMEM_PER_BLOCK_RESERVED,
    SMEM_PER_SM,
    call,
    check_geometry,
    window_width,
)

# kernel launches since the last reset (ops.kernels.reset_counts)
launches = 0  # lattice_bias_bwd
launches_wide = 0  # lattice_bias_wide_bwd

# csrc/bias_bwd_rows.cuh: warps a block, keys a chunk of the dwy/df partials
WARPS = 8
KEYS_A_CHUNK = 16
# bands of fewer rows than this (where the padded table has more) cost more
# key visits and gout re-reads than a fourth or third block an SM gains
MIN_BAND_ROWS = 16


class Plan(NamedTuple):
    """How one launch cuts the work (``plan``)."""

    rows: int    # padded rows a band (the last band may hold fewer)
    bands: int   # bands over the padded height
    runs: int    # key runs, each of ``keys`` keys (the last may hold fewer)
    keys: int
    pitch: int   # row pitch of the band's gradient and table in shared memory
    smem: int    # shared memory a block, bytes
    per_sm: int  # blocks an SM the plan sized the bands for


def pitch(Wt: int) -> int:
    """Columns of the zero-padded table a window can reach: starts are
    clipped to ms <= m_max - 3, u0 <= (Wt - 1) // 2 and a pair reads c and
    c + 1 with c = ms + u0 + 1 at most."""
    return window_width(Wt) + (Wt - 1) // 2


def _crossing_thresholds(g: np.ndarray) -> np.ndarray:
    """Per column fraction g (float32), the least float32 f in [0, 1] at
    which fl(g + f) >= 1, the kernels' crossing: bisection over the float32
    bit patterns, on which fl(g + f) is monotone."""
    lo = np.zeros(g.shape, np.int64)
    hi = np.full(g.shape, np.float32(1.0).view(np.int32), np.int64)
    while (hi - lo > 1).any():
        mid = (lo + hi) // 2
        up = (g + mid.astype(np.int32).view(np.float32)) >= np.float32(1.0)
        hi, lo = np.where(up, mid, hi), np.where(up, lo, mid)
    return hi.astype(np.int32).view(np.float32)


def columns_increase_for(u0: np.ndarray, g: np.ndarray) -> bool:
    """Whether the columns c(ix) = u0[ix] + (floor(fl(g[ix] + f)) > 0.5)
    strictly increase in ix for every float32 f in [0, 1), as the kernels
    compute them (lattice_common.cuh::column). c changes only where some
    lane's sum crosses 1, so f = 0 and each crossing and the float32 just
    below it cover every case."""
    g = np.asarray(g, np.float32)
    th = _crossing_thresholds(g)
    fs = np.concatenate([[np.float32(0.0)], th, np.nextafter(th, np.float32(0))])
    fs = fs[(fs >= 0) & (fs < 1)].astype(np.float32)
    phi = g[None, :] + fs[:, None]
    c = np.asarray(u0, np.int64)[None, :] + (np.floor(phi) > 0.5)
    return bool((c[:, 1:] > c[:, :-1]).all())


@functools.lru_cache(maxsize=None)
def columns_increase(Wt: int, W: int) -> bool:
    """``columns_increase_for`` the comb of a table of width Wt at W query
    columns (``ops.deform_attn.static_comb``)."""
    from bevrender_tpu_torch.ops.deform_attn import static_comb

    u0, g, _ = static_comb((1, 1, 1, Wt), W)
    return columns_increase_for(u0, g)


def smem_bytes(rows: int, pitch: int) -> int:
    """bias_bwd_rows.cuh::smem_bytes: a band's float32 gradient, two chunks'
    dwy/df partials and three chunks' key geometry, and the band's table
    rows in bf16."""
    return (rows * pitch * 4 + 2 * KEYS_A_CHUNK * WARPS * 2 * 4
            + 3 * KEYS_A_CHUNK * 3 * 4 + rows * pitch * 2)


def plan(B: int, G: int, Hpg: int, Ht: int, Wt: int, N: int, H: int, W: int,
         sms: int) -> Plan:
    """The launch of both kernels, from the shapes and the card's SM count
    ``sms``: the most blocks an SM (4, 3, 2, then 1) at which a band of
    MIN_BAND_ROWS rows (or the whole padded table, where it is shorter) fits
    in shared memory; bands of equal rows, as many rows as fit; then key runs
    for about one wave of blocks (B G Hpg bands runs <= per_sm sms), no more
    runs than chunks of keys. Raises ValueError for a shape no plan fits:
    W over 64 (two columns a lane), a table whose step (Wt - 1) / (2 (W
    - 1)) is under 1 or whose columns float32 rounding could merge
    (``columns_increase``; none is known at a step of 1 or more), a padded
    table of 2^15 rows or columns or more, or 2^31 cotangents a head."""
    if not 1 <= W <= 64:
        raise ValueError(f"lattice bias backward: W = {W} query columns, the "
                         f"kernels take 1 to 64")
    if W > 1 and Wt < 2 * W - 1:
        raise ValueError(f"lattice bias backward: table width {Wt} at W = {W} "
                         f"gives a column step (Wt - 1) / (2 (W - 1)) under 1")
    if not columns_increase(Wt, W):
        raise ValueError(f"lattice bias backward: at table width {Wt} and W = "
                         f"{W} two query columns can read one table column")
    Yp, X = Ht + 2 * PAD, pitch(Wt)
    if max(Yp, X) >= 2 ** 15:  # starts ys, ms share one word in the kernel
        raise ValueError(f"lattice bias backward: a padded table of {Yp} x "
                         f"{X}, over 2^15 rows or columns")
    if N * H * W >= 2 ** 31:  # a head's cotangents take 32-bit offsets
        raise ValueError(f"lattice bias backward: {N} keys of {H * W} "
                         f"queries a head, over 2^31")
    for per_sm in (4, 3, 2, 1):
        budget = min(SMEM_PER_BLOCK,
                     SMEM_PER_SM // per_sm - SMEM_PER_BLOCK_RESERVED)
        rows = (budget - smem_bytes(0, X)) // (6 * X)
        if rows >= min(Yp, MIN_BAND_ROWS) or per_sm == 1:
            break  # under 2^15 columns, one block holds a few rows
    bands = -(-Yp // rows)
    rows = -(-Yp // bands)
    units = B * G * Hpg * bands
    runs = max(1, min(-(-N // KEYS_A_CHUNK), per_sm * sms // units))
    keys = -(-N // runs)
    return Plan(rows, bands, -(-N // keys), keys, X, smem_bytes(rows, X),
                per_sm)


def _launch(lib: str, fn: str, table, ys, ms, wy, f, u0, g, gout, H: int,
            W: int):
    check_geometry(fn, table, ys, ms, wy, f, u0, g, H, W, gout)
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    dev = table.device
    p = plan(B, G, Hpg, Ht, Wt, N, H, W,
             torch.cuda.get_device_properties(dev).multi_processor_count)
    f32 = torch.float32
    part_t = torch.empty(B * p.runs * G * Hpg * Ht * Wt, dtype=f32, device=dev)
    part_k = torch.empty(p.bands * B * G * Hpg * N * 2, dtype=f32, device=dev)
    dtable = torch.empty(table.shape, dtype=f32, device=dev)
    dwy = torch.empty((B, G, N), dtype=f32, device=dev)
    df = torch.empty((B, G, N), dtype=f32, device=dev)
    call(lib, f"{lib}_launch",
         (table, ys, ms, wy, f, u0, g, gout, part_t, part_k, dtable, dwy, df,
          B, G, Hpg, Ht, Wt, p.pitch, N, H, W, p.rows, p.bands, p.runs,
          p.keys))
    return dtable, dwy, df


def lattice_bias_bwd_cuda(table, ys, ms, wy, f, u0, g, Xp: int, gout, H: int,
                          W: int):
    """table and geometry as ``lattice_bias_cuda``; gout (B, G, Hpg, N, H*W)
    bf16, the cotangent of its output -> (dtable (G, Hpg, 2H-1, Wt), dwy
    (B, G, N), df (B, G, N)), all float32, the same bits on every run:
    dtable those of ``lattice_bias_bwd_ordered``. ``Xp``, the forward's
    padded width, is not read: the kernel's row pitch is ``pitch``. Two
    launches (the rows kernel and the sum of its partials), counted once."""
    global launches
    out = _launch("lattice_bias_bwd", "lattice_bias_bwd_cuda", table, ys, ms,
                  wy, f, u0, g, gout, H, W)
    launches += 1
    return out


def lattice_bias_wide_bwd_cuda(table, ys, ms, wy, f, u0, g, Xp: int, gout,
                               H: int, W: int):
    """``lattice_bias_bwd_cuda`` at the sites of the wide bias forward: the
    same template and plan, counted on its own."""
    global launches_wide
    out = _launch("lattice_bias_wide_bwd", "lattice_bias_wide_bwd_cuda", table,
                  ys, ms, wy, f, u0, g, gout, H, W)
    launches_wide += 1
    return out


def lattice_bias_bwd_ordered(table, ys, ms, wy, f, u0, g, Xp: int, gout,
                             H: int, W: int, plan: Plan):
    """The kernels step by step in PyTorch, a test oracle for their order of
    float32 sums: dtable equal to theirs bit for bit under the same ``plan``,
    dwy and df the plain sums. Arguments as ``lattice_bias_bwd_cuda``, on
    any device; ``Xp`` is not read.

    Each (b, run) keeps a float32 padded gradient that starts at 0.0. For
    each key of the run in order, it adds the pair terms of every query row
    in four passes: the upper pair's left terms d0 (1 - wx) at (ys + iy, c),
    its right terms d0 wx at (ys + iy, c + 1), then the lower pair's left
    and right terms d1 (1 - wx), d1 wx at row ys + iy + 1 (d0 = go (1 - wy),
    d1 = go wy), every product and sum rounded on its own. The plan's
    columns strictly increase (``columns_increase``), so within a pass no
    two terms share an entry and each pass is one dense add; the kernels add
    each entry's terms in this order (csrc/bias_bwd_rows.cuh). dtable is
    then the interior of those gradients summed over b, then run."""
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    dev = table.device
    f32 = torch.float32
    Yp, X = Ht + 2 * PAD, plan.pitch
    runs, keys = plan.runs, plan.keys
    gf = g.to(dev, f32)
    phi = gf + f[..., None]  # (B, G, N, W)
    cross = torch.floor(phi)
    wx = phi - cross
    ux = 1.0 - wx
    col = ms.long()[..., None] + u0.to(dev).long() + (cross > 0.5).long()
    go = gout.float().view(B, G, Hpg, N, H, W)
    om = 1.0 - wy

    acc = torch.zeros(B * runs * G * Hpg * Yp * X, dtype=f32, device=dev)
    # flat offset of row 0 of each (b, run, g, h), as (B, runs, G, Hpg, 1, 1)
    base = torch.arange(B * runs * G * Hpg, device=dev).view(
        B, runs, G, Hpg, 1, 1) * (Yp * X)
    iy = torch.arange(H, device=dev).view(H, 1)

    def per_run(t, n):  # (B, G, N, ...) -> (B, runs, G, ...) at keys n
        return t[:, :, n].transpose(1, 2)

    for k in range(keys):
        n = torch.arange(runs, device=dev) * keys + k
        live = (n < N).view(1, runs, 1, 1, 1, 1)
        n = n.clamp(max=N - 1)
        y0 = per_run(ys.long(), n)[:, :, :, None, None, None]
        c = per_run(col, n)[:, :, :, None, None, :]  # (B, runs, G, 1, 1, W)
        u, w = (per_run(t, n)[:, :, :, None, None, :] for t in (ux, wx))
        gk = go[:, :, :, n].permute(0, 3, 1, 2, 4, 5) * live
        d0 = gk * per_run(om, n)[:, :, :, None, None, None]
        d1 = gk * per_run(wy, n)[:, :, :, None, None, None]
        row = base + (y0 + iy) * X  # upper row of each query row
        for term, down, right in ((d0 * u, 0, 0), (d0 * w, 0, 1),
                                  (d1 * u, 1, 0), (d1 * w, 1, 1)):
            acc.index_add_(0, (row + down * X + c + right).reshape(-1),
                           term.reshape(-1))
    acc = acc.view(B, runs, G, Hpg, Yp, X)
    dtable = torch.zeros((G, Hpg, Ht, Wt), dtype=f32, device=dev)
    for b in range(B):
        for r in range(runs):
            dtable = dtable + acc[b, r, :, :, PAD:PAD + Ht, PAD:PAD + Wt]

    # dwy, df: the four entries of each pair, as the forward reads them
    tp = torch.nn.functional.pad(table.float(),
                                 (PAD, X - Wt - PAD, PAD, PAD)).reshape(-1)
    head = torch.arange(G * Hpg, device=dev).view(1, G, Hpg, 1, 1, 1) * (Yp * X)
    i00 = head + (ys.long()[:, :, None, :, None, None] + iy[None, None, None]
                  ) * X + col[:, :, None, :, None, :]
    t00, t01, t10, t11 = (tp[i00 + o] for o in (0, 1, X, X + 1))
    u6, w6 = ux[:, :, None, :, None, :], wx[:, :, None, :, None, :]
    wy6 = wy[:, :, None, :, None, None]
    xa = u6 * t00 + w6 * t01
    xb = u6 * t10 + w6 * t11
    dwy = (go * (xb - xa)).sum((2, 4, 5))
    df = (go * (1.0 - wy6) * (t01 - t00) + go * wy6 * (t11 - t10)).sum(
        (2, 4, 5))
    return dtable, dwy, df
