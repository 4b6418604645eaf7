"""Wrappers of the window-extraction kernels (csrc/lattice_windows.cu) and
their plain versions: ``lattice_windows_cuda``, the counterpart of
bevrender_tpu/ops/pallas/lattice_win.py::_lattice_windows_fwd_impl, and
``lattice_windows_bwd_cuda``, the counterpart of ``_lattice_windows_bwd``
there. Together they are the windows of the windowed bias
(``ops.deform_attn.lattice_bias_windowed``,
``ModelConfig.bias_forward="windows"``).

A window is what one key reads of the column-rearranged table t3 (G, Y,
m_max, WH) (``ops.deform_attn.lattice_t3``): rows ys .. ys + h1 - 1 of the
columns ms .. ms + 2, laid out m-major as the Pallas kernel writes it,
(B, G, N, 3, h1, WH). The starts must be clipped into t3
(``ops.deform_attn.lattice_geometry`` clips them); the kernels read
unchecked."""

from __future__ import annotations

import torch

from bevrender_tpu_torch.ops.kernels._launch import call, check

# kernel launches since the last reset (ops.kernels.reset_counts)
launches = 0  # lattice_windows
launches_bwd = 0  # lattice_windows_bwd

# The backward's bucketing blocks (csrc/lattice_windows.cu): one warp
# counter a bin for each of 32 warps, at a stride of 33 ints, in at most
# BUCKET_TABLE_BYTES of shared memory (BUCKET_TABLE_BYTES there)
BUCKET_WARP_STRIDE = 33
BUCKET_TABLE_BYTES = 45 * 1024


def window_rows(ys, ms, h1: int, Y: int, m_max: int) -> torch.Tensor:
    """Index (B, G, N, 3, h1), int64, of each window row in t3 viewed as
    (G * Y * m_max, WH) rows, m-major."""
    dev = ys.device
    G = ys.shape[1]
    base = (torch.arange(G, device=dev).view(1, G, 1) * Y + ys.long()) * m_max
    base = base + ms.long()
    y = torch.arange(h1, device=dev) * m_max
    m = torch.arange(3, device=dev)[:, None]
    return base[..., None, None] + y + m


def lattice_windows_plain(t3, ys, ms, h1: int) -> torch.Tensor:
    """Plain version of ``lattice_windows_cuda``: advanced indexing, with
    autograd."""
    G, Y, m_max, WH = t3.shape
    return t3.reshape(G * Y * m_max, WH)[window_rows(ys, ms, h1, Y, m_max)]


def lattice_windows_bwd_plain(gout, ys, ms, t3_shape, dtype) -> torch.Tensor:
    """Plain version of ``lattice_windows_bwd_cuda``: each window's
    cotangent added into a float32 t3 gradient in the order of the keys,
    then cast to ``dtype``."""
    G, Y, m_max, WH = t3_shape
    rows = window_rows(ys, ms, gout.shape[4], Y, m_max).reshape(-1)
    acc = torch.zeros((G * Y * m_max, WH), dtype=torch.float32,
                      device=gout.device)
    acc.index_put_((rows,), gout.reshape(-1, WH).float(), accumulate=True)
    return acc.view(t3_shape).to(dtype)


def window_buckets(ys, ms, t3_shape, h1: int):
    """The bucketing of ``lattice_windows_bwd_cuda`` in plain PyTorch: the
    keys, ``(b * G + g) * N + n``, sorted stably by their bin ``(g * (m_max
    - 2) + ms) * ny + ys`` (ny = Y - h1 + 1 starts a column), so that the
    keys of one bin keep their order. Returns (keys (B * G * N,) int64 in
    that order, offsets (G * (m_max - 2) * ny + 1,) int64: the keys of bin
    i are ``keys[offsets[i]:offsets[i + 1]]``)."""
    G, Y, m_max, _ = t3_shape
    ny = Y - h1 + 1
    g = torch.arange(G, device=ys.device).view(1, G, 1)
    bins = ((g * (m_max - 2) + ms.long()) * ny + ys.long()).reshape(-1)
    counts = torch.bincount(bins, minlength=G * (m_max - 2) * ny)
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                          device=ys.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return torch.sort(bins, stable=True).indices, offsets


def lattice_windows_bwd_ordered(gout, ys, ms, t3_shape,
                                dtype) -> torch.Tensor:
    """``lattice_windows_bwd_cuda`` step by step in PyTorch, a test oracle
    that sums in the kernel's order: each row (g, y, m) of the t3 gradient
    starts at 0.0 and adds, for mm = 0, 1, 2, the cotangent row (mm, y -
    ys) of every key with ms = m - mm and ys in [y - h1 + 1, y], one at a
    time in float32, in the order of ``window_buckets``; then it is cast
    to ``dtype``. Equal to the kernel bit for bit; one loop step a
    position of the longest row's list."""
    G, Y, m_max, WH = t3_shape
    h1 = gout.shape[4]
    dev = gout.device
    nm, ny = m_max - 2, Y - h1 + 1
    keys, offsets = window_buckets(ys, ms, t3_shape, h1)
    g = torch.arange(G, device=dev).view(G, 1, 1)
    y = torch.arange(Y, device=dev).view(1, Y, 1)
    m = torch.arange(m_max, device=dev).view(1, 1, m_max)
    ylo = (y - h1 + 1).clamp(min=0)
    yhi = y.clamp(max=ny - 1)
    first, count = [], []  # per mm, the row's range of sorted keys
    for mm in range(3):
        s = m - mm
        b = (g * nm + s.clamp(0, nm - 1)) * ny
        lo, hi = offsets[b + ylo], offsets[b + yhi + 1]
        first.append(lo)
        count.append(torch.where((s >= 0) & (s < nm), hi - lo, 0))
    end0, end1 = count[0], count[0] + count[1]
    total = end1 + count[2]
    ysk = ys.reshape(-1).long()
    rows = gout.reshape(-1, WH)
    acc = torch.zeros((G, Y, m_max, WH), dtype=torch.float32, device=dev)
    for k in range(int(total.max()) if total.numel() else 0):
        mm = (k >= end0).long() + (k >= end1).long()
        pos = torch.where(mm == 0, first[0] + k, torch.where(
            mm == 1, first[1] + k - end0, first[2] + k - end1))
        live = k < total
        key = keys[torch.where(live, pos, 0)]
        row = torch.where(live, (key * 3 + mm) * h1 + y - ysk[key], 0)
        # adding 0.0 leaves every sum as it is: none is ever -0.0
        acc += torch.where(live[..., None], rows[row].float(), 0.0)
    return acc.to(dtype)


def bucket_columns(Y: int, h1: int) -> int:
    """Columns of starts (ms) that one bucketing block of the backward
    takes: as many as its count table, BUCKET_WARP_STRIDE ints a bin of
    ny = Y - h1 + 1 starts a column, fits in BUCKET_TABLE_BYTES."""
    per_column = (Y - h1 + 1) * BUCKET_WARP_STRIDE * 4
    if per_column > BUCKET_TABLE_BYTES:
        raise ValueError(f"lattice_windows_bwd_cuda: {Y - h1 + 1} row starts "
                         f"a column, over the bucketing table")
    return BUCKET_TABLE_BYTES // per_column


def _check(fn: str, t3_shape, h1: int, ys, ms, dev, **tensors):
    """The checks both wrappers share: the starts (B, G, N) int32, windows
    of h1 x 3 inside t3, each tensor of ``tensors`` on a 16-byte boundary,
    and a CUDA device."""
    G, Y, m_max, _ = t3_shape
    if ys.dim() != 3 or ys.shape[1] != G:
        raise ValueError(f"{fn}: ys must be (B, {G}, N), got {tuple(ys.shape)}")
    check("ys", ys, torch.int32, ys.shape, dev)
    check("ms", ms, torch.int32, ys.shape, dev)
    if not (0 < h1 <= Y and m_max >= 3):
        raise ValueError(f"{fn}: windows of {h1} x 3 do not fit a table of "
                         f"{Y} x {m_max}")
    if ys.numel() >= 2 ** 31:
        raise ValueError(f"{fn}: {ys.numel()} keys, over one launch's grid")
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must start on a 16-byte boundary")
    if dev.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors")


def lattice_windows_cuda(t3, ys, ms, h1: int) -> torch.Tensor:
    """t3 (G, Y, m_max, WH) bf16; ys, ms (B, G, N) int32, clipped window
    starts (0 <= ys <= Y - h1, 0 <= ms <= m_max - 3) -> windows (B, G, N, 3,
    h1, WH) bf16, exact copies of t3's entries."""
    global launches
    if t3.dim() != 4:
        raise ValueError("lattice_windows_cuda: t3 must be (G, Y, m_max, WH)")
    G, Y, m_max, WH = t3.shape
    dev = t3.device
    check("t3", t3, torch.bfloat16, t3.shape, dev)
    _check("lattice_windows_cuda", t3.shape, h1, ys, ms, dev, t3=t3)
    B, _, N = ys.shape
    out = torch.empty((B, G, N, 3, h1, WH), dtype=torch.bfloat16, device=dev)
    call("lattice_windows", "lattice_windows_launch",
         (t3, ys, ms, out, B * G * N, G, N, Y, m_max, h1, WH))
    launches += 1
    return out


def lattice_windows_bwd_cuda(gout, ys, ms, t3_shape, dtype) -> torch.Tensor:
    """gout (B, G, N, 3, h1, WH) bf16, the cotangent of
    ``lattice_windows_cuda``'s output; ys, ms as there -> the gradient of
    t3 (``t3_shape``) in ``dtype``: float32, the sums themselves, or bf16,
    those sums rounded once. The keys are bucketed by start, then each row
    of the gradient gathered from its keys' rows in a fixed order, with no
    float atomic; so every run gives the same bits, those of
    ``lattice_windows_bwd_ordered``. Two launches (one where a group has at
    most 256 keys, which each block sorts itself), counted once."""
    global launches_bwd
    G, Y, m_max, WH = t3_shape
    dev = gout.device
    if gout.dim() != 6 or ys.dim() != 3:
        raise ValueError("lattice_windows_bwd_cuda: gout must be (B, G, N, 3, "
                         "h1, WH) and ys (B, G, N)")
    B, _, N = ys.shape
    h1 = gout.shape[4]
    check("gout", gout, torch.bfloat16, (B, G, N, 3, h1, WH), dev)
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"lattice_windows_bwd_cuda: dtype {dtype}, expected "
                        f"bfloat16 or float32")
    _check("lattice_windows_bwd_cuda", t3_shape, h1, ys, ms, dev, gout=gout)
    if B * G * N * 3 * h1 >= 2 ** 31:
        raise ValueError(f"lattice_windows_bwd_cuda: {B * G * N} keys of "
                         f"{3 * h1} rows, over 32-bit row indices")
    msb = bucket_columns(Y, h1)
    keys = torch.empty(B * G * N, dtype=torch.int32, device=dev)
    offsets = torch.empty(G * (m_max - 2) * (Y - h1 + 1) + 1,
                          dtype=torch.int32, device=dev)
    out = torch.empty(tuple(t3_shape), dtype=dtype, device=dev)
    call("lattice_windows", "lattice_windows_bwd_launch",
         (gout, ys, ms, keys, offsets, out, B, G, N, Y, m_max, h1, WH, msb,
          int(dtype == torch.bfloat16)))
    launches_bwd += 1
    return out
