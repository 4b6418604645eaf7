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
    t3 (``t3_shape``) in ``dtype``: bf16, cast from the float32 sums, or
    float32, the sums themselves. They run through float atomics: their
    last bits vary from run to run."""
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
    acc = torch.empty(tuple(t3_shape), dtype=torch.float32, device=dev)
    cast = dtype == torch.bfloat16
    out = torch.empty(tuple(t3_shape), dtype=dtype, device=dev) if cast else acc
    call("lattice_windows", "lattice_windows_bwd_launch",
         (gout, ys, ms, acc, out, B * G * N, G, N, Y, m_max, h1, WH, int(cast)))
    launches_bwd += 1
    return out
