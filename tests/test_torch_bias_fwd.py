"""The bias forwards' template on the CPU.

``lattice_bias.cu``, ``lattice_bias_wide.cu`` and
``lattice_bias_wide_prefetch.cu`` are instances of one row-walking template
(csrc/bias_fwd_rows.cuh) launched by ``lattice_bias.fwd_plan``; the card
tests hold all three, bit for bit, to the plain bias (float32 lerps on the
bf16 table) rounded to bf16. Here the plan is held to cover every output
exactly once at the shapes the models give it, on either path, and
``_rows_mirror``, the template's order (H + 1 x-lerped rows a key
and head, then the y-lerp) in PyTorch, against the plain bias, which must
keep that order for the bits to agree, and against the JAX package's Pallas
bias forwards (interpret mode, as its own tests run them). Inputs are made
with numpy from a seed.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_bias_fwd.py -q
"""

import collections
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevrender_tpu.ops import deform_attn as jda
from bevrender_tpu_torch.ops import deform_attn as tda
from bevrender_tpu_torch.ops.kernels import lattice_bias as lb
from bevrender_tpu_torch.ops.kernels import lattice_bias_bwd as lbb
from bevrender_tpu_torch.ops.kernels._launch import (
    PAD,
    SMEM_PER_BLOCK,
)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

H100_SMS = 132
# the mirror against the Pallas bias forward on float32 inputs: the same
# float32 lerps, with the key fractions computed by each framework's own
# float32 arithmetic (they differ in the last bit at some keys), as a share
# of the largest bias
PALLAS_F32_TOL = 2.0 ** -20


def _rows_mirror(table, ys, ms, wy, f, u0, g, H, W):
    """The template's order (csrc/bias_fwd_rows.cuh::rows): per key and head
    the H + 1 x-lerped rows ys .. ys + H of the zero-padded table at each
    query column's pair c, c + 1, then the y-lerp of each two neighbouring
    rows, every product and sum in float32 rounded on its own. Arguments as
    ``lattice_bias_wide_cuda`` -> (B, G, Hpg, N, H*W) float32."""
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    X = lbb.pitch(Wt)
    Yp = Ht + 2 * PAD
    tp = torch.nn.functional.pad(table.float(), (PAD, X - Wt - PAD, PAD, PAD))
    phi = g.float() + f[..., None]  # (B, G, N, W)
    cross = torch.floor(phi)
    wx = phi - cross
    ux = 1.0 - wx
    col = ms.long()[..., None] + u0.long() + (cross > 0.5).long()
    rows = ys.long()[..., None] + torch.arange(H + 1)
    # flat index of (g, h, row, c) for (B, G, Hpg, N, H + 1, W)
    head = torch.arange(G * Hpg).view(1, G, Hpg, 1, 1, 1) * (Yp * X)
    i0 = head + (rows[:, :, None, :, :, None] * X
                 + col[:, :, None, :, None, :])
    flat = tp.reshape(-1)
    x = (ux[:, :, None, :, None, :] * flat[i0]
         + wx[:, :, None, :, None, :] * flat[i0 + 1])  # the H + 1 rows
    wy6 = wy[:, :, None, :, None, None]
    out = (1.0 - wy6) * x[..., :H, :] + wy6 * x[..., 1:, :]
    return out.reshape(B, G, Hpg, N, H * W)


def _inputs(seed, B, G, Hpg, H, Wt, N, pos=1.3, table_std=0.5):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((G, Hpg, 2 * H - 1, Wt)) * table_std
    k_pos = rng.uniform(-pos, pos, (B, G, N, 2))
    return (torch.from_numpy(table.astype(np.float32)).bfloat16(),
            torch.from_numpy(k_pos.astype(np.float32)))


# ---- the plan ---------------------------------------------------------------

def _plan_parts(p, B, G, Hpg, N, H, W):
    """What a launch under plan ``p`` writes, by the kernel's own index
    arithmetic (bias_fwd_rows.cuh::rows), as three independent parts whose
    product is the output: the (head, key, strip) of every (block, warp
    task, segment) unit, the output rows of every strip, and the query
    columns of every (lane, column) that is live."""
    P, K = lb.lanes(W)
    seg = 32 // P
    units = collections.Counter()
    for blk in range(p.blocks):
        run, head = blk % p.runs, blk // p.runs
        n_units = min(B * N - run * p.keys, p.keys) * p.strips
        for task in range(-(-n_units // seg)):
            for s in range(seg):
                if task * seg + s < n_units:
                    kl, strip = divmod(task * seg + s, p.strips)
                    units[(head, run * p.keys + kl, strip)] += 1
    rows = {strip: range(strip * p.rows, min(H, (strip + 1) * p.rows))
            for strip in range(p.strips)}
    cols = collections.Counter(sl * K + j for sl in range(P)
                               for j in range(K) if sl * K + j < W)
    return units, rows, cols


# (B, G, Ht, Wt, N, H) of every bias forward the models launch: the
# flagship's serving (B = 4) and training (B = 2, SCA folded at B*V = 6
# where G >= 4) sites, the pyramid's (M = 196 and 49 at BEV 14 and 7), and
# a table whose padded head (119 x 1128 bf16) overflows a block
FWD_SHAPES = {
    **{f"serve_{n}": (B, G, 55, Wt, N, 28)
       for n, B, G, _, N, Wt, _ in chip_smoke.BIAS_SITES},
    **{f"train_{n}": (B, G, 55, Wt, N, 28)
       for n, B, G, _, N, Wt, _ in chip_smoke.TRAIN_BIAS_SITES},
    **{f"pyramid_{n}": (B, G, 2 * H - 1, Wt, N, H)
       for n, H, B, G, N, Wt in chip_smoke.PYR_BIAS_SITES},
    "overflow_bev56": (2, 1, 111, 1119, 200, 56),
}


def _check_covers(p, B, G, Hpg, Ht, Wt, N, H, W):
    """Every (b, g, h, n, iy, ix) output of a launch under plan ``p``
    exactly once, no empty run or strip, shared memory within a block, one
    wave; a staged table at the ``staged_pitch``, which holds every column
    a window reaches, in exactly ``table_bytes`` of shared memory."""
    units, rows, cols = _plan_parts(p, B, G, Hpg, N, H, W)
    assert units == collections.Counter(
        (head, k, strip) for head in range(G * Hpg) for k in range(B * N)
        for strip in range(p.strips))
    assert collections.Counter(iy for r in rows.values() for iy in r) == \
        collections.Counter(range(H))
    assert all(rows.values())
    assert cols == collections.Counter(range(W))
    assert p.blocks == G * Hpg * p.runs
    assert (p.runs - 1) * p.keys < B * N <= p.runs * p.keys
    assert (p.strips - 1) * p.rows < H <= p.strips * p.rows
    assert p.smem <= SMEM_PER_BLOCK
    assert p.blocks <= H100_SMS or p.runs == 1
    if p.path == "whole":
        u0, _, m_max = tda.static_comb((G, Hpg, Ht, Wt), W)
        assert p.pitch >= lbb.pitch(Wt) >= m_max - 3 + int(u0.max()) + 3
        assert p.pitch == lb.staged_pitch(Wt) and (p.pitch - Wt) % 8 == 0
        assert p.smem == lb.table_bytes(Ht, Wt)
        assert p.smem >= ((Ht + 2 * PAD) * p.pitch + 7) * 2
    else:
        assert (p.path, p.pitch, p.smem) == ("l1", 0, 0)


@pytest.mark.parametrize("kernel", lb.FWD_KERNELS)
@pytest.mark.parametrize("shape", list(FWD_SHAPES))
def test_fwd_plan_covers_every_output_once(shape, kernel):
    """Each kernel's plan covers every output exactly once
    (``_check_covers``) in blocks it has an instance of. The prefetch kernel
    stages one head's padded table at every shape a model gives it (its
    path "whole"), the wide kernel none, both in blocks of FWD_THREADS;
    ``lattice_bias`` stages where the table fits a block and its run of
    keys writes STAGE_OUTPUTS outputs or more an entry staged and
    STAGE_MIN_OUTPUTS in all. Every plan is ``fwd_layout``'s on its path,
    and a staged table's pitch puts its rows at their raw rows' 16-byte
    phase."""
    B, G, Ht, Wt, N, H = FWD_SHAPES[shape]
    Hpg, W = 2, H
    p = lb.fwd_plan(B, G, Hpg, Ht, Wt, N, H, W, H100_SMS, kernel)
    _check_covers(p, B, G, Hpg, Ht, Wt, N, H, W)
    Xs = lb.staged_pitch(Wt)
    staged = (Ht + 2 * PAD) * Xs
    fits = lb.table_bytes(Ht, Wt) <= SMEM_PER_BLOCK
    assert fits == (shape != "overflow_bev56")
    assert (Xs - Wt) % 8 == 0 and Xs >= PAD + Wt and p.pitch in (0, Xs)
    assert p == lb.fwd_layout(B, G, Hpg, Ht, Wt, N, H, W, H100_SMS, p.path)
    if kernel != "lattice_bias":
        assert p.path == ("whole" if fits and kernel.endswith("prefetch")
                          else "l1")
        return
    assert p.path == ("whole" if fits and p.keys * H * W >= max(
        lb.STAGE_OUTPUTS * staged, lb.STAGE_MIN_OUTPUTS) else "l1")


@pytest.mark.parametrize("path", ["l1", "whole"])
@pytest.mark.parametrize("shape", [s for s in FWD_SHAPES
                                   if s != "overflow_bev56"])
def test_fwd_layouts_cover_every_output_once(shape, path):
    """Both paths, at every shape a model gives the bias forwards
    (measurements launch the one ``lattice_bias``'s plan does not take,
    ``lattice_bias_cuda(..., path=...)``), cover every output exactly
    once."""
    B, G, Ht, Wt, N, H = FWD_SHAPES[shape]
    p = lb.fwd_layout(B, G, 2, Ht, Wt, N, H, H, H100_SMS, path)
    assert p.path == path
    _check_covers(p, B, G, 2, Ht, Wt, N, H, H)


def test_fwd_layout_refuses_an_overflowing_staged_table():
    """A staged head table over a block's shared memory is refused with
    its size; path "l1" takes it. A table of even width is staged as one of
    odd width is, and a path other than "whole" and "l1" is refused."""
    with pytest.raises(ValueError, match="overflows a block"):
        lb.fwd_layout(2, 1, 2, 111, 1119, 200, 56, 56, H100_SMS, "whole")
    assert lb.fwd_layout(2, 1, 2, 111, 1119, 200, 56, 56, H100_SMS,
                         "l1").smem == 0
    for kernel in ("lattice_bias", "lattice_bias_wide_prefetch"):
        p = lb.fwd_plan(2, 1, 2, 55, 278, 1960, 28, 28, H100_SMS, kernel)
        assert (p.path, p.pitch) == ("whole", 286)
    with pytest.raises(ValueError, match="no path"):
        lb.fwd_layout(2, 1, 2, 55, 279, 200, 28, 28, H100_SMS, "group")


def _stage_mirror(s, Ht, Wt, Xs):
    """What ``bias_fwd_rows.cuh::stage_raw`` writes, by its own index
    arithmetic, for a raw head table whose first entry lies ``s`` entries
    past a 16-byte boundary: {shared entry (from the 16-byte aligned base):
    raw entry (r, c), or None for a zero}, as a Counter of writes, and
    the (shared, raw) entry pairs of its 16-byte copies."""
    e = (s - PAD * (Xs + 1)) % 8
    writes, chunks = collections.Counter(), []
    for i in range(2 * PAD * Xs):
        writes[(e + (i if i < PAD * Xs else i + Ht * Xs), None)] += 1
    for r in range(Ht):
        d = e + (r + PAD) * Xs
        h = min(Wt, (8 - (s + r * Wt) % 8) % 8)
        q = (Wt - h) // 8
        for i in range(q):
            chunks.append((d + PAD + h + 8 * i, s + r * Wt + h + 8 * i))
            for k in range(8):
                writes[(d + PAD + h + 8 * i + k, (r, h + 8 * i + k))] += 1
        lead, skip = PAD + h, 8 * q
        assert Xs - skip <= 32  # the rest of a row, a lane an entry
        for j in range(Xs - skip):
            c = j if j < lead else j + skip
            writes[(d + c, (r, c - PAD) if PAD <= c < PAD + Wt
                    else None)] += 1
    return e, writes, chunks


@pytest.mark.parametrize("s", range(8))
@pytest.mark.parametrize("Ht,Wt", [(13, 13), (27, 27), (55, 279),
                                   (111, 559), (55, 278), (3, 3)])
def test_stage_raw_writes_the_padded_table_once(Ht, Wt, s):
    """``stage_raw`` at every 16-byte phase of the raw table: each entry of
    the zero-padded (Ht + 2 PAD, Xs) table written exactly once, with its
    raw entry or a zero, inside ``table_bytes``; every 16-byte copy aligned
    to 16 bytes on both sides; a row's other entries no more than a warp's
    lanes."""
    Xs = lb.staged_pitch(Wt)
    e, writes, chunks = _stage_mirror(s, Ht, Wt, Xs)
    assert 0 <= e < 8
    assert set(writes.values()) == {1}
    want = {}
    for y in range(Ht + 2 * PAD):
        for x in range(Xs):
            inside = PAD <= y < PAD + Ht and PAD <= x < PAD + Wt
            want[e + y * Xs + x] = (y - PAD, x - PAD) if inside else None
    assert dict(writes) == {(k, v): 1 for k, v in want.items()}
    assert max(want) * 2 + 2 <= lb.table_bytes(Ht, Wt)
    assert all(d % 8 == 0 and a % 8 == 0 for d, a in chunks)


def _full_count(strips, rows):
    """The outputs a small launch writes (B = G = Hpg = 2, H = W = 14, N =
    5: four segments of 8 lanes a warp), counted in full from the three
    parts."""
    B, G, Hpg, H, N = 2, 2, 2, 14, 5
    p = lb.FwdPlan("l1", 3, 4, strips, rows, 0, 0, 12)
    units, rows, cols = _plan_parts(p, B, G, Hpg, N, H, H)
    count = np.zeros((G * Hpg, B * N, H, H), np.int64)
    for (head, k, strip), a in units.items():
        for iy in rows[strip]:
            for ix, c in cols.items():
                count[head, k, iy, ix] += a * c
    return count


def test_plan_parts_match_a_full_count():
    """The three parts' product is the output: a full count of the outputs
    a small launch writes, strips of two rows, four segments of 8 lanes a
    warp (W = 14; 7 strips: a warp task holds four of one key's strips,
    then three and an idle segment)."""
    assert (_full_count(7, 2) == 1).all()


@pytest.mark.parametrize("strips,rows", [(2, 7), (1, 14)])
def test_plan_parts_put_keys_side_by_side(strips, rows):
    """Where a key has fewer strips than a warp has segments, a warp task
    holds several keys' strips side by side (two keys of two strips, four
    keys of one), each output still once."""
    assert (_full_count(strips, rows) == 1).all()


def test_fwd_plan_refuses_w_over_64():
    with pytest.raises(ValueError, match="1 to 64"):
        lb.fwd_plan(1, 1, 2, 129, 129, 10, 65, 65, H100_SMS,
                    "lattice_bias_wide")
    with pytest.raises(ValueError, match="no bias forward kernel"):
        lb.fwd_plan(1, 1, 2, 15, 15, 10, 8, 8, H100_SMS, "lattice_bias_sh")


# ---- the template's order ---------------------------------------------------

# (B, G, Hpg, H, Wt, N, k_pos range): TSA (column step exactly 1), SCA
# (step 2.5), clipped windows (keys far past the table), BEV 7 (M = 49), W
# = 33 (two columns a lane, W odd), the flagship's SCA and the pyramid's
# SCA 56 tables
ROWS_CASES = {
    "tsa_step1": (2, 2, 2, 8, 15, 40, 1.3),
    "sca_step2.5": (2, 2, 2, 8, 43, 40, 1.3),
    "clipped": (2, 1, 2, 8, 43, 48, 2.5),
    "bev7": (1, 2, 2, 7, 13, 30, 1.3),
    "w33": (1, 1, 2, 33, 65, 20, 1.3),
    "flagship_sca": (1, 1, 2, 28, 279, 24, 1.3),
    "pyramid_sca56": (1, 1, 2, 56, 559, 8, 1.3),
}


@pytest.mark.parametrize("case", list(ROWS_CASES))
def test_rows_mirror_equals_plain_bias(case):
    """``_rows_mirror`` (H + 1 x-lerped rows a key and head, then the
    y-lerp) equals the plain bias with float32 lerps on the bf16 table bit
    for bit: reusing each x-lerped row for two output rows changes no
    rounding."""
    B, G, Hpg, H, Wt, N, pos = ROWS_CASES[case]
    table, k_pos = _inputs(3, B, G, Hpg, H, Wt, N, pos)
    args = tda._geometry_args(table, k_pos, H, H)[:6]
    got = _rows_mirror(table, *args, H, H)
    ref = tda.lattice_bias_plain(table.float(), k_pos, H, H, torch.float32)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert float(ref.abs().max()) > 0
    assert torch.equal(got, ref)
    if case == "clipped":
        ys, ms, _, _ = tda.lattice_geometry(table.shape, k_pos, H, H)
        assert int(ms.min()) == 0 and int(ys.min()) == 0


@pytest.mark.parametrize("dma", ["0", "1"])
def test_rows_mirror_matches_pallas_forward(monkeypatch, dma):
    """Against the Pallas bias forward of the resolve staging in interpret
    mode on the bf16 table as float32: ``_fwd_call``, the counterpart of
    ``lattice_bias_wide.cu``, and its DMA-prefetch variant, that of
    ``lattice_bias_wide_prefetch.cu``."""
    monkeypatch.setenv("BEVRENDER_SHIFT_REPLICA", "0")
    monkeypatch.setenv("BEVRENDER_BIAS_DMA", dma)
    B, G, Hpg, H, Wt, N = 2, 2, 2, 8, 43, 40
    table, k_pos = _inputs(5, B, G, Hpg, H, Wt, N)
    bias, n = jda._lattice_bias_nm(
        jnp.asarray(table.float().numpy()), jnp.asarray(k_pos.numpy()), H, H,
        compute_dtype=jnp.float32, use_kernel=True, interpret=True)
    ref = np.asarray(bias, np.float32)[:, :, :, :n]
    args = tda._geometry_args(table, k_pos, H, H)[:6]
    got = _rows_mirror(table, *args, H, H).numpy()
    assert got.shape == ref.shape == (B, G, Hpg, N, H * H)
    assert np.abs(got - ref).max() <= PALLAS_F32_TOL * np.abs(ref).max()


def test_wide_bias_wrappers_refuse_cpu_tensors():
    """The kernels take CUDA tensors only; the CPU route is the plain bias
    (``ops.deform_attn.lattice_bias``)."""
    table, k_pos = _inputs(7, 1, 1, 2, 8, 15, 10)
    args = tda._kernel_args(table, k_pos, 8, 8)[:7]
    for fn in (lb.lattice_bias_wide_cuda, lb.lattice_bias_wide_prefetch_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args, 8, 8)


def test_rows_mirror_matches_pallas_shift_replicated_forward(monkeypatch):
    """Against the Pallas bias forward of the shift-replicated staging
    (``_fwd_call_sh``, the counterpart of ``lattice_bias.cu``) in
    interpret mode on the bf16 table as float32, at a TSA-like table
    (column step 1) and an SCA-like one (step 2.5)."""
    monkeypatch.setenv("BEVRENDER_SHIFT_REPLICA", "1")
    for Wt in (15, 43):
        B, G, Hpg, H, N = 2, 2, 2, 8, 40
        table, k_pos = _inputs(9, B, G, Hpg, H, Wt, N)
        assert jda.use_shift_replica(table.shape, H, H)
        bias, n = jda._lattice_bias_nm(
            jnp.asarray(table.float().numpy()), jnp.asarray(k_pos.numpy()),
            H, H, compute_dtype=jnp.float32, use_kernel=True, interpret=True)
        ref = np.asarray(bias, np.float32)[:, :, :, :n]
        args = tda._geometry_args(table, k_pos, H, H)[:6]
        got = _rows_mirror(table, *args, H, H).numpy()
        assert got.shape == ref.shape == (B, G, Hpg, N, H * H)
        assert np.abs(got - ref).max() <= PALLAS_F32_TOL * np.abs(ref).max()


def test_lattice_bias_wrapper_refuses_cpu_tensors():
    """``lattice_bias_cuda`` takes CUDA tensors only, on its plan's path or
    one given; the CPU route (``ops.deform_attn.lattice_bias``) is the plain
    bias and launches nothing."""
    table, k_pos = _inputs(8, 1, 1, 2, 8, 15, 10)
    args = tda._kernel_args(table, k_pos, 8, 8)
    for path in (None, "whole", "l1"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            lb.lattice_bias_cuda(*args, 8, 8, path=path)
    before = lb.launches
    out = tda.lattice_bias(table, k_pos, 8, 8)
    assert lb.launches == before
    assert torch.equal(out, tda.lattice_bias_plain(table, k_pos, 8, 8))
