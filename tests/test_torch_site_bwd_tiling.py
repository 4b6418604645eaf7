"""The host side of the fused site backward kernel (csrc/fused_site_bwd.cu):
how ``ops/kernels/fused_site_bwd.py::tiling`` cuts a launch into blocks,
the shared memory it asks for, and ``_site_bwd_fits``, which routes a
``fused_bwd`` site to the kernel. Runs anywhere (no card, no JAX)."""

import importlib.util
from pathlib import Path

import pytest

from bevrender_tpu_torch import config as tcfg
from bevrender_tpu_torch.ops import deform_attn as tda
from bevrender_tpu_torch.ops.kernels import fused_site_bwd as fsb
from bevrender_tpu_torch.ops.kernels._launch import PAD, SMEM_PER_BLOCK

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

HPG = 2
# (B, G, ch, N, H, Wt): a flagship training step's four narrow sites
# (chip_smoke.TRAIN_SITE_SITES, H = W = 28) ...
TRAIN_SHAPES = [(B, G, ch, N, 28, Wt)
                for _, B, G, ch, N, Wt, _ in chip_smoke.TRAIN_SITE_SITES]
# ... and the card tests' shapes (tests/test_torch_kernels.py), B = 2, G = 4
CARD_SHAPES = [(2, 4, ch, N, H, Wt) for ch, N, H, Wt in [
    (4, 1960, 28, 279), (8, 196, 28, 55), (4, 300, 8, 15), (8, 784, 28, 55),
    (8, 10, 8, 15), (4, 37, 6, 11), (8, 257, 5, 9), (8, 300, 8, 15),
    (8, 300, 28, 390), (4, 300, 28, 399)]]


def _tiling(B, G, ch, N, H, Wt):
    Ht, Xp, M = 2 * H - 1, tda.padded_width(Wt, H), H * H
    return fsb.tiling(B, G, HPG, Ht, Xp, N, M, ch), Ht, Xp, M


@pytest.mark.parametrize("shape", TRAIN_SHAPES + CARD_SHAPES)
def test_tiling_covers_every_key_and_query_once(shape):
    """The kernel takes ``nkb`` key blocks of 16 * warps keys and ``qsplit``
    chunks of the strips as given: the key blocks hold every key and none
    is empty, and every chunk holds at least one strip."""
    B, G, ch, N, H, Wt = shape
    (warps, nkb, qsplit), _, _, M = _tiling(*shape)
    assert 1 <= warps <= fsb.MAX_WARPS
    keys = fsb.KEYS_PER_WARP * warps
    assert (nkb - 1) * keys < N <= nkb * keys
    assert 1 <= qsplit <= -(-M // fsb.SLOTS)


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_training_shapes_fill_the_card(shape):
    """Each narrow site of a training step launches at least 2 x 132
    blocks, whose warps shared memory does not cut: the dq buffers of 16
    warps fit beside the table."""
    B, G, ch, N, H, Wt = shape
    (warps, nkb, qsplit), Ht, Xp, M = _tiling(*shape)
    assert B * G * HPG * nkb * qsplit >= fsb.MIN_BLOCKS
    assert fsb.smem_bytes(Ht, Xp, ch, fsb.MAX_WARPS) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("shape", TRAIN_SHAPES + CARD_SHAPES)
def test_launch_fits_shared_memory(shape):
    B, G, ch, N, H, Wt = shape
    (warps, _, _), Ht, Xp, _ = _tiling(*shape)
    assert fsb.smem_bytes(Ht, Xp, ch, warps) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("ch", [4, 8])
def test_wide_tables_launch_fewer_warps(ch):
    """Every table ``_site_bwd_fits`` takes gets a launch whose dq buffers,
    one a warp, fit beside it: 16 warps where their buffers fit, fewer
    only where they do not; a table it refuses is refused by ``tiling``."""
    N = 1960
    for H in (8, 28):
        Ht, M = 2 * H - 1, H * H
        for Wt in range(3, 1200):
            Xp = tda.padded_width(Wt, H)
            if not tda._site_bwd_fits((1, 2, Ht, Wt), H, ch):
                with pytest.raises(ValueError):
                    fsb.tiling(2, 4, HPG, Ht, Xp, N, M, ch)
                continue
            warps, _, _ = fsb.tiling(2, 4, HPG, Ht, Xp, N, M, ch)
            assert fsb.smem_bytes(Ht, Xp, ch, warps) <= SMEM_PER_BLOCK
            full = fsb.smem_bytes(Ht, Xp, ch, fsb.MAX_WARPS) <= SMEM_PER_BLOCK
            assert (warps == fsb.MAX_WARPS) == full, (H, Wt, warps)


def _old_fits(table_shape, W, ch):
    """The kernel's shared memory before its redesign: the padded table in
    bf16 with its float32 gradient and a tile of 32 queries (q, dO, dq,
    lse, D, geometry)."""
    _, _, Ht, Wt = table_shape
    need = (Ht + 2 * PAD) * tda.padded_width(Wt, W) * 6 + 32 * (3 * ch + 4) * 4
    return need <= SMEM_PER_BLOCK


@pytest.mark.parametrize("ch", [4, 8])
def test_site_bwd_fits_follows_the_kernel_and_keeps_every_site(ch):
    """``_site_bwd_fits`` is the kernel's own formula at one warp, and
    takes every table the kernel took before (here every table up to and
    past the limit, one column at a time near it)."""
    for H in (7, 14, 28, 56, 64):
        for Wt in list(range(3, 1200, 7)) + list(range(560, 700)):
            t = (1, 2, 2 * H - 1, Wt)
            Xp = tda.padded_width(Wt, H)
            got = tda._site_bwd_fits(t, H, ch)
            assert got == (fsb.smem_bytes(2 * H - 1, Xp, ch) <= SMEM_PER_BLOCK)
            if _old_fits(t, H, ch):
                assert got, (t, H, ch)


def _site_calls(mc, B):
    for s in range(mc.n_stages):
        H = mc.bev_shapes[s]
        G, heads = mc.n_groups[s], mc.n_heads[s]
        Hpg, ch = heads // G, mc.embed_dims[s] // heads
        yield (B, G, Hpg, H * H, ch), (G, Hpg, 2 * H - 1, 2 * H - 1), H
        yield ((B * mc.num_views, G, Hpg, H * H, ch),
               (G, Hpg, 2 * H - 1, 2 * H * mc.bev_depth_dim - 1), H)


@pytest.mark.parametrize("model", ["flagship", "pyramid"])
@pytest.mark.parametrize("route", ["auto", "wide"])
def test_training_routes_are_unchanged(model, route, monkeypatch):
    """Every training site of the flagship and the pyramid takes the same
    kernels under ``fused_bwd`` as with the kernel's old shared-memory
    formula: the flagship's narrow sites its backward, the rest the bias
    route."""
    mc = (tcfg.flagship_config() if model == "flagship" else tcfg.Config()).model
    opts = tda.SiteOptions(fused_bwd=True, lattice_route=route)
    calls = list(_site_calls(mc, 2))
    now = [tda.site_kernels(q, t, H, H, opts, training=True)
           for q, t, H in calls]
    monkeypatch.setattr(tda, "_site_bwd_fits", _old_fits)
    before = [tda.site_kernels(q, t, H, H, opts, training=True)
              for q, t, H in calls]
    assert now == before
    n_bwd = sum("fused_site_bwd" in k for k in now)
    assert n_bwd == (6 if model == "flagship" else 0)
