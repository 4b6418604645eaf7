"""The folded fused sites of the port on the CPU: the plain versions that
the folded CUDA kernels are held to against the JAX package's head-folded
Pallas kernels (``fused_site_call_v2`` and its logsumexp instance, #11 and
#12) and its row-folded one (``fused_site_call_sh2``, #13) in interpret
mode, the kernel choice (``site_kernels``) under the fold fields at every
site of the flagship and the pyramid against the launch counts that
chip_smoke.py holds the card to, and the fold fields from the config to
every site.

Inputs are made with numpy from a seed and fed to both frameworks, at the
shapes of the JAX package's own tests of these kernels
(tests/test_ops_fused.py). The CUDA kernels themselves are held to the same
plain versions, and with tolerance 0 to their per-head siblings, in
test_torch_kernels.py on the card.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevrender_tpu.ops.deform_attn import _kernel_inputs, _kernel_inputs_sh
from bevrender_tpu.ops.pallas.experimental import (
    fused_site_call_sh2,
    fused_site_call_v2,
    fused_site_call_v2_lse,
)
from bevrender_tpu_torch import config as tcfg
from bevrender_tpu_torch.data.synthetic import SyntheticDataset
from bevrender_tpu_torch.inference.register import RegistrationPipeline
from bevrender_tpu_torch.models.attention import _Site
from bevrender_tpu_torch.ops import deform_attn as tda
from bevrender_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
# the sites of one encoder pass and the launch counts of a whole flagship or
# pyramid pass, summed over site_kernels at every site, as the wide route's
# tests sum them
_wide_site = _load("test_torch_wide_site",
                   ROOT / "tests" / "test_torch_wide_site.py")
_site_calls, _launches = _wide_site._site_calls, _wide_site._launches

# site output against a Pallas site kernel: p rounded to bf16 before
# normalising in one and after in the other (chip_smoke.SITE_P_ROUND)
SITE_P_ROUND = chip_smoke.SITE_P_ROUND
# logsumexp against the Pallas kernel's: both from bf16-rounded q, k and
# table with float32 scores, summed in another order (chip_smoke.LSE_TOL,
# the bound the card holds the CUDA logsumexp to)
LSE_TOL = chip_smoke.LSE_TOL

# (B, G, Hpg, H, W, N): the JAX package's fused-site tests' shapes (two key
# tiles with padded keys; three groups of one head)
SHAPES = [(1, 2, 2, 8, 8, 100), (2, 3, 1, 8, 8, 200)]
# Hpg * W = 160 > 128: the JAX package's own shape for v2's fallback to
# the per-head kernel
WIDE_ROWS = (1, 1, 4, 8, 40, 80)


def _inputs(seed, B, G, Hpg, H, W, N, ch):
    """Table (std 1: the bias outweighs q . k), key positions, and q, k, v
    in bf16 with N keys (numpy), as both frameworks take them."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((G, Hpg, 2 * H - 1, 2 * W * 4 - 1)).astype(
        np.float32)
    k_pos = rng.uniform(-0.95, 0.95, (B, G, N, 2)).astype(np.float32)
    k, v = (rng.standard_normal((B, G, Hpg, N, ch)) for _ in range(2))
    q = rng.standard_normal((B, G, Hpg, H * W, ch))
    bf = jnp.bfloat16
    return table, k_pos, *(np.asarray(jnp.asarray(x, bf), np.float32)
                           for x in (q, k, v))


def _padded(x, Np):
    """(B, G, Hpg, N, ch) keys padded to the staging's Np, in bf16."""
    pad = ((0, 0),) * 3 + ((0, Np - x.shape[3]), (0, 0))
    return jnp.asarray(np.pad(x, pad), jnp.bfloat16)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _jax_site(kernel, table, k_pos, q, k, v, H, W, scale):
    """The Pallas site ``kernel`` in interpret mode on the JAX package's own
    staging; returns the output (B, G, Hpg, M, ch) and, for the logsumexp
    instance, the logsumexp (B, G, Hpg, M)."""
    Hpg, N = q.shape[2], k.shape[3]
    qcm = jnp.asarray(np.swapaxes(q, -1, -2), jnp.bfloat16)
    if kernel == "sh2":
        lane_block = 64 if Hpg * W <= 64 else 128
        t3s, wy4, f4, packed, gcol, Np = _kernel_inputs_sh(
            jnp.asarray(table), jnp.asarray(k_pos), H, W, lane_block=lane_block)
        out = fused_site_call_sh2(t3s, wy4, f4, packed, gcol, _padded(k, Np),
                                  _padded(v, Np), qcm, H, W, Hpg, True, N,
                                  scale)
        return np.swapaxes(np.asarray(out), -1, -2), None
    *staged, Np = _kernel_inputs(jnp.asarray(table), jnp.asarray(k_pos), H, W)
    call = fused_site_call_v2_lse if kernel == "v2_lse" else fused_site_call_v2
    res = call(*staged, _padded(k, Np), _padded(v, Np), qcm, H, W, Hpg, True,
               N, scale)
    out, lse = res if kernel == "v2_lse" else (res, None)
    return np.swapaxes(np.asarray(out), -1, -2), (
        None if lse is None else np.asarray(lse))


def _check_against_pallas(kernel, shape, ch, seed):
    B, G, Hpg, H, W, N = shape
    table, k_pos, q, k, v = _inputs(seed, *shape, ch)
    scale = ch ** -0.5
    ref, ref_lse = _jax_site(kernel, table, k_pos, q, k, v, H, W, scale)
    tq, tk, tv, kp = map(_t, (q, k, v, k_pos))
    tb = _t(table).bfloat16().float()
    out, lse = tda.site_plain_lse(tq, tk, tv, kp, tb, H, W, scale,
                                  torch.float32)
    bias = tda.lattice_bias_plain(tb, kp, H, W, torch.float32)
    wabs = tda.site_consumer(tq, tk, tv.abs(), bias, scale).numpy()
    assert out.shape == ref.shape == (B, G, Hpg, H * W, ch)
    np.testing.assert_array_less(np.abs(out.numpy() - ref),
                                 SITE_P_ROUND * wabs + 1e-5)
    if ref_lse is not None:
        assert ref_lse.shape == (B, G, Hpg, H * W)
        assert float(np.abs(lse.numpy() - ref_lse).max()) <= LSE_TOL


@pytest.mark.parametrize("kernel", ["v2", "v2_lse", "sh2"])
@pytest.mark.parametrize("ch", [4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_folded_site_kernels(kernel, ch, shape):
    """``site_plain`` (the plain version of ``fused_site_fold_heads`` and
    ``fused_site_fold_rows``) against the head-folded DMA site (#11) and
    the row-folded shift-replica site (#13, staged with its 64-lane row
    blocks), and ``site_plain_lse`` (the plain version of
    ``fused_site_fold_heads_lse``) against #12 in output and logsumexp."""
    _check_against_pallas(kernel, shape, ch, 60 + ch)


@pytest.mark.parametrize("kernel", ["v2", "v2_lse"])
def test_wide_rows_take_the_per_head_kernels(kernel):
    """Where Hpg * W = 160 > 128, ``fused_site_call_v2`` runs its per-head
    fallback and the plain version stays within the same bounds of it; the
    port names its per-head kernels there under every fold option."""
    _check_against_pallas(kernel, WIDE_ROWS, 4, 70)
    B, G, Hpg, H, W, N = WIDE_ROWS
    q, t = (B, G, Hpg, H * W, 4), (G, Hpg, 2 * H - 1, 2 * W * 4 - 1)
    fold = dict(site_prefetch=True, site_fold_heads=True, site_fold_rows=True)
    assert tda.site_kernels(q, t, H, W, tda.SiteOptions(
        lattice_route="wide", **fold), training=False) == (
        "fused_site_wide_prefetch",)
    assert tda.site_kernels(q, t, H, W, tda.SiteOptions(**fold),
                            training=False) == ("fused_site",)
    for route in ("auto", "wide"):
        opts = tda.SiteOptions(fused_bwd=True, lattice_route=route,
                               fused_fwd_fold=True, **fold)
        assert tda.site_kernels(q, t, H, W, opts, training=True)[0] == (
            "fused_site_lse" if route == "auto" else "fused_site_wide_lse")


# ---- the kernel choice ------------------------------------------------------

FLAGSHIP = tcfg.flagship_config().model
PYRAMID = tcfg.Config().model
FOLD_HEADS = dict(site_prefetch=True, site_fold_heads=True)
FOLD_OPTIONS = [FOLD_HEADS, dict(site_fold_rows=True),
                dict(FOLD_HEADS, site_fold_rows=True, fused_fwd_fold=True)]


def test_flagship_fold_kernels():
    """The flagship's serving forward (B=4, T=2) and training step (B=2,
    T=2, ``fused_bwd``) take exactly the kernels whose launches chip_smoke's
    phases 19-21 count on the card: every fused site folds (Hpg * W =
    56)."""
    heads = tda.SiteOptions(lattice_route="wide", **FOLD_HEADS)
    assert _launches(FLAGSHIP, chip_smoke.SERVE_B, heads, False) == \
        chip_smoke.FOLD_HEADS_PER_FORWARD
    rows = tda.SiteOptions(site_fold_rows=True)
    assert _launches(FLAGSHIP, chip_smoke.SERVE_B, rows, False) == \
        chip_smoke.FOLD_ROWS_PER_FORWARD
    train = tda.SiteOptions(fused_bwd=True, **FOLD_HEADS)
    assert _launches(FLAGSHIP, chip_smoke.TRAIN_B, train, True) == \
        chip_smoke.FOLD_TRAIN_COUNTS


@pytest.mark.parametrize("options", FOLD_OPTIONS)
def test_pyramid_kernels_are_unchanged_by_the_fold_fields(options):
    """The pyramid's sites have head width 32: no fused site, so no fold;
    its serving and training counts are those of chip_smoke's phases 10 and
    11 under every fold option."""
    for fused_bwd in (False, True):
        opts = tda.SiteOptions(fused_bwd=fused_bwd, **options)
        assert _launches(PYRAMID, chip_smoke.PYR_B, opts, False) == \
            chip_smoke.PYR_PER_FORWARD
        assert _launches(PYRAMID, chip_smoke.PYR_B, opts, True) == \
            chip_smoke.PYR_TRAIN_COUNTS["nothing"]


@pytest.mark.parametrize("route", ["auto", "wide"])
@pytest.mark.parametrize("fold_heads,fused_fwd_fold,folded", [
    (False, None, False), (True, None, True), (True, False, False),
    (False, True, True)])
def test_fused_fwd_fold_follows_site_fold_heads(route, fold_heads,
                                                fused_fwd_fold, folded):
    """The forward of a ``fused_bwd`` site folds the heads where
    ``fused_fwd_fold`` says so, and follows ``site_fold_heads`` where it is
    None (BEVRENDER_TRAIN_FWD_V2 unset), on either route; the backward
    stays ``fused_site_bwd``."""
    opts = tda.SiteOptions(fused_bwd=True, lattice_route=route,
                           site_prefetch=True, site_fold_heads=fold_heads,
                           fused_fwd_fold=fused_fwd_fold)
    per_head = "fused_site_lse" if route == "auto" else "fused_site_wide_lse"
    assert tda.site_kernels((6, 4, 2, 784, 8), (4, 2, 55, 279), 28, 28, opts,
                            training=True) == (
        "fused_site_fold_heads_lse" if folded else per_head, "fused_site_bwd")


def test_fold_rows_needs_room_for_every_head():
    """A narrow-head site whose one table fits ``fused_site`` but whose two
    do not fit one block (two heads at BEV 56, depth 5: 2 x 119 x 849 x 2
    B) keeps ``fused_site`` under ``site_fold_rows``."""
    opts = tda.SiteOptions(site_fold_rows=True)
    assert tda.site_kernels((2, 1, 2, 3136, 4), (1, 2, 111, 559), 56, 56,
                            opts, training=False) == ("fused_site",)
    assert tda.site_kernels((2, 1, 2, 784, 4), (1, 2, 55, 279), 28, 28,
                            opts, training=False) == ("fused_site_fold_rows",)


def _rows_fit_before(Hpg, Ht, Xp, W, ch) -> bool:
    """``rows_fit`` as it stood before the row-folded site became an
    instance of csrc/site_whole.cuh: the heads fold, and the Hpg padded
    tables with every head's K and V tile in float32 and three words of
    geometry a key fit one block."""
    smem = Hpg * (Ht + 8) * Xp * 2 + 2 * Hpg * 32 * ch * 4 + 32 * 12
    return Hpg in (1, 2) and Hpg * W <= 128 and smem <= 232448


@pytest.mark.parametrize("sites", ["flagship", "pyramid", "grid"])
def test_rows_fit_takes_every_site_it_took_before(sites):
    """``rows_fit`` is now the template's fit (every head's padded table
    and the whole-table key stages in one block, 640 bytes more than the
    old kernel's layout): at every site of both supported models it takes
    what it took before; over PATH_GRID it takes nothing new and drops
    only sites whose old layout came within 640 bytes of a block's shared
    memory."""
    fold = kernels.fused_site_fold
    if sites == "grid":
        rows = [(Hpg, 2 * H - 1, tda.padded_width(Wt), H, ch)
                for Hpg, H, Wt, ch in PATH_GRID]
    else:
        mc = FLAGSHIP if sites == "flagship" else PYRAMID
        rows = [(t[1], t[2], tda.padded_width(t[3]), W, q[-1])
                for q, t, H, W, _ in _site_calls(mc, 4)]
    before = [_rows_fit_before(*r) for r in rows]
    now = [fold.rows_fit(*r) for r in rows]
    if sites != "grid":
        assert now == before and any(now)
        return
    for r, a, b in zip(rows, before, now):
        assert b <= a, r
        if a != b:
            Hpg, Ht, Xp, _, ch = r
            assert fold.whole_smem(Hpg, Ht, Xp, ch) - 640 <= 232448, r
    assert sum(now) > 0


@pytest.mark.parametrize("site", chip_smoke.SITE_SITES
                         + chip_smoke.TRAIN_SITE_SITES)
def test_rows_plan_follows_the_shapes(site):
    """``fused_site_fold_rows`` at chip_smoke's shapes (phase 22) takes one
    head's padded table a block (ROWS_HEADS), four blocks an SM counted
    on, in the strip ``wave_strip`` gives its B * G * Hpg block rows: 160
    at the SCA shapes, 128 at the TSA ones but the serving G = 8 (160)."""
    name, B, G, ch, N, Wt, _ = site
    fold = kernels.fused_site_fold
    H, Xp = chip_smoke.H, tda.padded_width(Wt)
    plan = fold.rows_plan(B, G, chip_smoke.HPG, 2 * H - 1, Xp, H, H, ch, 132)
    assert fold.rows_fit(chip_smoke.HPG, 2 * H - 1, Xp, H, ch)
    assert (plan.path, plan.heads, plan.per_sm) == ("whole", 1, 4)
    assert plan.smem == fold.whole_smem(1, 2 * H - 1, Xp, ch)
    rows = B * G * chip_smoke.HPG
    assert plan.strip == plan.threads == fold.wave_strip(
        1, H * H, rows, 4, 132, fold.ROWS_THREADS)
    assert plan.strip == (160 if name.startswith("sca") or (B, G) == (4, 8)
                          else 128)
    assert plan.blocks == -(-(H * H) // plan.strip) * rows
    assert plan.waves == -(-plan.blocks // (4 * 132))


def test_site_fold_heads_needs_site_prefetch():
    with pytest.raises(ValueError, match="site_prefetch"):
        tda.SiteOptions(site_fold_heads=True, site_prefetch=False)
    cfg = _tiny(site_fold_heads=True)
    with pytest.raises(ValueError, match="site_prefetch"):
        RegistrationPipeline(cfg, device="cpu", seed=1)


# ---- the head-folded kernel's two paths --------------------------------------

def _ring_fit_before(Hpg, Wt, H, W, ch) -> bool:
    """``heads_fit`` as it stood before the whole-table path: the heads
    fold, and the ring (two slots of 16 keys x Hpg heads x R rows x CW
    columns in bf16) with every head's K and V tile in float32 and three
    words of geometry a key fits one block."""
    u_max = (Wt - 1) // 2
    CW = -(-(u_max + 3 + 7) // 8) * 8
    R = min(-(-127 // W), H - 1) + 2
    smem = 2 * 16 * Hpg * R * CW * 2 + 2 * Hpg * 32 * ch * 4 + 32 * 12
    return Hpg in (1, 2) and Hpg * W <= 128 and smem <= 232448


# (Hpg, H = W, table width, ch): BEV 7 to 64 at depths 1 to 8
PATH_GRID = [(Hpg, H, Wt, ch) for Hpg in (1, 2)
             for H in (7, 10, 14, 28, 32, 56, 60, 64)
             for Wt in (13, 27, 39, 55, 111, 139, 279, 299, 559, 639, 1023)
             for ch in (4, 8)]


def test_heads_fit_is_the_ring_formula():
    """Which sites fold is unchanged by the whole-table path: ``heads_fit``
    still admits exactly the sites whose ring fits one block."""
    fits = [kernels.fused_site_fold.heads_fit(Hpg, Wt, H, H, ch)
            for Hpg, H, Wt, ch in PATH_GRID]
    assert fits == [_ring_fit_before(Hpg, Wt, H, H, ch)
                    for Hpg, H, Wt, ch in PATH_GRID]
    assert 0 < sum(fits) < len(fits)


def test_every_site_bwd_site_that_folds_takes_the_whole_table_path():
    """A site whose table and float32 gradient fit ``fused_site_bwd.cu``
    (``_site_bwd_fits``, 6 B an entry) and that folds takes the whole-table
    path: two heads' bf16 tables (4 B an entry) and the key stages fit. The
    grid also holds folded sites on the ring path, all outside
    ``_site_bwd_fits``."""
    fold = kernels.fused_site_fold
    paths = {"whole": 0, "ring": 0}
    for Hpg, H, Wt, ch in PATH_GRID:
        if not fold.heads_fit(Hpg, Wt, H, H, ch):
            continue
        path = fold.heads_plan(Hpg, Wt, H, H, ch)[0]
        paths[path] += 1
        if tda._site_bwd_fits((1, Hpg, 2 * H - 1, Wt), H, ch):
            assert path == "whole", (Hpg, H, Wt, ch)
    assert paths["whole"] > 0 and paths["ring"] > 0


@pytest.mark.parametrize("Hpg,H,Wt,ch,path", [
    (2, 28, 279, 8, "whole"), (2, 28, 55, 4, "whole"), (1, 28, 279, 4, "whole"),
    (2, 60, 299, 4, "ring"), (2, 64, 279, 8, "ring")])
def test_heads_plan_follows_the_shapes(Hpg, H, Wt, ch, path):
    """The whole-table path where every head's padded table and the key
    stages fit one block (``whole_smem``), the ring where they do not; a
    whole-table block holds Hpg x its strip of queries, at most 256
    threads, a multiple of 32."""
    fold = kernels.fused_site_fold
    got, S, threads, smem = fold.heads_plan(Hpg, Wt, H, H, ch)
    whole = fold.whole_smem(Hpg, 2 * H - 1, tda.padded_width(Wt), ch)
    assert got == path and (whole <= fold.SMEM_PER_BLOCK) == (path == "whole")
    if path == "whole":
        assert smem == whole and threads == Hpg * S <= 256
        assert threads % 32 == 0 and S * -(-(H * H) // S) >= H * H
    else:
        assert (S, threads, smem) == (128, 128,
                                      fold.fold_ring(Hpg, Wt, H, H, ch)[3])


@pytest.mark.parametrize("sites", ["SITE_SITES", "TRAIN_SITE_SITES",
                                   "FOLD_RING_SITE"])
def test_chip_smoke_fold_sites_take_the_paths_it_expects(sites):
    """chip_smoke's phase 22 holds the head-folded kernels at its serving
    and training sites on the whole-table path and at FOLD_RING_SITE on the
    ring path, and fails a site that takes the other one."""
    if sites == "FOLD_RING_SITE":
        *site, side = chip_smoke.FOLD_RING_SITE
        rows, want = [(site, side)], "ring"
    else:
        rows = [(site, chip_smoke.H) for site in getattr(chip_smoke, sites)]
        want = "whole"
    for (_, _, _, ch, _, Wt, _), side in rows:
        assert kernels.fused_site_fold.heads_fit(chip_smoke.HPG, Wt, side,
                                                 side, ch)
        assert kernels.fused_site_fold.heads_plan(
            chip_smoke.HPG, Wt, side, side, ch)[0] == want


@pytest.mark.parametrize("training", [False, True])
def test_flagship_fused_sites_take_the_whole_table_path(training):
    """Every flagship site that takes a head-folded kernel, serving (B=4 on
    "wide" with the prefetch and fold fields) or training (B=2 under
    ``fused_bwd`` with them), takes its whole-table path."""
    opts = tda.SiteOptions(fused_bwd=training,
                           lattice_route="auto" if training else "wide",
                           **FOLD_HEADS)
    B = chip_smoke.TRAIN_B if training else chip_smoke.SERVE_B
    folded = 0
    for q, t, H, W, _ in _site_calls(FLAGSHIP, B):
        name = tda.site_kernels(q, t, H, W, opts, training=training)[0]
        if name.startswith("fused_site_fold_heads"):
            folded += 1
            assert kernels.fused_site_fold.heads_plan(
                t[1], t[3], H, W, q[-1])[0] == "whole", (q, t)
    assert folded == 6  # stages 2, 3 and 4, a TSA and an SCA site each


# ---- the config fields, end to end on the CPU -------------------------------

def _tiny(**fields):
    cfg = tcfg.Config()
    cfg.model = tcfg.tiny_model_config(embed_dims=(32, 32, 32),
                                       n_heads=(2, 8), n_groups=(1, 4),
                                       **fields)
    return cfg


def _sites(net):
    return [m for m in net.modules() if isinstance(m, _Site)]


@pytest.mark.parametrize("fields", [
    dict(site_fold_rows=True),
    dict(lattice_route="wide", site_fold_heads=True, site_prefetch=True)])
def test_fold_fields_render_as_the_default_on_the_cpu(fields):
    """A tiny model (stage 1 of head width 4 with G = 4 and two heads per
    group on the fused site) under the fold fields renders what the default
    renders: on CPU tensors every kernel is its plain version. The fields
    reach every site of the pipeline's model, and no kernel launches."""
    batch = SyntheticDataset(n_items=2, num_views=2, window_num_imgs=1,
                             img_height=32, img_width=32, seed=3).batch(2)
    before = kernels.counts()
    base = RegistrationPipeline(_tiny(), device="cpu", seed=1)
    fold = RegistrationPipeline(_tiny(**fields), device="cpu", seed=1)
    assert torch.equal(fold.render(batch), base.render(batch))
    sites = _sites(fold.net)
    assert len(sites) == 4  # 2 stages x (TSA, SCA)
    assert {s.site_options for s in sites} == {tda.SiteOptions(**fields)}
    assert kernels.counts() == before


def test_trainer_hands_the_fold_fields_to_every_site(tmp_path):
    """``Trainer.create_state`` sets ``fused_fwd_fold`` with the training
    pass's other fields, and the model's fold fields, on every site."""
    from bevrender_tpu_torch.training.trainer import Trainer

    cfg = _tiny(site_prefetch=True, site_fold_heads=True, site_fold_rows=True)
    cfg.train.fused_bwd, cfg.train.fused_fwd_fold = True, False
    cfg.train.work_dir = str(tmp_path)
    ds = SyntheticDataset(n_items=2, num_views=2, window_num_imgs=1,
                          img_height=32, img_width=32, map_tile=32)
    net = Trainer(cfg, ds, device="cpu").create_state(seed=0).net
    want = tda.SiteOptions(fused_bwd=True, site_prefetch=True,
                           site_fold_heads=True, site_fold_rows=True,
                           fused_fwd_fold=False)
    assert {s.site_options for s in _sites(net)} == {want}
    assert not want.fold_train_forward
