"""The wide-table route of the port on the CPU: the plain versions of the
wide fused site, its window-prefetch variant and the prefetch bias against
the JAX package's Pallas kernels of the plain ("resolve") staging in
interpret mode, the kernel choice (``site_kernels``) at every site of the
flagship and the pyramid against the launch counts that chip_smoke.py
holds the card to, and the route fields from the config to every site.

Inputs are made with numpy from a seed and fed to both frameworks, as the
JAX package's own tests feed its DMA variants (tests/test_ops_fused.py).
The CUDA kernels themselves are held against the same plain versions, and
against their bit-equal siblings, in test_torch_kernels.py on the card.
"""

import collections
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevrender_tpu.ops.deform_attn import _kernel_inputs
from bevrender_tpu.ops.pallas.experimental import fused_site_call_dma
from bevrender_tpu.ops.pallas.fused_attn import fused_site_call
from bevrender_tpu.ops.pallas.lattice_bias import _fwd_call
from bevrender_tpu_torch import config as tcfg
from bevrender_tpu_torch.data.synthetic import SyntheticDataset
from bevrender_tpu_torch.inference.register import RegistrationPipeline
from bevrender_tpu_torch.models.attention import _Site, set_site_options
from bevrender_tpu_torch.ops import deform_attn as tda
from bevrender_tpu_torch.ops import kernels
from bevrender_tpu_torch.ops.kernels import (
    fused_site,
    fused_site_wide,
    lattice_bias,
)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# Site output against a Pallas site kernel: both lerp in float32 from the
# bf16 table and multiply bf16 K, Q, p and V with float32 sums; the kernel
# rounds p to bf16 before normalising, the plain version after, each off by
# at most 2^-8 of the p-weighted |v|; 1e-5 for float32 sums in another
# order. The card holds the CUDA kernels to the same bound.
SITE_P_ROUND = chip_smoke.SITE_P_ROUND
# bias against a Pallas bias kernel: the same float32 lerps rounded once to
# bf16, one bf16 ulp (at most |x| * 2^-7) where a last-bit float32
# difference flips the rounding
BIAS_ULP = chip_smoke.BIAS_ULP

# (B, G, Hpg, H, W, N): the JAX package's DMA tests' shapes (two key tiles
# with padded keys; B * G * tiles crossing an 8-row packed block)
RESOLVE_SHAPES = [(1, 2, 2, 8, 8, 100), (2, 3, 1, 8, 8, 200)]


def _resolve_inputs(seed, B, G, Hpg, H, W, N, ch):
    """Table (std 1: the bias outweighs q . k) and key positions, the JAX
    package's staged kernel inputs, and q, k, v in bf16 (keys padded to
    the staging's tile multiple Np)."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((G, Hpg, 2 * H - 1, 2 * W * 4 - 1)).astype(
        np.float32)
    k_pos = rng.uniform(-0.95, 0.95, (B, G, N, 2)).astype(np.float32)
    staged = _kernel_inputs(jnp.asarray(table), jnp.asarray(k_pos), H, W)
    Np = staged[-1]
    k = jnp.asarray(rng.standard_normal((B, G, Hpg, Np, ch)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, G, Hpg, Np, ch)), jnp.bfloat16)
    qcm = jnp.asarray(rng.standard_normal((B, G, Hpg, ch, H * W)),
                      jnp.bfloat16)
    return table, k_pos, staged[:-1], k, v, qcm


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _bf16_table(table):
    return _t(table).bfloat16().float()


@pytest.mark.parametrize("kernel", ["fused_site_call", "fused_site_call_dma"])
@pytest.mark.parametrize("ch", [4, 8])
@pytest.mark.parametrize("shape", RESOLVE_SHAPES)
def test_site_plain_matches_resolve_site_kernels(kernel, ch, shape):
    """``site_plain`` (the plain version of ``fused_site_wide`` and of
    ``fused_site_wide_prefetch``) against the Pallas fused site on the plain
    staging (#7) and its DMA-prefetch variant (#10), in interpret mode."""
    B, G, Hpg, H, W, N = shape
    table, k_pos, staged, k, v, qcm = _resolve_inputs(30 + ch, *shape, ch)
    scale = ch ** -0.5
    call = {"fused_site_call": fused_site_call,
            "fused_site_call_dma": fused_site_call_dma}[kernel]
    ref = np.asarray(call(*staged, k, v, qcm, H, W, Hpg, True, N, scale))
    ref = np.swapaxes(ref, -1, -2)  # (B, G, Hpg, M, ch)
    q = _t(np.swapaxes(np.asarray(qcm, np.float32), -1, -2))
    kt, vt = _t(np.asarray(k, np.float32)[..., :N, :]), _t(
        np.asarray(v, np.float32)[..., :N, :])
    tb, kp = _bf16_table(table), _t(k_pos)
    out = tda.site_plain(q, kt, vt, kp, tb, H, W, scale, torch.float32)
    bias = tda.lattice_bias_plain(tb, kp, H, W, torch.float32)
    wabs = tda.site_consumer(q, kt, vt.abs(), bias, scale).numpy()
    assert out.shape == ref.shape == (B, G, Hpg, H * W, ch)
    np.testing.assert_array_less(np.abs(out.numpy() - ref),
                                 SITE_P_ROUND * wabs + 1e-5)


@pytest.mark.parametrize("shape", RESOLVE_SHAPES)
def test_bias_plain_matches_prefetch_bias_kernel(shape):
    """``lattice_bias_plain`` (the plain version of
    ``lattice_bias_wide_prefetch``) against the Pallas bias forward on the
    plain staging with DMA window prefetch (#5, ``_fwd_call(dma=True)``)
    in interpret mode: within one bf16 ulp."""
    B, G, Hpg, H, W, N = shape
    table, k_pos, staged, *_ = _resolve_inputs(40, *shape, 4)
    ref = np.asarray(_fwd_call(*staged, H, W, Hpg, True, N, dma=True),
                     np.float32)[..., :N, :]
    out = tda.lattice_bias_plain(_bf16_table(table), _t(k_pos), H, W,
                                 torch.float32).bfloat16().float().numpy()
    assert out.shape == ref.shape == (B, G, Hpg, N, H * W)
    np.testing.assert_array_less(np.abs(out - ref),
                                 np.abs(ref) * BIAS_ULP + 1e-30)
    assert np.abs(out - ref).max() <= np.abs(ref).max() * BIAS_ULP


# ---- the kernel choice ------------------------------------------------------

def _site_calls(mc, B: int):
    """(q shape, table shape, H, W, calls) of every site of one encoder pass
    of ``mc`` at batch B: per stage-layer one TSA site and one SCA site with
    the views folded into the batch (G >= 4) or one per view."""
    calls = []
    V, d = mc.num_views, mc.bev_depth_dim
    for s in range(mc.n_stages):
        H = W = mc.bev_shapes[s]
        G, heads = mc.n_groups[s], mc.n_heads[s]
        Hpg, ch = heads // G, mc.embed_dims[s] // heads
        layers = mc.depths[s]
        calls.append(((B, G, Hpg, H * W, ch), (G, Hpg, 2 * H - 1, 2 * W - 1),
                      H, W, layers))
        sca_b, per_layer = (B * V, 1) if G >= 4 else (B, V)
        calls.append(((sca_b, G, Hpg, H * W, ch),
                      (G, Hpg, 2 * H - 1, 2 * W * d - 1), H, W,
                      layers * per_layer))
    return calls


def _launches(mc, B: int, options, training: bool) -> dict:
    """Launches of a T=2 window: the history pass (eval) and the final pass
    (a training one when ``training``), summed over ``site_kernels``."""
    counts = collections.Counter()
    for q, t, H, W, n in _site_calls(mc, B):
        for final in (False, training):
            for name in tda.site_kernels(q, t, H, W, options, training=final):
                counts[name] += n
    return dict(counts)


FLAGSHIP = tcfg.flagship_config().model
PYRAMID = tcfg.Config().model
AUTO_SERVING = dict(fused_site=chip_smoke.FUSED_PER_FORWARD,
                    fused_site_mma=chip_smoke.MMA_PER_FORWARD)


@pytest.mark.parametrize("route,prefetch,want", [
    ("auto", False, AUTO_SERVING),
    ("auto", True, AUTO_SERVING),  # no flagship site is wide on "auto"
    ("wide", False, chip_smoke.WIDE_PER_FORWARD),
    ("wide", True, chip_smoke.WIDE_PREFETCH_PER_FORWARD)])
def test_flagship_serving_kernels(route, prefetch, want):
    """The flagship's serving forward (B=4, T=2) takes exactly the kernels
    whose launches chip_smoke's phases 3, 14 and 15 count on the card."""
    opts = tda.SiteOptions(lattice_route=route, site_prefetch=prefetch,
                           bias_forward="prefetch" if prefetch else "kernel")
    assert _launches(FLAGSHIP, chip_smoke.SERVE_B, opts, False) == want


@pytest.mark.parametrize("route,fused_bwd,remat", [
    ("auto", False, "nothing"), ("auto", False, "none"),
    ("auto", True, "nothing"), ("wide", True, "nothing")])
def test_flagship_training_kernels(route, fused_bwd, remat):
    """A flagship training step (B=2, T=2) takes the kernels that chip_smoke's
    phases 6, 7 and 16 count: on "wide" with ``fused_bwd`` the history
    pass's narrow sites take ``fused_site_wide`` and the final pass's its
    logsumexp instance, with ``fused_site_bwd`` as the backward."""
    opts = tda.SiteOptions(fused_bwd=fused_bwd, site_remat=remat,
                           lattice_route=route)
    want = (chip_smoke.WIDE_TRAIN_COUNTS if route == "wide"
            else chip_smoke.TRAIN_COUNTS[(fused_bwd, remat)])
    assert _launches(FLAGSHIP, chip_smoke.TRAIN_B, opts, True) == want


def test_flagship_training_prefetch_kernels():
    """Under "wide" the prefetch bias serves the training pass too (the JAX
    package's ``_fwd_call(dma=True)`` is shared by eval and training); its
    backward stays ``lattice_bias_wide_bwd``. ``site_prefetch`` reaches
    the eval fused site only."""
    opts = tda.SiteOptions(fused_bwd=True, lattice_route="wide",
                           site_prefetch=True, bias_forward="prefetch")
    want = dict(chip_smoke.WIDE_TRAIN_COUNTS)
    want["fused_site_wide_prefetch"] = want.pop("fused_site_wide")
    want["lattice_bias_wide_prefetch"] = want.pop("lattice_bias_wide")
    assert _launches(FLAGSHIP, chip_smoke.TRAIN_B, opts, True) == want


@pytest.mark.parametrize("prefetch,training,remat,want", [
    (False, False, "nothing", chip_smoke.PYR_PER_FORWARD),
    (True, False, "nothing", chip_smoke.PYR_PREFETCH_PER_FORWARD),
    (False, True, "nothing", chip_smoke.PYR_TRAIN_COUNTS["nothing"]),
    (False, True, "none", chip_smoke.PYR_TRAIN_COUNTS["none"])])
def test_pyramid_kernels(prefetch, training, remat, want):
    """The pyramid (B=2, T=2) on "auto": serving as chip_smoke's phases 10
    and 17 count (every eval site on ``fused_site_mma``, so
    ``bias_forward="prefetch"`` changes nothing there), training as phase
    11; ``fused_bwd`` changes nothing (head width 32)."""
    for fused_bwd in (False, True):
        opts = tda.SiteOptions(fused_bwd=fused_bwd, site_remat=remat,
                               bias_forward=("prefetch" if prefetch
                                             else "kernel"))
        assert _launches(PYRAMID, chip_smoke.PYR_B, opts, training) == want


@pytest.mark.parametrize("model,training,remat,want", [
    ("flagship", False, "nothing", chip_smoke.WINDOWS_PER_FORWARD),
    ("flagship", True, "nothing", chip_smoke.WINDOWS_TRAIN_COUNTS),
    ("flagship", True, "none", dict(fused_site=12, fused_site_mma=32,
                                    lattice_windows=44,
                                    lattice_windows_bwd=44)),
    ("pyramid", False, "nothing", chip_smoke.PYR_WINDOWS_PER_FORWARD)])
def test_windowed_bias_kernels(model, training, remat, want):
    """With ``bias_forward="windows"`` every site that took a bias kernel
    takes the window kernels, on either route, as chip_smoke's phases 23-25 count
    them: on "auto" the final training pass's 88 forward and 44 backward
    ones, where every eval site is fused (``fused_site``,
    ``fused_site_mma``); on "wide", where the wide heads take the bias in
    eval too, also the flagship's 64 eval launches a forward and the
    pyramid's 88 (its SCA at BEV 56 included); the fused sites stay."""
    mc, B = ((FLAGSHIP, chip_smoke.TRAIN_B if training else chip_smoke.SERVE_B)
             if model == "flagship" else (PYRAMID, chip_smoke.PYR_B))
    for route in tda.LATTICE_ROUTES:
        opts = tda.SiteOptions(site_remat=remat, bias_forward="windows",
                               lattice_route=route)
        got = _launches(mc, B, opts, training)
        if route == "wide":  # the fused sites take their wide kernels, the
            # wide heads the bias
            want = chip_smoke.renamed(want, dict(
                fused_site="fused_site_wide",
                fused_site_mma="lattice_windows"))
        assert got == want


def _shipped_sites():
    for mc in (FLAGSHIP, PYRAMID):
        for q, t, H, W, _ in _site_calls(mc, 2):
            yield q[-1], t, H, W


def test_site_route_at_shipped_and_oversized_tables():
    """Every shipped site's table fits ``fused_site``'s shared memory (the
    largest, the pyramid's SCA at BEV 56, too); a narrow-head table at BEV
    64 with depth 5 (127 x 639) does not, and takes the wide kernel."""
    sites = list(_shipped_sites())
    assert len(sites) == 28
    assert {tda.site_route(t, H, W, ch) for ch, t, H, W in sites} == {"whole"}
    wide = (1, 2, 127, 639)
    assert tda.site_route(wide, 64, 64, 4) == "wide"
    assert tda.site_route(wide, 64, 64, 8) == "wide"
    for route in ("auto", "wide"):
        opts = tda.SiteOptions(lattice_route=route)
        assert tda.site_kernels((1, 1, 2, 4096, 4), wide, 64, 64, opts,
                                training=False) == ("fused_site_wide",)


@pytest.mark.parametrize("route", ["auto", "wide"])
def test_fused_bwd_on_an_oversized_table_is_refused(route):
    """The site backward keeps the head's table and its float32 gradient in
    shared memory; where they do not fit, the fused backward refuses the
    site and ``fused_bwd`` trains it on the route it takes without
    ``fused_bwd``, the wide bias kernels with the plain consumer under
    ``site_remat``, on either route. Its eval pass stays on the fused
    site."""
    wide = (1, 2, 127, 639)
    assert not tda._site_bwd_fits(wide, 64, 4)
    want = {"nothing": ("lattice_bias_wide", "lattice_bias_wide",
                        "lattice_bias_wide_bwd"),
            "none": ("lattice_bias_wide", "lattice_bias_wide_bwd")}
    for remat, kernels_named in want.items():
        for fused_bwd in (True, False):
            opts = tda.SiteOptions(fused_bwd=fused_bwd, site_remat=remat,
                                   lattice_route=route)
            assert tda.site_kernels((1, 1, 2, 4096, 4), wide, 64, 64, opts,
                                    training=True) == kernels_named
    opts = tda.SiteOptions(fused_bwd=True, lattice_route=route)
    assert tda.site_kernels((1, 1, 2, 4096, 4), wide, 64, 64, opts,
                            training=False) == ("fused_site_wide",)


def test_fused_bwd_on_an_oversized_table_trains_as_without_it():
    """A training step of one site on that table (BEV 64, depth 5: 127 x
    639, head width 4) with ``fused_bwd``: on the CPU it runs the plain
    versions of the bias route and gives the gradients of the same step
    without ``fused_bwd``, exactly."""
    H = W = 64
    rng = np.random.default_rng(52)
    q, k, v = (_t(rng.standard_normal(s) * 0.5) for s in (
        (1, 1, 2, H * W, 4), (1, 1, 2, 24, 4), (1, 1, 2, 24, 4)))
    k_pos = _t(rng.uniform(-1.2, 1.2, (1, 1, 24, 2)))
    table = _t(rng.standard_normal((1, 2, 127, 639)) * 0.05)
    grads = []
    for fused_bwd in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, k_pos, table)]
        out = tda.streamed_deform_attention(
            *leaves, H, W, scale=0.5, fuse_site=False, fused_bwd=fused_bwd)
        grads.append(torch.autograd.grad((out * out).sum(), leaves))
    for name, a, b in zip(("dq", "dk", "dv", "dk_pos", "dtable"), *grads):
        assert float(b.abs().max()) > 0, name
        assert torch.equal(a, b), name


def test_site_options_are_checked():
    with pytest.raises(ValueError, match="lattice_route"):
        tda.SiteOptions(lattice_route="resolve")
    with pytest.raises(ValueError, match="site_remat"):
        tda.SiteOptions(site_remat="all")
    assert tda.SiteOptions(site_remat="dots").site_remat == "dots"


# ---- the config fields, end to end on the CPU -------------------------------

def _tiny(**route):
    cfg = tcfg.Config()
    cfg.model = tcfg.tiny_model_config(embed_dims=(32, 32, 32),
                                       n_heads=(2, 8), n_groups=(1, 4),
                                       **route)
    return cfg


def _sites(net):
    return [m for m in net.modules() if isinstance(m, _Site)]


def test_wide_route_renders_as_auto_on_the_cpu():
    """A tiny model (stage 0 of head width 16 on the bias, stage 1 of head
    width 4 with G = 4 on the fused site with the views folded)
    under ``lattice_route="wide"`` with both prefetches renders what the
    "auto" route renders: on CPU tensors every kernel is its plain
    version. The fields reach every site of the pipeline's model, and no
    kernel launches."""
    batch = SyntheticDataset(n_items=2, num_views=2, window_num_imgs=1,
                             img_height=32, img_width=32, seed=3).batch(2)
    before = kernels.counts()
    auto = RegistrationPipeline(_tiny(), device="cpu", seed=1)
    wide = RegistrationPipeline(
        _tiny(lattice_route="wide", site_prefetch=True,
              bias_forward="prefetch"),
        device="cpu", seed=1)
    assert torch.equal(wide.render(batch), auto.render(batch))
    sites = _sites(wide.net)
    assert len(sites) == 4  # 2 stages x (TSA, SCA)
    assert {s.site_options for s in sites} == {tda.SiteOptions(
        lattice_route="wide", site_prefetch=True, bias_forward="prefetch")}
    assert {s.site_options for s in _sites(auto.net)} == {tda.SiteOptions()}
    assert kernels.counts() == before


def test_trainer_hands_every_option_to_every_site(tmp_path):
    """``Trainer.create_state`` sets the training pass's fields and the
    route fields on every site; ``set_site_options`` keeps the fields it is
    not given."""
    from bevrender_tpu_torch.training.trainer import Trainer

    cfg = _tiny(lattice_route="wide", bias_forward="prefetch")
    cfg.train.fused_bwd, cfg.train.site_remat = True, "none"
    cfg.train.work_dir = str(tmp_path)
    ds = SyntheticDataset(n_items=2, num_views=2, window_num_imgs=1,
                          img_height=32, img_width=32, map_tile=32)
    net = Trainer(cfg, ds, device="cpu").create_state(seed=0).net
    want = tda.SiteOptions(fused_bwd=True, site_remat="none",
                           lattice_route="wide", bias_forward="prefetch")
    assert {s.site_options for s in _sites(net)} == {want}
    set_site_options(net, site_prefetch=True)
    assert {s.site_options for s in _sites(net)} == {
        tda.SiteOptions(fused_bwd=True, site_remat="none",
                        lattice_route="wide", site_prefetch=True,
                        bias_forward="prefetch")}


# ---- the wrappers refuse what their kernels do not take ---------------------

def _cpu_args(ch=4, H=8, Wt=15, N=10):
    rng = np.random.default_rng(50)
    table = _t(rng.standard_normal((1, 2, 2 * H - 1, Wt)))
    k_pos = _t(rng.uniform(-1.2, 1.2, (1, 1, N, 2)))
    geo = tda._kernel_args(table, k_pos, H, H)[:7]
    qkv = [_t(rng.standard_normal(s)).bfloat16()
           for s in ((1, 1, 2, H * H, ch), (1, 1, 2, N, ch), (1, 1, 2, N, ch))]
    return geo, qkv


@pytest.mark.parametrize("which", ["wide", "wide_lse", "wide_prefetch"])
def test_wide_site_wrappers_refuse_bad_inputs(which):
    """CPU tensors, a head width without an instance, a float32 table and
    int64 window starts are refused before anything touches the card."""
    call = getattr(fused_site_wide, f"fused_site_{which}_cuda")
    geo, qkv = _cpu_args()
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(*geo, *qkv, 8, 8, 0.5)
    geo3, qkv3 = _cpu_args(ch=3)
    with pytest.raises(ValueError, match="head widths"):
        call(*geo3, *qkv3, 8, 8, 0.5)
    meta = torch.device("meta")
    m = [t.to(meta) for t in geo]
    mq = [t.to(meta) for t in qkv]
    with pytest.raises(TypeError, match="table"):
        call(m[0].float(), *m[1:], *mq, 8, 8, 0.5)
    with pytest.raises(TypeError, match="ys"):
        call(m[0], m[1].long(), *m[2:], *mq, 8, 8, 0.5)


def test_prefetch_bias_wrapper_refuses_bad_inputs():
    geo, _ = _cpu_args()
    call = lattice_bias.lattice_bias_wide_prefetch_cuda
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(*geo, 8, 8)
    m = [t.to(torch.device("meta")) for t in geo]
    with pytest.raises(TypeError, match="table"):
        call(m[0].float(), *m[1:], 8, 8)
    with pytest.raises(ValueError, match="table"):
        call(*m, 7, 7)


def test_prefetch_rings_are_sized_from_the_shapes():
    """Each prefetch kernel's staging comes from the shapes: at the
    flagship's SCA (55 x 279, W = 28) the fused site's ring stage is 32 keys
    x 7 rows x 152 columns, and the bias stages one head's padded table of
    63 x 287 bf16 a block (``lattice_bias.fwd_plan``, path "whole"; it may
    start up to 7 entries in, and is rounded up to 16 bytes); at the
    pyramid's SCA 56 (111 x 559) the bias's table is 119 x 567. A bias
    table whose padded head overflows a block takes path "l1" (no shared
    memory); a fused-site table whose ring
    overflows shared memory, and a bias of W over 64, are refused with the
    numbers."""
    R, CW, Xs, smem = fused_site_wide.prefetch_ring(55, 279, 28, 28, 8)
    assert (R, CW, smem) == (7, 152, 2 * 32 * 7 * 152 * 2 + 32 * 19 * 4)
    assert Xs % 8 == 0 and Xs >= 279 + 4 + 146
    p = lattice_bias.fwd_plan(4, 2, 2, 55, 279, 1960, 28, 28, 132,
                              "lattice_bias_wide_prefetch")
    assert (p.path, p.pitch, p.smem) == (
        "whole", 287, -(-(63 * 287 * 2 + 14) // 16) * 16)
    p = lattice_bias.fwd_plan(2, 1, 2, 111, 559, 7840, 56, 56, 132,
                              "lattice_bias_wide_prefetch")
    assert (p.path, p.pitch, p.smem) == (
        "whole", 567, -(-(119 * 567 * 2 + 14) // 16) * 16)
    p = lattice_bias.fwd_plan(2, 1, 2, 111, 1119, 200, 56, 56, 132,
                              "lattice_bias_wide_prefetch")
    assert (p.path, p.pitch, p.smem) == ("l1", 0, 0)
    with pytest.raises(ValueError, match="shared memory"):
        fused_site_wide.prefetch_ring(399, 1999, 200, 200, 4)
    with pytest.raises(ValueError, match="1 to 64"):
        lattice_bias.fwd_plan(1, 1, 2, 399, 1999, 10, 200, 200, 132,
                              "lattice_bias_wide_prefetch")


# ---- the prefetch site's two paths ------------------------------------------

# (Ht, Wt, H = W, ch, path, shared-memory bytes): the flagship's TSA (55 x 55)
# and SCA (55 x 279) at ch 4 and 8; FOLD_RING_SITE's table (BEV 60,
# 119 x 299), too large for two heads a block but whole at one;
# BEV 64 at depth 5 (127 x 639), whose one head overflows a block (135 x 969
# padded) while its window ring (4 rows x 336 columns a key) fits.
PREFETCH_PLANS = [
    (55, 55, 28, 4, "whole", 2 * (2 * 32 * 4 * 2 + 512) + 63 * 93 * 2),
    (55, 55, 28, 8, "whole", 2 * (2 * 32 * 8 * 2 + 512) + 63 * 93 * 2),
    (55, 279, 28, 4, "whole", 2 * (2 * 32 * 4 * 2 + 512) + 63 * 429 * 2),
    (55, 279, 28, 8, "whole", 57126),
    (119, 299, 60, 8, "whole", 119658),
    (127, 639, 64, 4, "ring", 2 * 32 * 4 * 336 * 2 + 32 * 11 * 4),
    (127, 639, 64, 8, "ring", 174464)]


@pytest.mark.parametrize("Ht,Wt,H,ch,path,smem", PREFETCH_PLANS)
def test_prefetch_plan_follows_the_shapes(Ht, Wt, H, ch, path, smem):
    """``fused_site_wide_prefetch`` takes its whole-table path wherever one
    head's padded table and two key stages (K and V rows in bf16, four
    words of geometry a key) fit one block, in the strips of at most
    WHOLE_THREADS queries (one head a block) of ``fused_site_wide``'s plan
    of that path, and its window ring where not; the shared memory is each
    kernel's layout."""
    heads = 2 * 4 * 2  # B = 2, G = 4, two heads a group
    got, S, threads, need = fused_site_wide.prefetch_plan(Ht, Wt, H, H, ch,
                                                          heads, 132)
    assert (got, need) == (path, smem)
    assert threads == S and S % 32 == 0 and S <= 256
    whole = (2 * (2 * 32 * ch * 2 + 4 * 32 * 4)
             + (Ht + 2 * 4) * tda.padded_width(Wt) * 2)
    assert whole == kernels.fused_site_fold.whole_smem(1, Ht,
                                                      tda.padded_width(Wt), ch)
    if path == "whole":
        assert need == whole <= fused_site_wide.SMEM_PER_BLOCK
        assert S == kernels.fused_site_fold.wave_strip(
            1, H * H, heads, 4, 132, fused_site_wide.WHOLE_THREADS)
        assert S <= fused_site_wide.WHOLE_THREADS
        assert fused_site_wide.wide_plan(Ht, Wt, H, H, ch, heads, 132)[
            :5] == ("whole", 1, S, S, need)
    else:
        assert whole > fused_site_wide.SMEM_PER_BLOCK
        assert (S, need) == (128, fused_site_wide.prefetch_ring(
            Ht, Wt, H, H, ch)[3])


def test_flagship_prefetch_sites_take_the_whole_path():
    """Every site that the flagship's wide + prefetch request (phase 15)
    sends to ``fused_site_wide_prefetch`` takes its whole-table path, in 5
    strips of 160 of the 784 queries, but the TSA of G = 4 (32 heads of
    784 queries: 7 strips of 128, ``wave_strip``)."""
    opts = tda.SiteOptions(lattice_route="wide", site_prefetch=True,
                           bias_forward="prefetch")
    launches = 0
    for q, t, H, W, n in _site_calls(FLAGSHIP, chip_smoke.SERVE_B):
        if tda.site_kernels(q, t, H, W, opts,
                            training=False) == ("fused_site_wide_prefetch",):
            launches += 2 * n  # the history and the final pass
            heads = q[0] * t[0] * t[1]
            assert fused_site_wide.prefetch_plan(
                t[2], t[3], H, W, q[-1], heads, 132)[:2] == (
                    "whole", 128 if heads == 32 else 160)
    assert launches == chip_smoke.WIDE_PREFETCH_PER_FORWARD[
        "fused_site_wide_prefetch"]


@pytest.mark.parametrize("site", chip_smoke.SITE_SITES
                         + [chip_smoke.PREFETCH_RING_SITE[:-1]],
                         ids=lambda s: s[0])
def test_chip_smoke_prefetch_sites_take_the_paths_it_expects(site):
    """chip_smoke's phase 18 fails unless every serving shape takes the
    whole-table path and PREFETCH_RING_SITE the ring; the ring site's table
    is also too large for ``fused_site``, which the phase so leaves out
    there."""
    name, B, G, ch, N, Wt, _ = site
    ring = name == chip_smoke.PREFETCH_RING_SITE[0]
    side = chip_smoke.PREFETCH_RING_SITE[-1] if ring else chip_smoke.H
    Ht = 2 * side - 1
    path = fused_site_wide.prefetch_plan(Ht, Wt, side, side, ch,
                                         B * G * chip_smoke.HPG, 132)[0]
    assert path == ("ring" if ring else "whole")
    table_shape = (G, chip_smoke.HPG, Ht, Wt)
    assert tda.site_route(table_shape, side, side, ch) == (
        "wide" if ring else "whole")


def test_prefetch_plan_refuses_a_site_that_fits_neither_path():
    """A head of BEV 200 at depth 5 (399 x 1999) overflows a block whole
    and in the ring: refused with the ring's numbers, never sent to another
    kernel."""
    assert kernels.fused_site_fold.whole_smem(
        1, 399, tda.padded_width(1999), 4) > fused_site_wide.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match=r"2 x 32 keys x 3 rows x 1016 "
                       r"columns needs 391552 bytes of shared memory, over "
                       r"232448"):
        fused_site_wide.prefetch_plan(399, 1999, 200, 200, 4, 2, 132)


# ---- the wide site's plan and the strip rule ---------------------------------

# (name, batch, G, ch, BEV side, table width, path, strip, shared memory,
# blocks, waves) of ``fused_site_wide`` on a 132-SM card: chip_smoke's
# serving and training shapes (phases 14 and 16, two heads a group), its
# PREFETCH_RING_SITE, and a head of BEV 200 at depth 5 (399 x 1999), which
# #10 refuses; the stages are 2 x (2 x 32 ch x 2 + 512) bytes, a padded
# table 63 x 93 (TSA) or 63 x 429 (SCA) bf16.
WIDE_PLANS = [
    ("serve_tsa_g4_ch8", 4, 4, 8, 28, 55, "whole", 128, 3072 + 11718, 224, 1),
    ("serve_tsa_g8_ch4", 4, 8, 4, 28, 55, "whole", 160, 2048 + 11718, 320, 1),
    ("serve_sca_g4_ch8", 12, 4, 8, 28, 279, "whole", 160, 57126, 480, 1),
    ("serve_sca_g8_ch4", 12, 8, 4, 28, 279, "whole", 160, 56102, 960, 2),
    ("train_tsa_g4_ch8", 2, 4, 8, 28, 55, "whole", 128, 14790, 112, 1),
    ("train_tsa_g8_ch4", 2, 8, 4, 28, 55, "whole", 128, 13766, 224, 1),
    ("train_sca_g4_ch8", 6, 4, 8, 28, 279, "whole", 160, 57126, 240, 1),
    ("train_sca_g8_ch4", 6, 8, 4, 28, 279, "whole", 160, 56102, 480, 1),
    ("ring_bev64_g4_ch8", 2, 4, 8, 64, 639, "raw", 128, 3072, 512, 1),
    ("bev200_g1_ch4", 1, 1, 4, 200, 1999, "raw", 160, 2048, 500, 1)]


@pytest.mark.parametrize("name,B,G,ch,side,Wt,path,S,smem,blocks,waves",
                         WIDE_PLANS, ids=[p[0] for p in WIDE_PLANS])
def test_wide_plan_follows_the_shapes(name, B, G, ch, side, Wt, path, S,
                                      smem, blocks, waves):
    """``fused_site_wide`` stages the head's padded table ("whole") wherever
    it fits one block with the key stages, every shipped site, and reads
    the raw table ("raw", the key stages alone) where it does not, so any
    table launches; one head a block in the strip ``wave_strip`` gives,
    four blocks an SM counted on."""
    heads = B * G * chip_smoke.HPG
    plan = fused_site_wide.wide_plan(2 * side - 1, Wt, side, side, ch, heads,
                                     132)
    assert (plan.path, plan.strip, plan.smem, plan.blocks, plan.waves) == (
        path, S, smem, blocks, waves)
    assert plan.heads == 1 and plan.threads == S and plan.per_sm == 4
    whole = kernels.fused_site_fold.whole_smem(1, 2 * side - 1,
                                               tda.padded_width(Wt), ch)
    assert (whole <= fused_site_wide.SMEM_PER_BLOCK) == (path == "whole")
    assert plan.strip == kernels.fused_site_fold.wave_strip(
        1, side * side, heads, 4, 132, fused_site_wide.WIDE_THREADS)
    forced = fused_site_wide.wide_plan(2 * side - 1, Wt, side, side, ch,
                                       heads, 132, "raw")
    assert forced.path == "raw" and forced.smem == 2 * (
        2 * 32 * ch * 2 + 512)
    with pytest.raises(ValueError, match="path"):
        fused_site_wide.wide_plan(2 * side - 1, Wt, side, side, ch, heads,
                                  132, "l1")


def test_chip_smoke_wide_sites_take_the_paths_it_expects():
    """chip_smoke's phase 18 fails unless ``fused_site_wide`` (and its
    logsumexp instance) takes path "whole" at every serving and training
    shape and "raw" at PREFETCH_RING_SITE, whose table ``fused_site``
    leaves to it; every flagship site that the wide route (phases 14, 16)
    sends to either takes "whole"."""
    H = chip_smoke.H
    for name, B, G, ch, N, Wt, _ in (chip_smoke.SITE_SITES
                                     + chip_smoke.TRAIN_SITE_SITES):
        assert fused_site_wide.wide_plan(2 * H - 1, Wt, H, H, ch,
                                         B * G * 2, 132).path == "whole"
    _, B, G, ch, N, Wt, _, side = chip_smoke.PREFETCH_RING_SITE
    assert fused_site_wide.wide_plan(2 * side - 1, Wt, side, side, ch,
                                     B * G * 2, 132).path == "raw"
    seen = 0
    for training, B in ((False, chip_smoke.SERVE_B),
                        (True, chip_smoke.TRAIN_B)):
        opts = tda.SiteOptions(lattice_route="wide", fused_bwd=training)
        for q, t, H, W, _ in _site_calls(FLAGSHIP, B):
            kernel = tda.site_kernels(q, t, H, W, opts, training=training)[0]
            if kernel.startswith("fused_site_wide"):
                seen += 1
                assert fused_site_wide.wide_plan(
                    t[2], t[3], H, W, q[-1], q[0] * t[0] * t[1],
                    132).path == "whole"
    assert seen == 12  # stages 2-4, a TSA and an SCA site each, twice


# (heads a block, M, block rows, blocks an SM, SMs, threads at most, strip):
# one head a block at the flagship's SCA serving (one wave of 5 strips) and
# with 192 rows (two waves), at its TSA (7 strips of 128: the busiest SM 8
# warps against 10), on a 114-SM card (two waves either way: 7 strips of
# 128, the busiest SM 24 warps over both, against 25 for 160); two heads a
# block at the training SCA's 24 rows (80: 240 blocks in one wave, the busiest SM 10
# warps against 14) and 96 rows (112: 3 waves, where 80 took 4);
# PREFETCH_RING_SITE's 4096 queries of 16 heads (32 strips of 128, 512
# blocks in one wave); a grid far under a wave (BEV 7, 8 rows: two strips
# of 32, the busiest SM one warp against two).
STRIPS = [(1, 784, 96, 4, 132, 160, 160), (1, 784, 192, 4, 132, 160, 160),
          (1, 784, 32, 4, 132, 160, 128), (1, 784, 96, 4, 114, 160, 128),
          (2, 784, 24, 2, 132, 256, 80), (2, 784, 96, 2, 132, 256, 112),
          (1, 4096, 16, 4, 132, 160, 128), (1, 49, 8, 4, 132, 160, 32)]


@pytest.mark.parametrize("heads,M,rows,per_sm,sms,most,want", STRIPS)
def test_wave_strip_fills_whole_waves(heads, M, rows, per_sm, sms, most,
                                      want):
    """The strip takes the fewest waves any strip of at most ``most``
    threads can (those of the largest), and among those the least load on
    the busiest SM; its threads are a multiple of 32 and its strips cover
    the queries as evenly as that allows."""
    fold = kernels.fused_site_fold
    S = fold.wave_strip(heads, M, rows, per_sm, sms, most)
    assert S == want
    assert (heads * S) % 32 == 0 and heads * S <= most
    slots = per_sm * sms
    waves = -(-(-(-M // S) * rows) // slots)
    largest = most // heads
    assert waves == -(-(-(-M // largest) * rows) // slots)
    strips = -(-M // S)
    assert S - (-(-M // strips)) < 32 // heads  # no strip a step too wide


def test_chip_smoke_reads_whole_table_launches_by_launch_bounds():
    """The whole-table paths of ``fused_site_wide_prefetch`` and
    ``fused_site_fold_heads`` launch one instance kernel of
    csrc/site_whole.cuh: chip_smoke tells their launches apart in the
    profiler's names by the launch bounds each source gives its instances,
    which these are; ``fused_site_wide`` and ``fused_site_fold_rows`` run
    the template in kernels of their own names."""
    csrc = ROOT / "bevrender_tpu_torch" / "ops" / "kernels" / "csrc"
    pre = (csrc / "fused_site_wide_prefetch.cu").read_text()
    assert fused_site_wide.WHOLE_THREADS == 160
    assert "constexpr int WHOLE_THREADS = 160;" in pre
    assert "constexpr int WHOLE_MIN_BLOCKS = 4;" in pre
    fold = (csrc / "fused_site_fold_heads.cu").read_text()
    assert "constexpr int MAX_THREADS = 256;" in fold
    assert "site_whole::launch<C, P, MAX_THREADS, 2>" in fold
    Event = collections.namedtuple("Event", "key count")
    avgs = [
        Event("void site_whole::fused_site_whole_kernel<8, 1, 160, 4>(", 16),
        Event("void site_whole::fused_site_whole_kernel<4, 2, 256, 2>(", 8),
        Event("void (anonymous namespace)::fused_site_wide_prefetch_kernel<8>(",
              2),
        Event("void (anonymous namespace)::fused_site_wide_kernel<8, 0>(", 4),
        Event("void (anonymous namespace)::fused_site_fold_rows_kernel<4>(",
              6),
        Event("void (anonymous namespace)::lattice_bias_wide_kernel<8>(", 64)]
    assert chip_smoke.seen_launches(avgs, "fused_site_wide_prefetch") == 18
    assert chip_smoke.seen_launches(avgs, "fused_site_fold_heads") == 8
    assert chip_smoke.seen_launches(avgs, "fused_site_wide") == 4
    assert chip_smoke.seen_launches(avgs, "fused_site_fold_rows") == 6
    assert chip_smoke.seen_launches(avgs, "lattice_bias_wide") == 64
    for name in ("fused_site_wide.cu", "fused_site_fold_rows.cu"):
        assert name[:-3] + "_kernel(" in (csrc / name).read_text()


# ---- fused_site's plan and route (csrc/fused_site.cu on site_whole.cuh) ----

# (batch, G, ch, table width) -> (strip, blocks, waves) of ``fused_site`` and
# its logsumexp instance on a 132-SM card at chip_smoke's serving and
# training shapes (BEV 28, two heads a group): one head a block, four
# blocks an SM; at the serving SCA G=4, 5 strips of 160 queries, 480
# blocks in one wave
SITE_PLANS = {(4, 4, 8, 55): (128, 224, 1), (4, 8, 4, 55): (160, 320, 1),
              (12, 4, 8, 279): (160, 480, 1), (12, 8, 4, 279): (160, 960, 2),
              (2, 4, 8, 55): (128, 112, 1), (2, 8, 4, 55): (128, 224, 1),
              (6, 4, 8, 279): (160, 240, 1), (6, 8, 4, 279): (160, 480, 1)}


@pytest.mark.parametrize(
    "site", chip_smoke.SITE_SITES + chip_smoke.TRAIN_SITE_SITES,
    ids=[f"serve_{s[0]}" for s in chip_smoke.SITE_SITES]
    + [f"train_{s[0]}" for s in chip_smoke.TRAIN_SITE_SITES])
def test_site_plan_follows_the_shapes(site):
    """``fused_site`` stages one head's padded table a block, at most 160
    threads (a multiple of 32) and the shared memory of ``whole_smem`` at
    one head, in the strips ``wave_strip`` gives: the plan of the template's
    other one-head instance on its staged path (``wide_plan``, "whole")."""
    name, B, G, ch, N, Wt, _ = site
    H, Hpg = chip_smoke.H, chip_smoke.HPG
    Ht, Xp = 2 * H - 1, tda.padded_width(Wt)
    plan = fused_site.site_plan(B, G, Hpg, Ht, Xp, H, H, ch, 132)
    assert (plan.strip, plan.blocks, plan.waves) == SITE_PLANS[(B, G, ch, Wt)]
    assert plan.path == "whole" and plan.heads == 1 and plan.per_sm == 4
    assert plan.threads == plan.strip and plan.threads % 32 == 0
    assert plan.threads <= fused_site.SITE_THREADS == 160
    fold = kernels.fused_site_fold
    assert plan.smem == fold.whole_smem(1, Ht, Xp, ch)
    assert plan.smem <= fused_site.SMEM_PER_BLOCK
    assert plan.strip == fold.wave_strip(1, H * H, B * G * Hpg, 4, 132, 160)
    assert plan.blocks == -(-(H * H) // plan.strip) * B * G * Hpg
    assert plan == fused_site_wide.wide_plan(Ht, Wt, H, H, ch, B * G * Hpg,
                                             132)


def test_fused_site_is_an_instance_of_the_template():
    """csrc/fused_site.cu launches ``site_whole::site_block`` at one head a
    block on the staged table, under launch bounds (160, 4) that
    ``site_plan`` counts on, in a kernel still named ``fused_site_kernel``
    for both instances: chip_smoke counts its launches by that name, apart
    from the other instances' kernels."""
    src = (ROOT / "bevrender_tpu_torch" / "ops" / "kernels" / "csrc"
           / "fused_site.cu").read_text()
    assert '#include "site_whole.cuh"' in src
    assert "site_whole::site_block<CH, 1, site_whole::WHOLE>" in src
    assert "constexpr int THREADS = 160;" in src
    assert "constexpr int MIN_BLOCKS = 4;" in src
    assert "fused_site_kernel(SITE_WHOLE_PARAMS)" in src
    assert src.count("launch_kernel<") == 2  # one launch a head width
    assert "stage_kv" not in src and "float* sk" not in src
    assert (fused_site.SITE_THREADS, fused_site.SITE_MIN_BLOCKS) == (160, 4)
    Event = collections.namedtuple("Event", "key count")
    avgs = [
        Event("void (anonymous namespace)::fused_site_kernel<8>(", 12),
        Event("void (anonymous namespace)::fused_site_kernel<4>(", 6),
        Event("void (anonymous namespace)::fused_site_wide_kernel<8, 0>(", 4),
        Event("void (anonymous namespace)::fused_site_fold_rows_kernel<8>(",
              2)]
    assert chip_smoke.seen_launches(avgs, "fused_site") == 18
    assert chip_smoke.seen_launches(avgs, "fused_site_wide") == 4
    assert chip_smoke.seen_launches(avgs, "fused_site_fold_rows") == 2


def test_site_plan_refuses_a_table_over_a_block():
    """A head of BEV 64 at depth 5 (127 x 639) overflows a block: the plan
    raises and names the kernel that takes such a site, never launching."""
    with pytest.raises(ValueError, match="takes fused_site_wide"):
        fused_site.site_plan(1, 1, 2, 127, tda.padded_width(639), 64, 64, 4,
                             132)


def test_site_route_is_the_template_fit():
    """``site_route`` sends a narrow-head site to ``fused_site`` exactly
    where ``site_plan`` launches it (``whole_smem`` at one head within a
    block): every shipped site, and never a table of BEV 64 at depth 5."""
    fold = kernels.fused_site_fold
    sites = list(_shipped_sites()) + [(4, (1, 2, 127, 639), 64, 64),
                                      (8, (1, 2, 127, 639), 64, 64)]
    for ch, t, H, W in sites:
        fits = fold.whole_smem(1, t[2], tda.padded_width(t[3]),
                               ch) <= fused_site.SMEM_PER_BLOCK
        assert tda.site_route(t, H, W, ch) == ("whole" if fits else "wide")
    assert [tda.site_route(t, H, W, ch) for ch, t, H, W in sites].count(
        "whole") == 28


# (ch, BEV side, table width): a table whose padded rows and the float32
# key tile of the kernel before the template fit a block while the
# template's key stages, 640 bytes more, do not
MARGIN_TABLES = [(4, 32, 1075), (8, 32, 1071)]


@pytest.mark.parametrize("ch,H,Wt", MARGIN_TABLES)
def test_a_table_inside_the_margin_takes_the_wide_site(ch, H, Wt):
    """Such a table takes ``fused_site_wide`` on its path "raw" by the
    shapes alone, on either route, without raising; ``fused_site``'s plan
    refuses it."""
    Ht, Xp = 2 * H - 1, tda.padded_width(Wt)
    old = (Ht + 2 * tda.PAD) * Xp * 2 + fused_site.KEY_TILE * (2 * ch + 3) * 4
    new = kernels.fused_site_fold.whole_smem(1, Ht, Xp, ch)
    assert new - old == 640
    assert old <= fused_site.SMEM_PER_BLOCK < new
    table = (1, 2, Ht, Wt)
    assert tda.site_route(table, H, H, ch) == "wide"
    for route in ("auto", "wide"):
        opts = tda.SiteOptions(lattice_route=route)
        assert tda.site_kernels((1, 1, 2, H * H, ch), table, H, H, opts,
                                training=False) == ("fused_site_wide",)
    assert fused_site_wide.wide_plan(Ht, Wt, H, H, ch, 2, 132).path == "raw"
    with pytest.raises(ValueError, match="takes fused_site_wide"):
        fused_site.site_plan(1, 1, 2, Ht, Xp, H, H, ch, 132)
