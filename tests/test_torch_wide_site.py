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
from bevrender_tpu_torch.ops.kernels import fused_site_wide, lattice_bias

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
                    lattice_bias=chip_smoke.BIAS_PER_FORWARD)


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
    and 17 count (``bias_forward="prefetch"`` moves its SCA at BEV 56 to
    the prefetch bias), training as phase 11; ``fused_bwd`` changes nothing (head
    width 32)."""
    for fused_bwd in (False, True):
        opts = tda.SiteOptions(fused_bwd=fused_bwd, site_remat=remat,
                               bias_forward=("prefetch" if prefetch
                                             else "kernel"))
        assert _launches(PYRAMID, chip_smoke.PYR_B, opts, training) == want


@pytest.mark.parametrize("model,training,remat,want", [
    ("flagship", False, "nothing", chip_smoke.WINDOWS_PER_FORWARD),
    ("flagship", True, "nothing", chip_smoke.WINDOWS_TRAIN_COUNTS),
    ("flagship", True, "none", dict(fused_site=12, lattice_windows=32 + 44,
                                    lattice_windows_bwd=44)),
    ("pyramid", False, "nothing", chip_smoke.PYR_WINDOWS_PER_FORWARD)])
def test_windowed_bias_kernels(model, training, remat, want):
    """With ``bias_forward="windows"`` every site that took a bias kernel
    takes the window kernels, on either route, as chip_smoke's phases 23-25 count
    them: the flagship's 64 bias launches per forward and its training
    step's 120 forward and 44 backward ones, the pyramid's 88 per forward
    (its SCA at BEV 56 included); the fused sites stay."""
    mc, B = ((FLAGSHIP, chip_smoke.TRAIN_B if training else chip_smoke.SERVE_B)
             if model == "flagship" else (PYRAMID, chip_smoke.PYR_B))
    for route in tda.LATTICE_ROUTES:
        opts = tda.SiteOptions(site_remat=remat, bias_forward="windows",
                               lattice_route=route)
        got = _launches(mc, B, opts, training)
        if route == "wide":  # the fused sites take their wide kernels
            want = {("fused_site_wide" if k == "fused_site" else k): v
                    for k, v in want.items()}
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
        tda.SiteOptions(site_remat="dots")


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
    """Each prefetch kernel's ring comes from the shapes: at the flagship's
    SCA (55 x 279, W = 28) the fused site's stage is 32 keys x 7 rows x 152
    columns and the bias takes 3 keys a stage (98 vectors of 8 outputs
    each); at the pyramid's SCA 56 (111 x 559) one key of 57 x 296 a stage.
    A table whose rings overflow shared memory is refused with the
    numbers."""
    R, CW, Xs, smem = fused_site_wide.prefetch_ring(55, 279, 28, 28, 8)
    assert (R, CW, smem) == (7, 152, 2 * 32 * 7 * 152 * 2 + 32 * 19 * 4)
    assert Xs % 8 == 0 and Xs >= 279 + 4 + 146
    assert lattice_bias.bias_ring(279, 28, 28)[:2] == (3, 152)
    KS, CW, Xs, smem = lattice_bias.bias_ring(559, 56, 56)
    assert (KS, CW, smem) == (1, 296, 2 * 57 * 296 * 2)
    assert lattice_bias.bias_ring(13, 7, 7)[0] == 6  # M = 49, one output each
    with pytest.raises(ValueError, match="shared memory"):
        fused_site_wide.prefetch_ring(399, 1999, 200, 200, 4)
    with pytest.raises(ValueError, match="shared memory"):
        lattice_bias.bias_ring(1999, 200, 200)
