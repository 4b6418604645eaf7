"""The order of sums of the bias backward kernels, on the CPU.

``lattice_bias_bwd.cu`` and ``lattice_bias_wide_bwd.cu`` are instances of
one row-owned template with no float atomic (csrc/bias_bwd_rows.cuh); the
card tests hold their dtable bit for bit to ``lattice_bias_bwd_ordered``,
which repeats the template's order of float32 sums in PyTorch. Here that
mirror is held against autograd through the plain bias and against the JAX
package's Pallas VJP (interpret mode, as its own tests run it), and the
launch ``plan`` against the shapes the models give it. Inputs are made with
numpy from a seed.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_bias_bwd.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevrender_tpu.ops import deform_attn as jda
from bevrender_tpu_torch.ops import deform_attn as tda
from bevrender_tpu_torch.ops.kernels import lattice_bias_bwd as lbb
from bevrender_tpu_torch.ops.kernels._launch import PAD, SMEM_PER_BLOCK

# the mirror against autograd through the plain bias (float32 lerps on the
# bf16 table): the same float32 arithmetic summed in another order, as a
# share of each gradient's largest entry (chip_smoke's BWD_SUM_TOL)
BWD_SUM_TOL = 2e-5
# table gradient against a Pallas backward kernel, which rounds the gradient
# of its staged table to bf16 before the un-staging sums up to W staged
# entries into one table entry (test_torch_grads.py's PALLAS_DTABLE_REL)
PALLAS_DTABLE_REL = 1.5e-2
H100_SMS = 132


def _inputs(seed, B, G, Hpg, H, Wt, N, pos=1.3, table_std=0.5):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((G, Hpg, 2 * H - 1, Wt)) * table_std
    k_pos = rng.uniform(-pos, pos, (B, G, N, 2))
    gout = rng.standard_normal((B, G, Hpg, N, H * H))
    return (torch.from_numpy(table.astype(np.float32)).bfloat16(),
            torch.from_numpy(k_pos.astype(np.float32)),
            torch.from_numpy(gout.astype(np.float32)).bfloat16())


def _mirror(table, k_pos, gout, H, sms=H100_SMS):
    """The mirror's (dtable, dk_pos) under the plan of ``sms`` SMs; dk_pos
    from its dwy, df through the geometry, as the kernels' autograd
    function hands them on."""
    G, Hpg, Ht, Wt = table.shape
    B, _, N, _ = k_pos.shape
    args = tda._geometry_args(table, k_pos, H, H)
    p = lbb.plan(B, G, Hpg, Ht, Wt, N, H, H, sms)
    dt, dwy, df = lbb.lattice_bias_bwd_ordered(table, *args, gout, H, H, p)
    kp = k_pos.clone().requires_grad_()
    _, _, wy, f = tda.lattice_geometry(table.shape, kp, H, H)
    (dp,) = torch.autograd.grad((wy, f), kp, (dwy, df))
    return dt, dp, p


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# (B, G, Hpg, H, Wt, N, k_pos range, SMs of the plan): TSA (column step
# exactly 1), SCA (step 2.5 and 5), clipped windows (keys far past the
# table), BEV 7 (M = 49), W = 33 (two rounds of lanes), and the flagship's
# SCA table (two bands of rows); few SMs give longer runs, many give more
MIRROR_CASES = {
    "tsa_step1": (2, 2, 2, 8, 15, 40, 1.3, H100_SMS),
    "sca_step2.5": (2, 2, 2, 8, 43, 40, 1.3, 4),
    "clipped": (2, 1, 2, 8, 43, 48, 2.5, H100_SMS),
    "bev7": (1, 2, 2, 7, 13, 30, 1.3, H100_SMS),
    "bev7_sca": (2, 1, 2, 7, 27, 24, 1.3, 2),
    "w33": (1, 1, 2, 33, 65, 20, 1.3, H100_SMS),
    "flagship_sca_bands": (1, 1, 2, 28, 279, 24, 1.3, H100_SMS),
}


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_ordered_mirror_matches_autograd(case):
    B, G, Hpg, H, Wt, N, pos, sms = MIRROR_CASES[case]
    table, k_pos, gout = _inputs(3, B, G, Hpg, H, Wt, N, pos)
    dt, dp, p = _mirror(table, k_pos, gout, H, sms)
    tb = table.float().requires_grad_()
    kp = k_pos.clone().requires_grad_()
    ref = tda.lattice_bias_plain(tb, kp, H, H, torch.float32)
    rdt, rdp = torch.autograd.grad(ref, (tb, kp), gout.float())
    assert dt.dtype == torch.float32 and dt.shape == table.shape
    assert float(rdt.abs().max()) > 0 and float(rdp.abs().max()) > 0
    assert _rel(dt, rdt) <= BWD_SUM_TOL, (case, p)
    assert _rel(dp, rdp) <= BWD_SUM_TOL, (case, p)
    if case == "flagship_sca_bands":
        assert p.bands == 2
    if case == "clipped":
        ys, ms, _, _ = tda.lattice_geometry(table.shape, k_pos, H, H)
        assert int(ms.min()) == 0 and int(ys.min()) == 0


def _jax_bias_grads(table, k_pos, H, ct):
    def f(tb, kp):
        bias, n = jda._lattice_bias_nm(tb, kp, H, H, use_kernel=True,
                                       interpret=True)
        return bias[:, :, :, :n]
    out, vjp = jax.vjp(f, jnp.asarray(table), jnp.asarray(k_pos))
    return [np.array(g) for g in vjp(jnp.asarray(ct).astype(out.dtype))]


@pytest.mark.parametrize("staging", ["1", "0"])
def test_ordered_mirror_matches_pallas_backward(monkeypatch, staging):
    """Against the Pallas VJP in interpret mode, under both stagings: the
    shift-replicated one (``_bwd_call_sh``, whose counterpart is
    ``lattice_bias_bwd.cu``) and the resolve one (``_bwd_call``,
    ``lattice_bias_wide_bwd.cu``'s)."""
    monkeypatch.setenv("BEVRENDER_SHIFT_REPLICA", staging)
    H, N = 8, 32
    table, k_pos, gout = _inputs(5, 1, 2, 2, H, 15, N, table_std=0.05)
    assert jda.use_shift_replica(tuple(table.shape), H, H) == (staging == "1")
    jdt, jdp = _jax_bias_grads(table.float().numpy(), k_pos.numpy(), H,
                               gout.float().numpy())
    dt, dp, _ = _mirror(table, k_pos, gout, H)
    assert _rel(dt, torch.from_numpy(jdt)) <= PALLAS_DTABLE_REL
    assert _rel(dp, torch.from_numpy(jdp)) <= 1e-4


# (B, G, Ht, Wt, N, H) of every bias backward a training step launches:
# the flagship's (chip_smoke.TRAIN_BIAS_SITES, H = W = 28, SCA folded at
# B*V = 6 where G >= 4) and the pyramid's (chip_smoke.PYR_BIAS_SITES), 2
# heads a group
TRAIN_SHAPES = {
    "flagship_tsa_g1": (2, 1, 55, 55, 16, 28),
    "flagship_tsa_g2": (2, 2, 55, 55, 49, 28),
    "flagship_tsa_g4": (2, 4, 55, 55, 196, 28),
    "flagship_tsa_g8": (2, 8, 55, 55, 784, 28),
    "flagship_sca_g1": (2, 1, 55, 279, 1960, 28),
    "flagship_sca_g2": (2, 2, 55, 279, 1960, 28),
    "flagship_sca_g4": (6, 4, 55, 279, 1960, 28),
    "flagship_sca_g8": (6, 8, 55, 279, 1960, 28),
    "pyramid_tsa56": (2, 1, 111, 111, 49, 56),
    "pyramid_sca56": (2, 1, 111, 559, 7840, 56),
    "pyramid_tsa28": (2, 2, 55, 55, 49, 28),
    "pyramid_sca28": (2, 2, 55, 279, 1960, 28),
    "pyramid_tsa14": (2, 4, 27, 27, 49, 14),
    "pyramid_sca14": (6, 4, 27, 139, 490, 14),
    "pyramid_tsa7": (2, 8, 13, 13, 49, 7),
    "pyramid_sca7": (6, 8, 13, 69, 140, 7),
}


@pytest.mark.parametrize("shape", list(TRAIN_SHAPES))
def test_plan_covers_keys_and_rows_once(shape):
    """Shared memory within a block; every key in exactly one run and every
    padded row in exactly one band, none empty; at least 4 blocks an SM at
    the flagship's SCA and 2 at the pyramid's SCA 56, about one wave of
    blocks or fewer."""
    B, G, Ht, Wt, N, H = TRAIN_SHAPES[shape]
    p = lbb.plan(B, G, 2, Ht, Wt, N, H, H, H100_SMS)
    assert p.smem == lbb.smem_bytes(p.rows, p.pitch) <= SMEM_PER_BLOCK
    assert (p.smem + lbb.SMEM_PER_BLOCK_RESERVED) * p.per_sm <= lbb.SMEM_PER_SM
    runs = [range(r * p.keys, min(N, (r + 1) * p.keys)) for r in range(p.runs)]
    assert all(len(r) > 0 for r in runs)
    assert sorted(n for r in runs for n in r) == list(range(N))
    Yp = Ht + 2 * PAD
    bands = [range(b * p.rows, min(Yp, (b + 1) * p.rows))
             for b in range(p.bands)]
    assert all(len(b) > 0 for b in bands)
    assert sorted(r for b in bands for r in b) == list(range(Yp))
    assert B * G * 2 * p.bands * p.runs <= p.per_sm * H100_SMS or p.runs == 1
    if shape in ("flagship_sca_g4", "flagship_sca_g8"):
        assert p.per_sm >= 4 and p.smem <= 56 * 1024
    if shape == "pyramid_sca56":
        assert p.per_sm >= 2


# (Wt, W) of every table the two models ship: the flagship's TSA and SCA at
# BEV 28, the pyramid's at BEV 56, 28, 14 and 7
SHIPPED_TABLES = [(55, 28), (279, 28), (111, 56), (559, 56), (27, 14),
                  (139, 14), (13, 7), (69, 7)]


@pytest.mark.parametrize("Wt,W", SHIPPED_TABLES)
def test_columns_strictly_increase(Wt, W):
    """The kernels give each table entry to one lane because the columns c
    = u0 + (floor(g + f) > 0.5), in float32 as they compute them, strictly
    increase in ix: held here for f on a fine grid of [0, 1) and on both
    sides of every value where a lane's floor changes, and by
    ``columns_increase``, which the plan asks. Every padded column a pair
    reads is inside the plan's pitch."""
    u0, g, m_max = tda.static_comb((1, 1, 2 * W - 1, Wt), W)
    g32 = g.astype(np.float32)
    fs = np.linspace(0.0, 1.0, 4097, dtype=np.float32)[:-1]
    edge = (np.float32(1.0) - g32).astype(np.float32)
    near = np.concatenate([np.nextafter(edge, np.float32(0.0)), edge,
                           np.nextafter(edge, np.float32(1.0))])
    fs = np.concatenate([fs, near[(near >= 0) & (near < 1)]])
    phi = (g32[None, :] + fs[:, None]).astype(np.float32)
    c = u0[None, :] + (np.floor(phi) > 0.5)
    assert (c[:, 1:] > c[:, :-1]).all()
    assert lbb.columns_increase(Wt, W)
    assert int(m_max - 3 + c.max() + 1) < lbb.pitch(Wt)


def test_columns_increase_sees_a_merge():
    """A fraction a hair under 1 next to one of 0 at the same start: at f
    = 0 both columns read table column 0, and the check says so."""
    u0 = np.array([0, 0, 2], np.int32)
    assert not lbb.columns_increase_for(u0, np.array([0.0, 0.99999994, 0.0]))
    assert lbb.columns_increase_for(np.array([0, 1, 3], np.int32),
                                    np.array([0.0, 0.99999994, 0.0]))


def test_plan_refuses_shapes_it_cannot_take():
    with pytest.raises(ValueError, match="step"):
        lbb.plan(1, 1, 2, 15, 13, 10, 8, 8, H100_SMS)  # Wt < 2W - 1
    with pytest.raises(ValueError, match="1 to 64"):
        lbb.plan(1, 1, 2, 129, 129, 10, 65, 65, H100_SMS)
    with pytest.raises(ValueError, match="2\\^15"):
        lbb.plan(1, 1, 2, 15, 40001, 10, 8, 8, H100_SMS)


def test_bias_bwd_wrappers_refuse_cpu_tensors():
    """The kernels take CUDA tensors only; the CPU route is autograd
    through the plain bias (``ops.deform_attn.lattice_bias``)."""
    table, k_pos, gout = _inputs(7, 1, 1, 2, 8, 15, 10)
    args = tda._kernel_args(table, k_pos, 8, 8)
    for fn in (lbb.lattice_bias_bwd_cuda, lbb.lattice_bias_wide_bwd_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args, gout, 8, 8)
