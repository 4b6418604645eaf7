"""Whole tiny runs of the benchmark on the CPU: the reference against the
program's plain path, runs whose timed path is broken underneath (each
must come out not correct), the control (the program's bfloat16 path) at
a tiny size, the launcher of several ranks over gloo; and, on a card,
every cell.

The tiny model is ill-conditioned in bfloat16 (one rounding moves its
gradients by tens of percent), so the tiny cells run in float32 with the
program's attention sites in float32 too (``f32_sites``): then the
program follows the reference to round-off and every fault and the
control stand far above it.
"""

from __future__ import annotations

import io
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile

import pytest
import torch

from portbench import run
from portbench.harness import register, train
from portbench.tests import tiny

# limits of the float32 tiny cells, the numbers the card's cells compare,
# from readings on the CPU (seeds 5, 7, 9). Training: the program's first
# render, median window, 5.9e-5 / 1.9e-4 / 2e-6, its median leaf's first
# gradient 0.039 / 0.014 / 2e-5 and change over three steps 0.050 / 0.034
# / 0.009 (AdamW's first steps move each weight by +-lr, so a gradient near
# zero flips its step); the control (the program's bfloat16 path) 0.091 /
# 0.084 / 0.040, 0.38 / 0.19 / 0.20 and 0.066 / 0.036 / 0.054; a state
# left unchanged reads 1 on gradient and change. Registration: the
# program's render, mean over windows, 9.7e-5 / 1.9e-4 / 4.6e-5, rank and
# distance 0; the control's render 0.19 / 0.24 / 0.20, distance 0.0049 /
# 0.0044 / 0.0024-0.0029
F32_LIMITS = {"tiny.train": {"render1_gap_median": 0.01,
                             "grad_gap_median": 0.1,
                             "change_gap_median": 0.25},
              "tiny.train.dp2": {"render1_gap_median": 0.01,
                                 "grad_gap_median": 0.1,
                                 "change_gap_median": 0.25},
              "tiny.register": {"render_gap_mean": 0.01, "rank_gap": 1e-4,
                                "dist_gap": 1e-3}}
RANKS_TIMEOUT_S = 600


@pytest.fixture
def f32_sites(monkeypatch):
    """The program's sites in float32: bias lerps, scores, softmax, AV."""
    import bevrender_tpu_torch.ops.deform_attn as tda

    plain = tda.lattice_bias_plain

    def bias(table, k_pos, H, W, compute_dtype=torch.float32):
        return plain(table, k_pos, H, W, torch.float32)

    def consumer(q, k, v, b, scale, keep=None, dropout_rate=0.0):
        p = torch.softmax(torch.matmul(k, q.transpose(-1, -2)) * scale + b,
                          dim=-2)
        return torch.matmul(p.transpose(-1, -2), v)

    monkeypatch.setattr(tda, "lattice_bias_plain", bias)
    monkeypatch.setattr(tda, "site_consumer", consumer)


@pytest.fixture
def root(tmp_path, f32_sites):
    return tiny.make_root(str(tmp_path), F32_LIMITS, dtype="float32")


def _run(root, cell, seed=5, seconds=0.3, trace=0):
    ctx = run.context(cell, seed, seconds, trace, torch.device("cpu"),
                      root=root)
    out = io.StringIO()
    assert run.run_rank(ctx, out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.register"])
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(root, cell, trace):
    line = _run(root, cell, trace=trace)
    assert line["correct"], line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "check"
    if trace:
        assert "breakdown" in line and "busy_s" in line["device"]
    else:
        assert "setup_s" in line["metrics"]


def test_state_left_unchanged_is_not_correct(root, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)
    assert not _run(root, "tiny.train")["correct"]


def test_half_the_batch_is_not_correct(root, monkeypatch):
    from bevrender_tpu_torch.training.trainer import Trainer

    losses = Trainer._forward_losses

    def half(self, net, out, batch):
        b = out.shape[0] // 2
        return losses(self, net, out[:b], {k: v[:b] for k, v in batch.items()})

    monkeypatch.setattr(Trainer, "_forward_losses", half)
    assert not _run(root, "tiny.train")["correct"]


def test_an_altered_answer_is_not_correct(root, monkeypatch):
    from bevrender_tpu_torch.inference.register import RegistrationPipeline

    reg = RegistrationPipeline.register

    def altered(self, batch, top_k=10):
        out, idx, dist = reg(self, batch, top_k)
        idx = idx.clone()
        idx[0, 0] = (idx[0, 0] + 1) % self._tile_db.shape[0]
        return out, idx, dist

    monkeypatch.setattr(RegistrationPipeline, "register", altered)
    assert not _run(root, "tiny.register")["correct"]


def test_half_the_windows_rendered_is_not_correct(root, monkeypatch):
    from bevrender_tpu_torch.inference.register import RegistrationPipeline

    reg = RegistrationPipeline.register

    def half(self, batch, top_k=10):
        b = batch["camera"].shape[0] // 2
        out, idx, dist = reg(self, {k: v[:b] for k, v in batch.items()}, top_k)
        return (torch.cat([out, out]), torch.cat([idx, idx]),
                torch.cat([dist, dist]))

    monkeypatch.setattr(RegistrationPipeline, "register", half)
    assert not _run(root, "tiny.register")["correct"]


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.register"])
def test_the_control_is_not_correct(tmp_path, cell):
    """The control, the program's own bfloat16 path (the configuration's
    dtype made bfloat16, the sites rounded as the program rounds them),
    reads above the limits that sound float32 runs keep under."""
    low = tiny.make_root(str(tmp_path), F32_LIMITS, dtype="bfloat16")
    assert not _run(low, cell, seed=7)["correct"]


def test_reference_render_matches_the_program(root):
    """Eval render of the tiny model, float32: the reference against the
    program's plain path on the same weights and windows (the tiny model
    amplifies round-off about a hundredfold)."""
    ctx = run.context("tiny.register", 11, 0.1, 0, torch.device("cpu"),
                      root=root)
    rec = register.run(ctx)
    nums = register.numbers(ctx, rec["check_inputs"])
    assert nums["render_gap"] < 2e-3 and nums["rank_gap"] < 1e-5, nums
    assert nums["dist_gap"] < 1e-5, nums


def test_reference_training_matches_the_program(root):
    """The first training step of the tiny model in float32 (drop path
    0.2, BatchNorm in training, clip): its render to round-off and its
    median leaf's gradient within the round-off the clip amplifies."""
    ctx = run.context("tiny.train", 11, 0.1, 0, torch.device("cpu"),
                      root=root)
    rec = train.run(ctx)
    nums = train.numbers(ctx, rec["check_inputs"])
    assert nums["render1_gap"] < 1e-3 and nums["grad_gap_median"] < 0.05, nums


def _rank(r, world, root, rdv, limits_fault, result):
    from bevrender_tpu_torch.parallel import dist as pdist

    torch.set_num_threads(1)
    if limits_fault:
        pdist.all_reduce_mean_ = lambda tensors: None
    pdist.initialize_distributed("cpu", init_method=f"file://{rdv}", rank=r,
                                 world_size=world)
    ctx = run.context("tiny.train.dp2", 9, 0.3, 0, torch.device("cpu"),
                      rank=r, world=world, root=root)
    out = io.StringIO()
    rc = run.run_rank(ctx, out=out)
    if r == 0:
        with open(result, "w") as f:
            f.write(out.getvalue())
    sys.exit(rc)


@pytest.mark.parametrize("exchange", [True, False])
def test_two_ranks_over_gloo(root, exchange):
    """Two data ranks in one group (the launcher's path, gloo on the CPU):
    correct with the gradient exchange, not correct without it."""
    fork = multiprocessing.get_context("fork")
    tmp = tempfile.mkdtemp(prefix="portbench_ranks_")
    result = os.path.join(tmp, "line.json")
    procs = [fork.Process(target=_rank, args=(r, 2, root,
                                              os.path.join(tmp, "rdv"),
                                              not exchange, result))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANKS_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs)
    line = json.loads(open(result).read().strip().splitlines()[-1])
    assert line["device"]["count"] == 2
    assert line["correct"] is exchange, line["check"]


def test_launcher_starts_every_rank(tmp_path):
    """``run.py`` on a cell of two chips, rehearsed on the CPU: two
    processes over gloo, rank 0's line last."""
    root = tiny.make_root(str(tmp_path), dtype="float32")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, tiny.REPO]),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(root, "portbench", "run.py"),
         "--workload", "tiny.train.dp2", "--seed", "4", "--seconds", "0.3",
         "--trace", "0", "--device", "cpu"],
        capture_output=True, text=True, timeout=RANKS_TIMEOUT_S, cwd=root,
        env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["count"] == 2 and line["attempted"] > 0
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


with open(os.path.join(tiny.REPO, "BENCHMARK.json")) as _f:
    CELLS = {w["name"]: w["chips"] for w in json.load(_f)["workloads"]}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_is_correct_on_the_card(cell):
    """Each cell, a short window, on the card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    chips = CELLS[cell]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA devices")
    out = subprocess.run(
        [sys.executable, os.path.join(tiny.PORTBENCH, "run.py"), "--workload",
         cell, "--seed", "12345", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=1800, cwd=tiny.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
