"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from the sources in this checkout (one nvcc per
   source, all at once);
3. the flagship render+register path (bf16, B=4, T=2, V=3, 224x224,
   64-tile database, seeded weights): the launch counters must show 24
   fused-site and 64 ``fused_site_mma`` launches per forward (head widths
   4 and 8; 16 and 32); time of a window of
   requests, its spread, the host's CPU time, peak memory and the
   device's idle share;
4. each kernel against its plain PyTorch version at every shape the main
   path gives it, with seeded inputs; the fused site also against
   ``site_consumer_online`` (its own roundings, written in PyTorch), and
   with a second rpe table whose bias dominates the scores; times of
   kernel, plain version and a library yardstick (profiler device time),
   and the least time the card could take (bytes or operations over the
   H100's published peaks); the fused site's plan at each shape
   (``fused_site.site_plan``: strip, blocks, blocks an SM, waves);
   ``fused_site_mma`` at the registration cell's call shapes (B=32) and
   the pyramid's (MMA_SITES, MMA_CHECK_SITES) against its plain version
   and ``site_consumer_online`` (MMA_ONLINE_TOL, MMA_FLIP_SHARE), its
   time, picoseconds a pair, warps a block and blocks an SM beside the
   plain version, the bias route (bias kernel and plain consumer),
   SDPA with the bias as a mask and the bound (``check_mma_site``);
5. a small 2-stage model at float32 through the kernels and through
   plain PyTorch that rounds as the kernels do: the renders must agree to
   RENDER_TOL (its head-width-16 stage on ``fused_site_mma`` in both,
   that kernel held to ``site_consumer_online`` at each of its calls);
6. training, default route: ``Trainer`` on the flagship bf16 model, B=2,
   T=2, MSE loss, drop path 0.2 from a seeded generator, one warm-up step
   and TRAIN_STEPS steps on a fixed batch: exact launch counts per step,
   finite falling loss, finite non-zero gradients on every parameter,
   BatchNorm buffers moved; ms per step, host CPU ms per step, peak memory
   under ``site_remat`` "nothing" and "none", device busy and idle share,
   the top device operations;
7. the same steps with ``fused_bwd=True`` (the fused site's own backward
   kernel at head widths 4 and 8);
8. the backward kernels (bias backward, fused site with logsumexp and its
   plan, fused site backward) against their plain versions, and the site
   backward also against ``site_bwd_online`` (its own roundings in
   PyTorch), at every shape a training step gives them and at two table
   scales; the bias
   forward kernel against its plain version at those training shapes too;
   the bias backward's plan and blocks per SM at each shape, two runs of it
   equal bit for bit, its dtable equal to ``lattice_bias_bwd_ordered``
   (its order of sums in PyTorch), ``grid_sampler_2d_backward``'s time
   beside it, and its time summed over a step's launches;
9. the small model's parameter gradients through the kernels against
   plain PyTorch that rounds as the kernels do (its history pass's
   ``fused_site_mma`` in both), under both routes; then
   one K-fold epoch of ``Trainer.train`` on that model on the card, with
   the pinned-memory prefetch, validation, recall and checkpoints;
10. the pyramid (``Config()``, the reference default: BEV 56-28-14-7-14-28-
    56, widths 64-512, ResNet-18, 3 views of 224 x 224) in bf16, serving:
    render+register at B=2, T=2 against 64 tiles, one warm-up and
    PYR_REQUESTS requests with exact launch counts (every site of head
    width 32 on ``fused_site_mma``), the same measurements as phase 3;
11. the pyramid training: ``Trainer`` at B=2, T=2 as in phase 6, exact
    launch counts of the four bias kernels per step, every parameter
    (transitions, width fixes and rpe tables among them) with a finite
    non-zero gradient, peak memory under ``site_remat`` "nothing" and
    "none";
12. the bias kernels at every pyramid shape against their plain versions
    (forward, and backward through autograd) at two table scales: the
    whole-table kernels at all eight shapes (M = 196 and 49 at BEV 14 and
    7), the wide ones at BEV 56; times, bounds, the plain version's peak
    memory, ``grid_sample``'s forward and backward times; the wide
    forward's plan and blocks per SM; the backward's plan, blocks per SM,
    two runs equal bit for bit and dtable equal to
    ``lattice_bias_bwd_ordered``;
13. a small BEV 56 -> 28 -> 56 model whose SCA at 56 takes the wide kernels
    through the normal dispatch: its parameter gradients through the
    kernels against plain PyTorch with the kernels' roundings, as phase 9;
14. the wide-table route: the flagship serving as phase 3 (WIDE_REQUESTS
    requests) with ``lattice_route="wide"``: exactly 24
    ``fused_site_wide`` and 64 ``lattice_bias_wide`` launches per forward
    (the wide heads keep the bias on "wide"), its render's distance to
    phase 3's printed;
15. the same with ``site_prefetch`` and ``bias_forward="prefetch"``: 24
    ``fused_site_wide_prefetch`` and 64 ``lattice_bias_wide_prefetch`` per
    forward, the render equal to phase 14's;
16. flagship training on the wide route with ``fused_bwd``, as phase 7:
    the counts of phase 7 on the wide kernels (12 ``fused_site_wide_lse``
    and 12 ``fused_site_bwd`` per step);
17. the pyramid serving as phase 10 with ``bias_forward="prefetch"``:
    phase 10's 88 ``fused_site_mma`` per forward (no eval site takes the
    bias), the render equal to phase 10's;
18. each new kernel alone at every shape phases 14-17 give it, and
    ``fused_site_wide_prefetch`` also at a site of its ring path
    (PREFETCH_RING_SITE), at two table scales, against its plain version
    and, with tolerance 0, against its bit-equal sibling;
    ``lattice_bias_wide`` and its backward at the flagship's shapes; the
    two wide bias forwards (one template) also at every shape of phases 8
    and 12 (FWD_CHECK_SITES), each with its plan, path and blocks per SM,
    the prefetch kernel on its whole-table path at all of them; times,
    bounds, plain and library times, and the prefetch site's path and
    blocks per SM; ``fused_site_wide``'s and its logsumexp instance's plan
    (path, strip, blocks, waves) and blocks per SM at every shape, path
    "whole" at every serving and training shape and "raw" at
    PREFETCH_RING_SITE;
19. the folded fused sites: the flagship serving as phase 14
    (WIDE_REQUESTS requests) with ``lattice_route="wide"``,
    ``site_prefetch`` and ``site_fold_heads``: exactly 24
    ``fused_site_fold_heads`` and 64 ``lattice_bias_wide`` per forward, the
    render equal to phase 14's;
20. the flagship serving with ``site_fold_rows`` on "auto" (WIDE_REQUESTS
    requests): 24 ``fused_site_fold_rows`` and 64 ``fused_site_mma`` per
    forward, the render equal to phase 3's;
21. flagship training as phase 7 (``fused_bwd``) with ``site_prefetch`` and
    ``site_fold_heads`` on "auto": phase 7's counts with 12
    ``fused_site_fold_heads_lse`` in place of the 12 ``fused_site_lse`` per
    step; step 1's loss printed beside phase 7's;
22. each folded kernel alone at every shape phases 19-21 give it, and the
    head-folded kernels also at a site of their ring path
    (FOLD_RING_SITE), at two table scales, against its plain version and,
    with tolerance 0, against its per-head sibling; times, bounds, plain
    and library times, the sibling's time in the same call, the
    head-folded kernels' path and blocks per SM, and the row-folded
    kernel's plan (path, heads and strip a block, blocks, waves) and
    blocks per SM;
23. the windowed bias (``bias_forward="windows"``): the flagship serving as
    phase 3 (WINDOWS_REQUESTS requests), exactly 24 ``fused_site`` and 64
    ``fused_site_mma`` per forward (no eval site takes the bias on
    "auto"), the render equal (max abs 0) to the same model's render with
    every window cut by ``lattice_windows_plain`` on the card;
24. flagship training as phase 6 with ``bias_forward="windows"``: phase
    6's counts with ``lattice_windows`` for ``lattice_bias`` (88 per step)
    and ``lattice_windows_bwd`` for ``lattice_bias_bwd`` (44);
25. the window kernels alone: ``lattice_windows`` equal to its plain
    version at every shape the bias sees (the flagship's serving and
    training shapes, the pyramid's SCA 56 and BEV 7), ``lattice_windows_bwd``
    within BWD_SUM_TOL of its plain version at the training shapes and the
    pyramid's SCA 56, bit-equal there to a second run and to
    ``lattice_windows_bwd_ordered`` (its order of sums in PyTorch), with
    the largest bin of its starts; the windowed bias equal to the plain
    bias and within WINDOWED_TOL of ``lattice_bias.cu`` /
    ``lattice_bias_wide.cu``; kernel,
    plain, library and bound times; then the pyramid serving with
    ``bias_forward="windows"`` (PYR_WINDOWS_REQUESTS requests): 88
    ``fused_site_mma`` per forward, the render equal to its plain-windows
    render;
26. registering through the retrieval head: the flagship of phase 3 with
    ``retrieval_embed_dim=256`` (widths 32-256; the trunk draws phase 3's
    seeded weights, the head its own), B=4, T=2, against HEAD_TILES seeded
    tiles made a batch at a time, with phase 3's renders inserted at
    HEAD_ROWS: the database's bytes and tiles per second, the head's own
    time; one warm-up and HEAD_REQUESTS requests with phase 3's launch
    counts, the render equal to phase 3's (max abs 0), each render's
    embedding with TF32 enabled globally within HEAD_REL_TOL of the same
    head in float64 on the CPU, the inserted renders back as top-1 at
    distance at most HEAD_SELF_DIST; ms/request, host CPU, peak memory;
27. streaming and replay on the same pipeline and database: a seeded
    sequence of STREAM_FRAMES frames whose first two are phase 3's window;
    the streaming step over those two frames (the JAX package's pose-pair
    rule) gives phase 3's render (max abs 0); over the whole sequence,
    exactly 12 ``fused_site`` and 32 ``fused_site_mma`` launches a frame,
    ms a frame beside phase 3's ms a request; ``make_replay_scan`` over it
    returns the chain's tile indices and final BEV bit for bit; after a
    first replay (its host synchronisations printed) STREAM_RUNS timed
    replays with ``torch.cuda.set_sync_debug_mode("error")``: none may
    synchronise the host; their ms a sequence;
28. the file-fed trainer: a GPS trace of FEED_FRAMES frames with a gap
    (two sequences), wide camera PNGs at the flagship's source size (512 x
    1920), map tiles and the full map PNG, written under ``build/`` by the
    port's encoder; the feed alone (ms a sample and samples/s with the
    cache off, cold and warm, and for raw uint8 frames; the loader's
    samples/s; the bytes a batch crosses to the device); then
    ``train.main --config ... --epochs 2`` (one epoch) on the flagship
    bf16, B=2, T=2, two folds with validation, on the host route and with
    ``on_device_preprocess``: every step launches phase 6's counts, every
    loss finite, a checkpoint and config.yaml written; ms/step (host
    clock), host CPU and device idle share beside phase 6's; the device
    route's camera tensor within ROUTE_TOL of the host route's on the same
    window; ``MapLoader.iter_tiles`` over the map PNG (81 tiles equal to
    their slices of the world) embedded by the trained checkpoint and a
    file-fed window registered with a valid top-5;
29. grouped training (``TrainConfig.steps_per_dispatch``): the flagship as
    phase 6 trains it, GRAPH_K steps a dispatch, each sub-step one replay
    of a captured CUDA graph of the step (``training.graph_step``), on the
    default route and with ``fused_bwd``: two eager runs of GRAPH_STEPS
    steps and GRAPH_DISPATCHES dispatches from one seeded state on the same
    batches, the graphed losses and final parameters within SPREAD_FACTOR
    times the eager runs' spread (GRAPH_REL_FLOOR at least), step 1's loss
    and a later step's (eager and graphed from one state) the same bits,
    the captured step's launches those of phase 6 / 7 (counted at capture;
    the replays' kernels by name from the profiler), falling loss, moved
    BatchNorm statistics; graphed and eager ms/step by CUDA events and the
    host clock, capture time, idle share and peak memory; ``Trainer.train``
    through the loader and ``device_prefetch`` at GRAPH_K steps a dispatch
    with a partial trailing group; one step under each ``site_remat``
    ("nothing", "dots", "none"): launches, the first step's gradients
    within the spread of two "nothing" runs, the three peak memories in
    that order; ``utils``: ``device_bench`` of one graphed sub-step,
    ``trace`` with an ``annotation``, ``device_memory_stats`` against
    ``torch.cuda.max_memory_allocated``.

30. data parallelism (``bevrender_tpu_torch.parallel``): phase 29's
    graphed default-route steps in a one-rank NCCL group (the step's
    all-reduce captured), against phase 29's replay; two ranks spawned on
    the one card over gloo (B=2 each, drop path 0.2, 3 steps) against one
    process at B=4, and phase 5's small model one step on them; the
    sharded matcher on those ranks against ``register``'s top-k over phase
    26's 4,096-tile database.
31. the model axis (``parallel.dist.init_model_parallel``): (a) two
    model ranks of one data rank spawned on the one card over gloo, the
    flagship bf16 at full width with every site's heads split (one head a
    group a rank) and ``ConvMLP``'s hidden channels: MP_REQUESTS
    render+register requests after a warm-up and MP_STEPS training steps
    (B=2, T=2, drop path 0.2), the ranks' renders, top-k and parameters
    equal bit for bit, held against one process by phase 30's spread rule,
    exact launches a rank a request and a step; a request on each folded
    site (render equal to its route's: the rows fold's "auto", the heads
    fold's "wide") and a ``fused_bwd`` step
    with and without the folded forward, with their launches; (b) 2 data
    x 2 model ranks: phase 5's small model one step against one process,
    held to phase 30's spread rule with SMALL_DP_REL as its floor.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
there is no CUDA device or the port's package is not beside this file.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
# tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# a sleep of ~10 ms at the H100's clocks, longer than the host takes to
# enqueue one timing window of ``queued_ms``
SLEEP_CYCLES = 20_000_000
N_REQUESTS = 20
TRAIN_STEPS = 10
TRAIN_B = 2
# launches per training step of the flagship at T=2. History pass (eval, no
# gradient): 12 fused sites (stages 2-4: 6 layers x (TSA + folded SCA)) and
# 32 wide-head fused sites (stages 0, 1, 5, 6, head widths 32 and 16: 8
# layers x (TSA + 3 views)). Final pass, default route: every site takes
# the bias kernel, 32 + 12 = 44 forward and 44 backward, and 44 more
# forward when the backward recomputes the site (site_remat "nothing").
# With fused_bwd the 12 narrow sites take the logsumexp forward and the
# site backward instead.
TRAIN_COUNTS = {
    (False, "nothing"): dict(fused_site=12, fused_site_mma=32,
                             lattice_bias=44 + 44, lattice_bias_bwd=44),
    (False, "none"): dict(fused_site=12, fused_site_mma=32, lattice_bias=44,
                          lattice_bias_bwd=44),
    (True, "nothing"): dict(fused_site=12, fused_site_mma=32,
                            lattice_bias=32 + 32, lattice_bias_bwd=32,
                            fused_site_lse=12, fused_site_bwd=12),
}
SERVE_B = 4
FUSED_PER_FORWARD = 24
# sites of head width 32 or 16 a serving forward (T=2): fused_site_mma on
# the "auto" route, the bias kernels on "wide"
BIAS_PER_FORWARD = 64
MMA_PER_FORWARD = BIAS_PER_FORWARD
# The pyramid (Config(): BEV 56-28-14-7-14-28-56, widths 64-512, heads
# 2-4-8-16-8-4-2, groups 1-2-4-8-4-2-1, depth 2). Head width 32 at every
# stage: no narrow fused site. Per pass, per layer: stages 0, 1, 5, 6 one
# TSA and three SCA sites (G < 4, one per view), stages 2-4 one TSA and one
# SCA with the views folded; 22 per layer, 44 per pass. In eval every site
# takes fused_site_mma (its shared memory holds every table, the SCA at BEV
# 56's too). In training the sites take the bias kernels: SCA at BEV 56
# (stages 0 and 6, 12 per pass) the wide ones (ops.deform_attn.bias_route),
# the 32 others the whole-table ones.
PYR_B = 2
PYR_REQUESTS = 10
PYR_PER_FORWARD = dict(fused_site_mma=2 * 44)  # T=2
# a training step at T=2: the history pass (eval, no gradient), the final
# pass, and with site_remat "nothing" every site's bias again in the
# backward; fused_bwd changes nothing (head width 32)
PYR_TRAIN_COUNTS = {
    "nothing": dict(fused_site_mma=44, lattice_bias=32 * 2,
                    lattice_bias_wide=12 * 2, lattice_bias_bwd=32,
                    lattice_bias_wide_bwd=12),
    "none": dict(fused_site_mma=44, lattice_bias=32, lattice_bias_wide=12,
                 lattice_bias_bwd=32, lattice_bias_wide_bwd=12),
}
# The wide-table route (ModelConfig.lattice_route="wide"): every flagship
# site on the kernels that read the table through L1 (phase 14), or on
# their window-prefetch variants (phase 15: site_prefetch and bias_forward
# "prefetch");
# a window of WIDE_REQUESTS requests each
WIDE_REQUESTS = 10
WIDE_PER_FORWARD = dict(fused_site_wide=FUSED_PER_FORWARD,
                        lattice_bias_wide=BIAS_PER_FORWARD)
WIDE_PREFETCH_PER_FORWARD = dict(fused_site_wide_prefetch=FUSED_PER_FORWARD,
                                 lattice_bias_wide_prefetch=BIAS_PER_FORWARD)
# a training step under "wide" with fused_bwd (phase 16): the counts of
# TRAIN_COUNTS[(True, "nothing")] on the wide kernels, where the history
# pass's wide heads take the bias too; the site backward stays
# fused_site_bwd, whose shared memory holds the flagship's tables
WIDE_NAMES = dict(fused_site="fused_site_wide",
                  fused_site_lse="fused_site_wide_lse",
                  fused_site_mma="lattice_bias_wide",
                  lattice_bias="lattice_bias_wide",
                  lattice_bias_bwd="lattice_bias_wide_bwd",
                  fused_site_bwd="fused_site_bwd")


def renamed(counts: dict, names: dict) -> dict:
    """Launch counts with each kernel renamed by ``names`` (others kept), the
    counts of two names that become one summed."""
    out: dict = {}
    for k, v in counts.items():
        out[names.get(k, k)] = out.get(names.get(k, k), 0) + v
    return out


WIDE_TRAIN_COUNTS = renamed(TRAIN_COUNTS[(True, "nothing")], WIDE_NAMES)
# the pyramid with bias_forward "prefetch" (phase 17): in eval every site
# takes fused_site_mma, so the prefetch variant of the wide bias (its SCA
# at BEV 56) runs only in training, and a serving forward's launches are
# phase 10's
PYR_PREFETCH_PER_FORWARD = dict(PYR_PER_FORWARD)
# The folded fused sites (phases 19-21). Every flagship fused site has two
# heads per group on rows of 28 queries (Hpg * W = 56 <= 128), so each one
# folds: site_fold_heads with site_prefetch on "wide" takes
# fused_site_fold_heads where fused_site_wide_prefetch would run,
# site_fold_rows on "auto" takes fused_site_fold_rows for fused_site, and a
# fused_bwd step with site_prefetch and site_fold_heads on "auto" takes
# fused_site_fold_heads_lse for fused_site_lse (its history pass stays on
# fused_site: site_prefetch acts on the wide route only)
FOLD_HEADS_PER_FORWARD = dict(fused_site_fold_heads=FUSED_PER_FORWARD,
                              lattice_bias_wide=BIAS_PER_FORWARD)
FOLD_ROWS_PER_FORWARD = dict(fused_site_fold_rows=FUSED_PER_FORWARD,
                             fused_site_mma=MMA_PER_FORWARD)
FOLD_TRAIN_COUNTS = {
    ("fused_site_fold_heads_lse" if k == "fused_site_lse" else k): v
    for k, v in TRAIN_COUNTS[(True, "nothing")].items()}
# The windowed bias (ModelConfig.bias_forward="windows", phases 23-25): every
# site that takes the bias takes lattice_windows in its forward and
# lattice_windows_bwd in its backward; the fused sites do not change. On
# the "auto" route no eval site takes the bias (head widths 4 and 8 the
# fused site, 16 and 32 fused_site_mma), so serving launches no window
# kernel; training's final pass does
WINDOWS_REQUESTS = 10
WINDOWS_PER_FORWARD = dict(fused_site=FUSED_PER_FORWARD,
                           fused_site_mma=MMA_PER_FORWARD)
WINDOW_NAMES = dict(lattice_bias="lattice_windows",
                    lattice_bias_bwd="lattice_windows_bwd")
WINDOWS_TRAIN_COUNTS = {WINDOW_NAMES.get(k, k): v
                        for k, v in TRAIN_COUNTS[(False, "nothing")].items()}
PYR_WINDOWS_REQUESTS = 3
PYR_WINDOWS_PER_FORWARD = dict(PYR_PER_FORWARD)
# the retrieval head (phase 26): the shipped head on the flagship, a tile
# database made from a seed, phase 3's renders inserted at known rows (one
# a request item)
HEAD_DIM = 256
HEAD_WIDTHS = (32, 64, 128, 256)
HEAD_TILES = 4096
HEAD_TILE_BATCH = 256
HEAD_REQUESTS = 10
HEAD_ROWS = (17, 1031, 2222, 4000)
# the head on the card, TF32 enabled globally, against its float64 run on
# the CPU: largest difference over largest entry
HEAD_REL_TOL = 1e-5
# an inserted render's distance to its own row (2 - 2 cos of two float32
# embeddings of one image, made in batches of 256 and of 4)
HEAD_SELF_DIST = 1e-5
# streaming (phase 27): one encoder pass a frame
STREAM_FRAMES = 8
STREAM_RUNS = 3
STREAM_PER_FRAME = dict(fused_site=FUSED_PER_FORWARD // 2,
                        fused_site_mma=MMA_PER_FORWARD // 2)
BIAS_ULP = 2.0 ** -7   # one bf16 ulp of x is at most |x| * 2^-7
# windowed bias against the bias kernels, as a share of the largest entry a
# of the bf16 table: the windowed bias lerps in bf16, each operation rounded
# (u = 2^-8 of its result), so its x-lerp is within 4 u a of the float32 one
# (the weight, 1 - weight, two products and their sum) and its y-lerp adds
# 4 u a more; the kernels lerp in float32 and round once (u a)
WINDOWED_TOL = 9 * 2.0 ** -8
# fused site vs its plain version: both round p to bf16 (the kernel before
# normalising, the plain version after), each off by at most 2^-8 of the
# p-weighted |v|
SITE_P_ROUND = 2.0 ** -7
# fused site vs site_consumer_online, which rounds where the kernel rounds
# and in the same order (equal bit for bit on an H100 with PyTorch 2.11):
# the margin is for an exp2 that differs from the kernel's exp2f in the last
# bit, which can flip the bf16 rounding of a p now and then
ONLINE_TOL = 2.0 ** -15
# rpe table std: the init's, and one whose bias outweighs q . k (std ~0.25)
# so that a kernel with a wrong bias cannot pass
SITE_TABLE_STDS = (0.01, 1.0)
RENDER_TOL = 1e-4  # small-model render (values in [0, 1]): kernels vs site_consumer_online
# bias backward vs autograd through the plain bias (float32 lerps on the
# bf16 table): the same float32 arithmetic, summed in another order
BWD_SUM_TOL = 2e-5
# grid_sample (the bias kernels' library yardstick) against the plain bias,
# as a share of its largest entry: the same bilinear read of the bf16 table,
# from coordinates normalised and unnormalised again in float32 (a column
# moves by ~1e-5) and lerped in grid_sample's own order
GRID_SAMPLE_TOL = 1e-3
# logsumexp vs the plain version's (sums in another order) and vs the
# online mirror's (log2f against torch.log2)
LSE_TOL = 1e-5
LSE_ONLINE_TOL = 2e-6
# site backward vs autograd through site_plain, which rounds the normalised
# p and the cotangents of its bf16 casts where the kernel rounds p, ds and
# dO: the bound the JAX package holds its own flash backward to, as a share
# of each gradient's largest entry
SITE_BWD_TOL = 8e-3
# site backward vs site_bwd_online, which repeats the kernel's roundings:
# only the order of the float32 sums differs
SITE_BWD_ONLINE_TOL = 1e-4
# small-model parameter gradients, kernels vs plain PyTorch with the
# kernels' roundings, as a share of each parameter gradient's largest
# entry. The forward passes are equal bit for bit; the backward kernels sum
# through float atomics in an order of their own (1e-6 of a site's
# gradients), and the plain consumer's bf16 casts round the cotangents
# downstream, where a last-bit difference flips a rounding (2^-9 of an
# entry). Two stages carry that to 1e-2 to 2e-2 of a parameter gradient's
# largest entry: two runs of the kernels themselves differ by as much (the
# script prints that distance beside the one it checks), and the tolerance
# is a few times it. Measured with deliberately wrong kernels on an H100:
# the x weights of the table gradient swapped reads 0.72-0.78 (at an rpe
# table), a wrong sign of dwy 0.037-0.043, df without its lower row
# 0.011-0.016, the right kernels 0.005-0.017. So this check sees a wrong
# table gradient and not a wrong gradient towards k_pos, whose share of the
# offset heads' gradients is a few percent: it shows that autograd wires
# the kernels into the model, and phase 8, which holds each kernel alone to
# 2e-5 and 1e-4 in all five gradients, is the sharp check. A gradient that
# is zero in exact arithmetic (the bias of proj_k shifts all scores of a
# query alike, which the softmax ignores) holds only rounding noise on both
# sides, so the share is taken of no less than GRAD_FLOOR of the largest
# entry of all the gradients.
GRAD_TOL = 5e-2
GRAD_FLOOR = 1e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def events_ms(fn, iters: int) -> float:
    """Mean time per call of ``iters`` calls queued back to back, by CUDA
    events (includes any host gap between launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters: int, match: str = "") -> float:
    """Device time per call, from the profiler. With ``match``: the mean
    time of the CUDA kernels whose name contains it, over the launches the
    profiler recorded (``fn`` launches one such kernel per call; the
    profiler drops some events of a longer window, so the mean is taken
    over the count it kept, not over ``iters``). Without: all kernels,
    summed over ``iters`` calls and divided by ``iters``. Falls back to CUDA
    events when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if match in e.key]
    us = sum(e.self_device_time_total for e in hits)
    if us <= 0:
        print(f"  (the profiler recorded no device time for {match!r}: "
              f"CUDA events instead)", flush=True)
        return events_ms(fn, iters)
    return us / (sum(e.count for e in hits) if match else iters) / 1e3


def queued_ms(fn, iters: int) -> float:
    """Device time per call of ``fn`` (which must not synchronise), by CUDA
    events around ``iters`` calls queued behind a sleep kernel: the host
    enqueues them all while the device sleeps, so the device runs them back
    to back and the events see no host gap between launches (``events_ms``
    does, for calls shorter than their launch), and no profiler is
    involved (it drops events over some windows: device times summed or
    averaged from it can read low, once below a kernel's bound)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


# The whole-table paths of fused_site_wide_prefetch and
# fused_site_fold_heads launch one instance kernel of csrc/site_whole.cuh,
# which the profiler names by its arguments, the launch bounds last:
# (160, 4) in fused_site_wide_prefetch.cu, (256, 2) in
# fused_site_fold_heads.cu. Every other kernel, fused_site's,
# fused_site_wide's and fused_site_fold_rows' instances of the template
# among them, is named "<counter>_kernel".
WHOLE_INSTANCES = {"fused_site_wide_prefetch": ", 160, 4>",
                   "fused_site_fold_heads": ", 256, 2>"}


def seen_launches(avgs, name: str) -> int:
    """Launches of the kernel counted as ``name`` among the profiler's
    averages ``avgs``."""
    tail = WHOLE_INSTANCES.get(name)
    return sum(e.count for e in avgs
               if f"{name}_kernel" in e.key
               or (tail is not None and "fused_site_whole_kernel<" in e.key
                   and tail in e.key))


def expected(**nonzero) -> dict:
    """Launch counts with every kernel not named at 0."""
    from bevrender_tpu_torch.ops import kernels

    unknown = set(nonzero) - set(kernels.counts())
    if unknown:
        fail(f"unknown kernels {unknown}")
    return {k: nonzero.get(k, 0) for k in kernels.counts()}


def serving_phase(card: str, tag: str, cfg, B: int, requests: int,
                  per_forward: dict, compare=None) -> dict:
    """render+register at B, T=2, V=3, 224 x 224 against a 64-tile
    database, seeded weights: one warm-up request, then ``requests`` back to
    back with exact launch counts (``per_forward`` per request); time,
    spread, host CPU, peak memory, device idle share, top operations. The
    result holds the last render (float32, on the host) under "render",
    and what ``compare(pipe, batch)`` returns, called last."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bevrender_tpu_torch.data.synthetic import SyntheticDataset
    from bevrender_tpu_torch.inference.register import RegistrationPipeline
    from bevrender_tpu_torch.ops import kernels

    pipe = RegistrationPipeline(cfg, device="cuda", seed=0)
    ds = SyntheticDataset(n_items=B, num_views=cfg.model.num_views,
                          window_num_imgs=1, img_height=224, img_width=224)
    batch = {k: torch.as_tensor(v) for k, v in ds.batch(B).items()}
    rng = torch.Generator().manual_seed(1)
    tiles = torch.rand(64, 224, 224, 3, generator=rng).numpy()
    db = pipe.build_tile_database(list(tiles), batch_size=32)
    if tuple(db.shape) != (64, 224 * 224 * 3):
        fail(f"{tag}: tile database shape {tuple(db.shape)}")
    pipe.register(batch, top_k=10)  # warm-up request (cuDNN autotune, ...)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(requests + 1)]
    cpu0 = time.process_time()
    marks[0].record()
    for i in range(requests):
        render, idx, dist = pipe.register(batch, top_k=10)
        marks[i + 1].record()
    marks[-1].synchronize()
    host_cpu_ms = (time.process_time() - cpu0) * 1e3 / requests
    counts = kernels.counts()
    req_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    total_ms = marks[0].elapsed_time(marks[-1])
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = expected(**{k: v * requests for k, v in per_forward.items()})
    print(f"{tag} serving launches over {requests} requests: {counts} "
          f"(expected {want})", flush=True)
    if counts != want:
        fail(f"{tag}: launch counts {counts} != {want}")
    if tuple(render.shape) != (B, 224, 224, 3) or not bool(
            torch.isfinite(render.float()).all()):
        fail(f"{tag}: render shape {tuple(render.shape)} or non-finite values")
    if tuple(idx.shape) != (B, 10) or tuple(dist.shape) != (B, 10):
        fail(f"{tag}: top-k shapes {tuple(idx.shape)} {tuple(dist.shape)}")
    if not bool(((idx >= 0) & (idx < 64)).all()) or not bool(
            (dist[:, 1:] >= dist[:, :-1]).all()):
        fail(f"{tag}: top-k indices out of range or distances not ascending")
    ms = total_ms / requests
    q = statistics.quantiles(req_ms, n=20)
    print(f"render+register {tag} bf16 B={B} T=2: {requests} requests "
          f"back to back in {total_ms:.3f} ms, {ms:.3f} ms/request, "
          f"{B / ms * 1e3:.2f} frames/s; per request min {min(req_ms):.3f} "
          f"median {statistics.median(req_ms):.3f} p95 {q[-1]:.3f} max "
          f"{max(req_ms):.3f} ms; host CPU {host_cpu_ms:.3f} ms/request; "
          f"peak {peak_gb:.3f} GiB [{card}]", flush=True)
    # one request per profile: over several, the profiler dropped events
    profiled = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pipe.register(batch, top_k=10)
            torch.cuda.synchronize()
        avgs = sorted(prof.key_averages(),
                      key=lambda e: -e.self_device_time_total)
        profiled.append((sum(e.self_device_time_total for e in avgs) / 1e3,
                         avgs))
    profiled.sort(key=lambda r: r[0])
    busy, avgs = profiled[1]
    idle = max(0.0, 1 - busy / ms)
    seen = {n: seen_launches(avgs, n) for n in per_forward}
    print(f"{tag}: device time of one request (profiler, median of 3: "
          f"{[round(r[0], 3) for r in profiled]}): busy {busy:.3f} ms of "
          f"{ms:.3f} ms/request, idle share {idle:.3f}; kernel launches "
          f"seen {seen}", flush=True)
    for e in avgs[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:100]}", flush=True)
    last = render.float().cpu()
    more = compare(pipe, batch) if compare is not None else {}
    del pipe, render, idx, dist, db
    torch.cuda.empty_cache()
    return dict(requests=requests, request_ms=ms, request_ms_min=min(req_ms),
                request_ms_median=statistics.median(req_ms),
                request_ms_p95=q[-1], request_ms_max=max(req_ms),
                host_cpu_ms=host_cpu_ms, frames_per_s=B / ms * 1e3,
                peak_gib=peak_gb, busy_ms=busy, idle_share=idle,
                counts=counts, render=last, **more)


# Sites of one flagship forward at B=4, V=3, BEV 28 x 28 (H = W = 28):
# (name, batch, G, ch, N, table width, launches of this shape per forward).
# Bias kernel: stages 0, 1, 5, 6 (ch 32, 16, 16, 32); fused site: stages
# 2, 3, 4 (ch 8, 4, 8), with the SCA views folded into the batch (B*V=12).
BIAS_SITES = [
    ("tsa_g1_n16", 4, 1, 32, 16, 55, 8),
    ("tsa_g2_n49", 4, 2, 16, 49, 55, 8),
    ("sca_g1_n1960", 4, 1, 32, 1960, 279, 24),
    ("sca_g2_n1960", 4, 2, 16, 1960, 279, 24),
]
SITE_SITES = [
    ("tsa_g4_ch8_n196", 4, 4, 8, 196, 55, 8),
    ("tsa_g8_ch4_n784", 4, 8, 4, 784, 55, 4),
    ("sca_g4_ch8_n1960", 12, 4, 8, 1960, 279, 8),
    ("sca_g8_ch4_n1960", 12, 8, 4, 1960, 279, 4),
]
HPG, H, W = 2, 28, 28


def site_inputs(seed, B, G, ch, N, Wt, table_std=0.01, side=H):
    """A site's random table, key positions, q, k and v on the card, at BEV
    side x side (H x W unless given)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    table = torch.randn(G, HPG, 2 * side - 1, Wt, generator=g,
                        device=dev) * table_std
    k_pos = torch.rand(B, G, N, 2, generator=g, device=dev) * 2.4 - 1.2
    q = torch.randn(B, G, HPG, side * side, ch, generator=g, device=dev) * 0.5
    k = torch.randn(B, G, HPG, N, ch, generator=g, device=dev) * 0.5
    v = torch.randn(B, G, HPG, N, ch, generator=g, device=dev) * 0.5
    return table, k_pos, q, k, v


def check_bias(da, kernel_mod) -> dict:
    """Phase 4: ``lattice_bias`` at the flagship's serving shapes, equal
    bit for bit to the plain bias rounded to bf16 and to the two wide
    forwards (``bias_siblings``); its plan, times beside ``grid_sample``'s,
    and their sums over a serving forward."""
    import torch

    rows, worst, bad = [], 0.0, []
    for i, (name, B, G, ch, N, Wt, per_fwd) in enumerate(BIAS_SITES):
        table, k_pos, *_ = site_inputs(10 + i, B, G, ch, N, Wt)
        args = da._kernel_args(table, k_pos, H, W)
        plan = fwd_plan(kernel_mod, "lattice_bias", B, G, N, Wt, H)
        out = kernel_mod.lattice_bias_cuda(*args, H, W)
        tb = table.bfloat16().float()
        ref32 = da.lattice_bias_plain(tb, k_pos, H, W, torch.float32)
        ref = ref32.bfloat16()
        same = bias_siblings(kernel_mod, out, ref, args, H)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        if not all(same.values()):
            bad.append(f"{name}: equal to {same}")
        worst = max(worst, err)
        launch = lambda: kernel_mod.lattice_bias_cuda(*args, H, W)  # noqa: E731
        ms = queued_ms(launch, 20)
        ev = events_ms(launch, 20)
        plain = queued_ms(lambda: da.lattice_bias_plain(tb, k_pos, H, W,
                                                        torch.float32), 5)
        lib = library_bias_ms(da, table, k_pos, None, H, ref32)["fwd_ms"]
        bound, by = bias_bounds(B, G, N, Wt, H, backward=False)
        rows.append(dict(site=name, ms=ms, events_ms=ev, plain_ms=plain,
                         library_ms=lib, bound_ms=bound, bound_by=by,
                         per_forward=per_fwd, max_abs_err=err, plan=plan))
        print(f"lattice_bias {name}: max_abs_err {err:.3g}, equal bit for "
              f"bit to {same}; kernel {ms:.4f} ms (events {ev:.4f}) plain "
              f"{plain:.4f} ms grid_sample {lib:.4f} ms bound {bound:.4f} ms "
              f"({by}) x{per_fwd}/forward; {fwd_plan_text(plan)}", flush=True)
    if bad:
        fail(f"lattice_bias differs at {bad}")
    return dict(rows=rows, worst=worst)


def site_bound(B, G, ch, N, Wt, extra_bytes=0, lse=False, side=H):
    """(bound ms, what bounds it) of a fused site forward at BEV side x
    side: bytes (q, k, v, the table, the geometry, the output, the
    logsumexp, and ``extra_bytes``) against 4 ch bf16 FLOP per (query, key)
    pair at the tensor-core rate plus 18 float32 operations (bias lerps,
    score, running max, exp, sum)."""
    M = side * side
    pairs = B * G * HPG * M * N
    q_el, kv_el = B * G * HPG * M * ch, B * G * HPG * N * ch
    nbytes = ((q_el + 2 * kv_el) * 2 + G * HPG * (2 * side - 1) * Wt * 2
              + B * G * N * 16 + side * 8 + q_el * 4
              + (B * G * HPG * M * 4 if lse else 0) + extra_bytes)
    t_ops = pairs * 4 * ch / BF16_FLOPS + pairs * 18 / F32_FLOPS
    by = "bytes" if nbytes / HBM_BPS >= t_ops else "operations"
    return max(nbytes / HBM_BPS, t_ops) * 1e3, by


def sdpa_ms(q, k, v, bias, scale, iters: int) -> float:
    """Yardstick of a fused site forward: PyTorch's attention on the same
    q, k, v in bf16 with the bias (not timed) as an additive mask."""
    import torch
    import torch.nn.functional as F

    bf, ch, M, N = torch.bfloat16, q.shape[-1], q.shape[-2], k.shape[-2]
    mask = bias.transpose(-1, -2).to(bf).reshape(-1, M, N).contiguous()
    qs, ks, vs = (x.to(bf).reshape(-1, x.shape[-2], ch) for x in (q, k, v))
    return queued_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, scale=scale), iters)


def site_errors(da, kernel_mod, seed, B, G, ch, N, Wt, table_std):
    """Run the fused-site kernel once at one shape and hold it against its
    plain version and against ``site_consumer_online``. Returns the errors,
    whether each is within tolerance, and the inputs."""
    import torch

    table, k_pos, q, k, v = site_inputs(seed, B, G, ch, N, Wt, table_std)
    scale = ch ** -0.5
    bf = torch.bfloat16
    kargs = da._kernel_args(table, k_pos, H, W) + (
        q.to(bf).contiguous(), k.to(bf).contiguous(), v.to(bf).contiguous())
    out = kernel_mod.fused_site_cuda(*kargs, H, W, scale)
    tb = table.bfloat16().float()
    bias = da.lattice_bias_plain(tb, k_pos, H, W, torch.float32)
    ref = da.site_consumer(q, k, v, bias, scale)
    wabs = da.site_consumer(q, k, v.abs(), bias, scale)  # p-weighted |v|
    d_plain = (out - ref).abs()
    d_online = (out - da.site_consumer_online(q, k, v, bias, scale)).abs()
    torch.cuda.synchronize()
    return dict(
        err=float(d_plain.max()), rel=float(d_plain.max() / ref.abs().max()),
        err_online=float(d_online.max()),
        online_over_wabs=float((d_online / wabs.clamp(min=1e-30)).max()),
        ok=bool((d_plain <= SITE_P_ROUND * wabs + 1e-5).all()),
        ok_online=bool((d_online <= ONLINE_TOL * wabs + 1e-7).all()),
        inputs=(table, k_pos, q, k, v, tb, kargs, scale))


def check_site(da, kernel_mod) -> dict:
    """Phase 4: ``fused_site`` at the flagship's serving shapes against its
    plain version and ``site_consumer_online`` at both table scales; its
    plan (``site_plan``), time, plain, SDPA and bound a shape."""
    import torch

    from bevrender_tpu_torch.ops import kernels

    rows, worst, worst_online, bad = [], 0.0, 0.0, []
    for i, (name, B, G, ch, N, Wt, per_fwd) in enumerate(SITE_SITES):
        for std in SITE_TABLE_STDS:
            e = site_errors(da, kernel_mod, 20 + i, B, G, ch, N, Wt, std)
            print(f"fused_site {name} table std {std}: max_abs_err "
                  f"{e['err']:.3g} (rel {e['rel']:.3g}, "
                  f"{'ok' if e['ok'] else 'FAIL'}); vs site_consumer_online "
                  f"{e['err_online']:.3g}, {e['online_over_wabs']:.3g} of "
                  f"p-weighted |v| ({'ok' if e['ok_online'] else 'FAIL'})",
                  flush=True)
            if not (e["ok"] and e["ok_online"]):
                bad.append(f"{name} std {std}")
            worst = max(worst, e["err"])
            worst_online = max(worst_online, e["err_online"])
            if std == SITE_TABLE_STDS[0]:
                kept = e
        table, k_pos, q, k, v, tb, kargs, scale = kept["inputs"]
        plan = site_plan(kernels, "fused_site", B, G, ch, Wt)
        launch = lambda: kernel_mod.fused_site_cuda(*kargs, H, W, scale)  # noqa: E731
        ms = queued_ms(launch, 20)
        ev = events_ms(launch, 20)
        plain = queued_ms(lambda: da.site_plain(q, k, v, k_pos, tb, H, W,
                                                scale, torch.float32), 5)
        bias = da.lattice_bias_plain(tb, k_pos, H, W, torch.float32)
        lib = sdpa_ms(q, k, v, bias, scale, 20)
        bound, by = site_bound(B, G, ch, N, Wt)
        rows.append(dict(site=name, ms=ms, events_ms=ev, plain_ms=plain,
                         library_ms=lib,
                         bound_ms=bound, bound_by=by, per_forward=per_fwd,
                         max_abs_err=kept["err"], rel_err=kept["rel"],
                         max_abs_err_online=kept["err_online"], plan=plan))
        print(f"fused_site {name}: kernel {ms:.4f} ms (events {ev:.4f}) "
              f"plain {plain:.4f} ms sdpa+mask {lib:.4f} ms bound "
              f"{bound:.4f} ms ({by}) x{per_fwd}/forward; "
              f"{site_plan_text(plan)}", flush=True)
    if bad:
        fail(f"fused_site beyond tolerance at {bad}")
    return dict(rows=rows, worst=worst, worst_online=worst_online)


# The wide-head eval site (fused_site_mma, head widths 16 and 32) at the
# flagship's call shapes in the registration cell (B=32 windows, T=4: four
# encoder passes a request, SCA view by view): (name, batch, G, ch, N, table
# width, launches of this shape a request)
MMA_SITES = [
    ("tsa_g1_ch32_n16", 32, 1, 32, 16, 55, 16),
    ("tsa_g2_ch16_n49", 32, 2, 16, 49, 55, 16),
    ("sca_g1_ch32_n1960", 32, 1, 32, 1960, 279, 48),
    ("sca_g2_ch16_n1960", 32, 2, 16, 1960, 279, 48),
]
# more shapes held to the plain versions: the pyramid's SCA at BEV 56 (its
# largest table), and its BEV 7 sites (an odd side: the last row's lower
# query masked); (name, batch, G, ch, N, table width, side)
MMA_CHECK_SITES = [
    ("pyr_sca56_g1_ch32_n7840", 2, 1, 32, 7840, 559, 56),
    ("pyr_sca7_g8_ch32_n140", 6, 8, 32, 140, 69, 7),
    ("pyr_tsa7_g8_ch32_n49", 2, 8, 32, 49, 13, 7),
]
# fused_site_mma against site_consumer_online, which rounds where the kernel
# rounds but sums q . k as an fmaf chain where the kernel's tensor cores sum
# in their own order: s moves by a few float32 ulps of the products' sum,
# which now and then flips the bf16 rounding of one p by one bf16 ulp (2^-7
# of p at most), moving the output by at most 2^-7 of that key's share of
# the p-weighted |v|. So every element is held to 2^-7 of the p-weighted
# |v| (one flip) and the share of elements beyond 2^-12 of it, which only
# flips reach, to MMA_FLIP_SHARE.
MMA_ONLINE_TOL = 2.0 ** -7
MMA_FLIP_TOL = 2.0 ** -12
MMA_FLIP_SHARE = 1e-3


def mma_errors(da, kernel_mod, seed, B, G, ch, N, Wt, table_std, side=H):
    """Run ``fused_site_mma`` once at one shape and hold it against its
    plain version (``site_consumer`` on the float32 bias of the bf16 table)
    and against ``site_consumer_online``."""
    import torch

    table, k_pos, q, k, v = site_inputs(seed, B, G, ch, N, Wt, table_std,
                                        side)
    scale = ch ** -0.5
    bf = torch.bfloat16
    kargs = da._kernel_args(table, k_pos, side, side) + (
        q.to(bf).contiguous(), k.to(bf).contiguous(), v.to(bf).contiguous())
    out = kernel_mod.fused_site_mma_cuda(*kargs, side, side, scale)
    tb = table.bfloat16().float()
    bias = da.lattice_bias_plain(tb, k_pos, side, side, torch.float32)
    ref = da.site_consumer(q, k, v, bias, scale)
    wabs = da.site_consumer(q, k, v.abs(), bias, scale)  # p-weighted |v|
    d_plain = (out - ref).abs()
    d_online = (out - da.site_consumer_online(q, k, v, bias, scale)).abs()
    torch.cuda.synchronize()
    flips = float((d_online > MMA_FLIP_TOL * wabs + 1e-7).float().mean())
    return dict(
        err=float(d_plain.max()), rel=float(d_plain.max() / ref.abs().max()),
        err_online=float(d_online.max()),
        online_over_wabs=float((d_online / wabs.clamp(min=1e-30)).max()),
        flip_share=flips,
        ok=bool((d_plain <= SITE_P_ROUND * wabs + 1e-5).all()),
        ok_online=bool((d_online <= MMA_ONLINE_TOL * wabs + 1e-6).all())
        and flips <= MMA_FLIP_SHARE,
        inputs=(table, k_pos, q, k, v, tb, kargs, scale))


def check_mma_site(da, kernels, warps_sweep: bool = False) -> dict:
    """``fused_site_mma`` at the registration cell's call shapes
    (``MMA_SITES``) and the pyramid's (``MMA_CHECK_SITES``) against its
    plain version and ``site_consumer_online`` at both table scales; at the
    cell's shapes its time, picoseconds a (query, key) pair, the plain
    version's time, the bias route (``lattice_bias`` and ``site_consumer``
    on its bf16 bias, which these sites took before the kernel), SDPA with
    the bias as a mask, and the bound; with ``warps_sweep`` its time at
    every block size."""
    import torch

    mod = kernels.fused_site_mma
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, checks, worst, worst_online, bad = [], [], 0.0, 0.0, []
    shapes = ([(n, B, G, ch, N, Wt, H) for n, B, G, ch, N, Wt, _ in MMA_SITES]
              + MMA_CHECK_SITES)
    for i, (name, B, G, ch, N, Wt, side) in enumerate(shapes):
        for std in SITE_TABLE_STDS:
            e = mma_errors(da, mod, 40 + i, B, G, ch, N, Wt, std, side)
            print(f"fused_site_mma {name} table std {std}: max_abs_err "
                  f"{e['err']:.3g} (rel {e['rel']:.3g}, "
                  f"{'ok' if e['ok'] else 'FAIL'}); vs site_consumer_online "
                  f"{e['err_online']:.3g}, {e['online_over_wabs']:.3g} of "
                  f"p-weighted |v|, share beyond 2^-12 of it "
                  f"{e['flip_share']:.3g} "
                  f"({'ok' if e['ok_online'] else 'FAIL'})", flush=True)
            checks.append(dict(site=name, table_std=std, err=e["err"],
                               err_online=e["err_online"],
                               online_over_wabs=e["online_over_wabs"],
                               flip_share=e["flip_share"]))
            if not (e["ok"] and e["ok_online"]):
                bad.append(f"{name} std {std}")
            worst = max(worst, e["err"])
            worst_online = max(worst_online, e["err_online"])
            if std == SITE_TABLE_STDS[0]:
                kept = e
            del e
        if i >= len(MMA_SITES):
            continue
        per_req = MMA_SITES[i][-1]
        table, k_pos, q, k, v, tb, kargs, scale = kept.pop("inputs")
        warps = mod.plan(B * G * HPG, H, W, sms)
        smem = mod.smem_bytes(2 * H - 1, kargs[7], ch)
        launch = lambda: mod.fused_site_mma_cuda(*kargs, H, W, scale)  # noqa: E731
        ms = queued_ms(launch, 20)
        ev = events_ms(launch, 20)
        sweep = {}
        if warps_sweep:
            for nw in range(1, mod.MAX_WARPS + 1):
                sweep[nw] = queued_ms(lambda: mod.fused_site_mma_cuda(
                    *kargs, H, W, scale, warps=nw), 10)
        plain = queued_ms(lambda: da.site_plain(q, k, v, k_pos, tb, H, W,
                                                scale, torch.float32), 3)
        route = queued_ms(lambda: da.site_consumer(
            q, k, v, kernels.lattice_bias.lattice_bias_cuda(*kargs[:8], H, W),
            scale), 3)
        bias = da.lattice_bias_plain(tb, k_pos, H, W, torch.float32)
        lib = sdpa_ms(q, k, v, bias, scale, 10)
        bound, by = site_bound(B, G, ch, N, Wt)
        pairs = B * G * HPG * H * W * N
        rows.append(dict(site=name, ms=ms, events_ms=ev, plain_ms=plain,
                         bias_route_ms=route, library_ms=lib,
                         bound_ms=bound, bound_by=by, per_request=per_req,
                         ps_a_pair=ms * 1e9 / pairs, warps=warps, smem=smem,
                         blocks_per_sm=mod.occupancy(ch, warps, smem),
                         warps_sweep_ms=sweep,
                         max_abs_err=kept["err"], rel_err=kept["rel"],
                         max_abs_err_online=kept["err_online"]))
        print(f"fused_site_mma {name}: kernel {ms:.4f} ms (events {ev:.4f}; "
              f"{ms * 1e9 / pairs:.3f} ps a pair) plain {plain:.4f} ms, the "
              f"bias route (lattice_bias + site_consumer) {route:.4f} "
              f"ms, sdpa+mask {lib:.4f} ms, bound {bound:.4f} ms ({by}) "
              f"x{per_req}/request; {warps} warps a block, {smem} B, "
              f"{rows[-1]['blocks_per_sm']} blocks an SM"
              + (f"; by warps {sweep}" if sweep else ""), flush=True)
        del table, k_pos, q, k, v, tb, kargs, bias, kept
        torch.cuda.empty_cache()
    total = sum(r["ms"] * r["per_request"] for r in rows)
    print(f"fused_site_mma over a registration request (B=32, T=4): "
          f"{total:.3f} ms; the bias route "
          f"{sum(r['bias_route_ms'] * r['per_request'] for r in rows):.3f} "
          f"ms", flush=True)
    if bad:
        fail(f"fused_site_mma beyond tolerance at {bad}")
    return dict(rows=rows, checks=checks, worst=worst,
                worst_online=worst_online, per_request_ms=total)


@contextlib.contextmanager
def plain_sites(da, online: bool = False, keep_mma: bool = False):
    """Route every lattice site through plain PyTorch on the card, fed as
    the kernels are (bf16-rounded table, float32 lerps, bf16 bias), with
    autograd. The fused sites take ``site_consumer`` (p rounded after
    normalising, as the JAX package's ``_site_xla``) or, with ``online``,
    the kernels' own roundings (``site_consumer_online`` forward,
    ``site_bwd_online`` backward). With ``keep_mma`` the eval sites of
    head widths 16 and 32 keep ``fused_site_mma``: its tensor-core sums of
    q . k differ from the mirror's fmaf chains in the last bits, which the
    small models carry to O(0.1) of a render or a gradient through the
    floors of their sampling positions (phase 5: 0.05 from sites within
    6e-7 of their mirror, where the two placements of p's rounding move it
    by 0.135), so a whole-model comparison holds every other site to
    its mirror and that kernel to its own, call by call
    (``mma_sites_checked``)."""
    import torch

    def rounded(t):
        # the bf16-rounded table as a float32 tensor whose gradient reaches
        # ``t`` unrounded, as the kernels' float32 table gradient does
        return t + (t.detach().bfloat16().float() - t.detach())

    def bias(t, p, h, w, kernel=None):
        return da.lattice_bias_plain(rounded(t), p, h, w,
                                     torch.float32).bfloat16()

    def site(q, k, v, p, t, h, w, scale, kernel=None):
        if keep_mma and kernel == "fused_site_mma":
            return saved[1](q, k, v, p, t, h, w, scale, kernel)
        b = da.lattice_bias_plain(rounded(t), p, h, w, torch.float32)
        consumer = da.site_consumer_online if online else da.site_consumer
        return consumer(q, k, v, b, scale)

    class OnlineSite(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, p, t, h, w, scale):
            b = da.lattice_bias_plain(t.bfloat16().float(), p, h, w,
                                      torch.float32)
            out, lse = da.site_consumer_online(q, k, v, b, scale,
                                               return_lse=True)
            ctx.save_for_backward(q, k, v, p, t, out, lse)
            ctx.meta = (h, w, scale)
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, p, t, out, lse = ctx.saved_tensors
            h, w, scale = ctx.meta
            dq, dk, dv, dt, dp = da.site_bwd_online(
                q, k, v, p, t, h, w, scale, dout, lse, (dout * out).sum(-1))
            return dq, dk, dv, dp, dt, None, None, None

    def site_train(q, k, v, p, t, h, w, scale, kernel=None):
        if online:
            return OnlineSite.apply(q, k, v, p, t, h, w, scale)
        return site(q, k, v, p, t, h, w, scale)

    saved = da.lattice_bias, da.fused_site, da.fused_site_train
    da.lattice_bias, da.fused_site, da.fused_site_train = bias, site, site_train
    try:
        yield
    finally:
        da.lattice_bias, da.fused_site, da.fused_site_train = saved


@contextlib.contextmanager
def mma_sites_checked(da):
    """Hold every ``fused_site_mma`` call made inside the context to
    ``site_consumer_online`` on its own inputs (MMA_ONLINE_TOL, MMA_FLIP_TOL,
    MMA_FLIP_SHARE), returning the kernel's output; yields the list of
    {shape, keys, online_over_wabs, flip_share, ok}, one a call."""
    import torch

    real, calls = da.fused_site, []

    def site(q, k, v, p, t, h, w, scale, kernel=None):
        out = real(q, k, v, p, t, h, w, scale, kernel)
        if kernel == "fused_site_mma":
            bias = da.lattice_bias_plain(t.detach().bfloat16().float(), p, h,
                                         w, torch.float32)
            d = (out - da.site_consumer_online(q, k, v, bias, scale)).abs()
            wabs = da.site_consumer(q, k, v.abs(), bias, scale)
            flips = float((d > MMA_FLIP_TOL * wabs + 1e-7).float().mean())
            calls.append(dict(
                shape=tuple(q.shape), keys=k.shape[-2],
                online_over_wabs=float((d / wabs.clamp(min=1e-30)).max()),
                flip_share=flips,
                ok=bool((d <= MMA_ONLINE_TOL * wabs + 1e-6).all())
                and flips <= MMA_FLIP_SHARE))
        return out

    da.fused_site = site
    try:
        yield calls
    finally:
        da.fused_site = real


# Sites of one flagship training step at B=2 (final pass, V=3):
# (name, batch, G, ch, N, table width, launches of this shape per step).
# The bias backward runs at all of them under the default route; the
# logsumexp forward and the site backward at the four narrow ones (ch 4, 8)
# under fused_bwd.
TRAIN_BIAS_SITES = [
    ("tsa_g1_n16", 2, 1, 32, 16, 55, 4),
    ("tsa_g2_n49", 2, 2, 16, 49, 55, 4),
    ("tsa_g4_n196", 2, 4, 8, 196, 55, 4),
    ("tsa_g8_n784", 2, 8, 4, 784, 55, 2),
    ("sca_g1_n1960", 2, 1, 32, 1960, 279, 12),
    ("sca_g2_n1960", 2, 2, 16, 1960, 279, 12),
    ("sca_g4_n1960", 6, 4, 8, 1960, 279, 4),
    ("sca_g8_n1960", 6, 8, 4, 1960, 279, 2),
]
TRAIN_SITE_SITES = [
    ("tsa_g4_ch8_n196", 2, 4, 8, 196, 55, 4),
    ("tsa_g8_ch4_n784", 2, 8, 4, 784, 55, 2),
    ("sca_g4_ch8_n1960", 6, 4, 8, 1960, 279, 4),
    ("sca_g8_ch4_n1960", 6, 8, 4, 1960, 279, 2),
]


def rel_err(a, b) -> float:
    """Largest absolute difference as a share of b's largest entry."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def check_bias_bwd(da, kernel_mod, wide: bool = False) -> dict:
    """lattice_bias_bwd against autograd through the plain bias at every
    shape of a training step, at the init's table scale and at std 1.0; the
    forward kernel's output at those shapes against the plain bias too; two
    runs of the backward equal bit for bit at both scales and, at the
    init's, its dtable equal to ``lattice_bias_bwd_ordered`` under its plan.
    The forward equals the plain bias rounded to bf16 bit for bit, and
    ``lattice_bias`` equals the two wide forwards (``bias_siblings``).
    With ``wide``, the wide kernels (``lattice_route="wide"``) at the same
    shapes, the forward also against the whole-table one bit for bit; their
    launches per step are those of phase 16 (``fused_bwd``: the narrow
    sites take the fused site instead). Times at the init's scale, with
    ``grid_sampler_2d_backward``'s as the library time; without ``wide``,
    also the forward's (``fwd_rows``: a default-route step launches it at
    the final pass and its recomputation, and at the history pass where the
    head width is over 8), with ``F.grid_sample``'s."""
    import torch

    from bevrender_tpu_torch.ops.kernels import lattice_bias as fwd_mod

    fwd_kernel = "lattice_bias_wide" if wide else None
    bwd_call = (kernel_mod.lattice_bias_wide_bwd_cuda if wide
                else kernel_mod.lattice_bias_bwd_cuda)
    tag = "lattice_bias_wide_bwd" if wide else "lattice_bias_bwd"
    rows, fwd_rows, worst, worst_fwd, bad = [], [], 0.0, 0.0, []
    for i, (name, B, G, ch, N, Wt, per_step) in enumerate(TRAIN_BIAS_SITES):
        if wide and ch <= 8:
            per_step = 0
        plan = bwd_plan(kernel_mod, wide, B, G, N, Wt, H)
        fplan = (None if wide else
                 fwd_plan(fwd_mod, "lattice_bias", B, G, N, Wt, H))
        for std in SITE_TABLE_STDS:
            table, k_pos, *_ = site_inputs(40 + i, B, G, ch, N, Wt, std)
            gen = torch.Generator(device="cuda").manual_seed(50 + i)
            gout = torch.randn(B, G, HPG, N, H * W, generator=gen,
                               device="cuda").bfloat16()
            t1 = table.clone().requires_grad_()
            p1 = k_pos.clone().requires_grad_()
            fwd = da.lattice_bias(t1, p1, H, W, fwd_kernel)
            dt, dp = torch.autograd.grad(fwd, (t1, p1), gout)
            t2 = table.bfloat16().float().requires_grad_()
            p2 = k_pos.clone().requires_grad_()
            ref = da.lattice_bias_plain(t2, p2, H, W, torch.float32)
            rdt, rdp = torch.autograd.grad(ref, (t2, p2), gout.float(),
                                           retain_graph=True)
            # the forward kernel at this training shape, as check_bias holds
            # it at the serving shapes: the plain bias rounded to bf16, bit
            # for bit
            args = da._kernel_args(table, k_pos, H, W)
            with torch.no_grad():
                rb = ref.bfloat16()
                e_f = float((fwd.float() - rb.float()).abs().max())
                same_f = (dict(plain=torch.equal(fwd, rb), lattice_bias=(
                    torch.equal(fwd, da.lattice_bias(table, k_pos, H, W))))
                    if wide else bias_siblings(fwd_mod, fwd, rb, args, H))
                ok_f = all(same_f.values())
                del rb
            timed = std == SITE_TABLE_STDS[0]
            with torch.no_grad():
                same, mirror = check_bwd_order(
                    kernel_mod, bwd_call, args, gout, H, plan if timed else None,
                    (dt, *bwd_call(*args, gout, H, W)[1:]))
            torch.cuda.synchronize()
            e_t, e_p = rel_err(dt, rdt), rel_err(dp, rdp)
            ok = (ok_f and e_t <= BWD_SUM_TOL and e_p <= BWD_SUM_TOL and same
                  and mirror is not False and bool(
                      torch.isfinite(dt).all() and torch.isfinite(dp).all()))
            print(f"{tag} {name} table std {std}: forward max "
                  f"abs err {e_f:.3g}, equal bit for bit to {same_f}; "
                  f"dtable rel err {e_t:.3g}, dk_pos rel err "
                  f"{e_p:.3g}; two runs {'equal' if same else 'DIFFER'}"
                  + ("" if mirror is None else
                     f", dtable {'equals' if mirror else 'DIFFERS FROM'} "
                     f"lattice_bias_bwd_ordered")
                  + f" ({'ok' if ok else 'FAIL'})", flush=True)
            worst_fwd = max(worst_fwd, e_f)
            del fwd
            if not ok:
                bad.append(f"{name} std {std}")
            if timed:
                err = float((dt - rdt).abs().max())
                worst = max(worst, err)
                launch = lambda: bwd_call(*args, gout, H, W)  # noqa: E731
                ms = queued_ms(launch, 10)
                ev = events_ms(launch, 10)
                gf = gout.float()
                plain = queued_ms(lambda: torch.autograd.grad(
                    ref, (t2, p2), gf, retain_graph=True), 3)
                lib = library_bias_ms(da, table, k_pos, gout, H,
                                      ref.detach())
                bound, by = bias_bounds(B, G, N, Wt, H, backward=True)
                if not wide:
                    ms_f = queued_ms(lambda: fwd_mod.lattice_bias_cuda(
                        *args, H, W), 10)
                    b_f = bias_bounds(B, G, N, Wt, H, backward=False)
                    fwd_rows.append(dict(
                        site=name, ms=ms_f, library_ms=lib["fwd_ms"],
                        bound_ms=b_f[0], bound_by=b_f[1],
                        per_step=per_step * (3 if ch > 8 else 2),
                        max_abs_err=e_f, plan=fplan))
                    print(f"lattice_bias {name}: kernel {ms_f:.4f} ms "
                          f"grid_sample {lib['fwd_ms']:.4f} ms bound "
                          f"{b_f[0]:.4f} ms ({b_f[1]}) "
                          f"x{fwd_rows[-1]['per_step']}/step; "
                          f"{fwd_plan_text(fplan)}", flush=True)
                rows.append(dict(site=name, ms=ms, events_ms=ev,
                                 plain_ms=plain, library_ms=lib["bwd_ms"],
                                 bound_ms=bound, bound_by=by,
                                 per_step=per_step, max_abs_err=err,
                                 rel_err_dtable=e_t, rel_err_dkpos=e_p,
                                 plan=plan))
                print(f"{tag} {name}: kernel {ms:.4f} ms (events "
                      f"{ev:.4f}) plain {plain:.4f} ms "
                      f"grid_sampler_2d_backward {lib['bwd_ms']:.4f} ms bound "
                      f"{bound:.4f} ms ({by}) x{per_step}/step; "
                      f"{plan_text(plan)}", flush=True)
            del ref, rdt, rdp, dt, dp, args
        torch.cuda.empty_cache()
    if bad:
        fail(f"{tag} beyond tolerance at {bad}")
    return dict(rows=rows, worst=worst, worst_fwd=worst_fwd,
                fwd_rows=fwd_rows)


# The bias sites of the pyramid at B=2 (serving and training alike): (name,
# H, batch, G, N, table width). Folded SCA at B*V=6. The wide kernels are
# also held at TSA 56, which takes the whole-table ones on the main path.
PYR_BIAS_SITES = [
    ("tsa56_g1_n49", 56, 2, 1, 49, 111),
    ("sca56_g1_n7840", 56, 2, 1, 7840, 559),
    ("tsa28_g2_n49", 28, 2, 2, 49, 55),
    ("sca28_g2_n1960", 28, 2, 2, 1960, 279),
    ("tsa14_g4_n49", 14, 2, 4, 49, 27),
    ("sca14_bv6_g4_n490", 14, 6, 4, 490, 139),
    ("tsa7_g8_n49", 7, 2, 8, 49, 13),
    ("sca7_bv6_g8_n140", 7, 6, 8, 140, 69),
]
# launches per serving forward of each shape (both passes; training steps
# launch 1.5x as many forwards and 0.5x as many backwards): TSA 2 per
# stage-layer, SCA 6 per stage-layer at stages 0, 1, 5, 6 (3 views), 2 at
# stages 2-4 (folded); stages 0/6, 1/5 and 2/4 share their shapes
PYR_BIAS_PER_FORWARD = {
    "tsa56_g1_n49": 8, "sca56_g1_n7840": 24, "tsa28_g2_n49": 8,
    "sca28_g2_n1960": 24, "tsa14_g4_n49": 8, "sca14_bv6_g4_n490": 8,
    "tsa7_g8_n49": 4, "sca7_bv6_g8_n140": 4,
}
PYR_WIDE_SITES = ("tsa56_g1_n49", "sca56_g1_n7840")


def bias_inputs(seed, B, G, N, Wt, H, table_std):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randn(G, HPG, 2 * H - 1, Wt, generator=g,
                        device="cuda") * table_std
    k_pos = torch.rand(B, G, N, 2, generator=g, device="cuda") * 2.4 - 1.2
    gout = torch.randn(B, G, HPG, N, H * H, generator=g,
                       device="cuda").bfloat16()
    return table, k_pos, gout


def bias_bounds(B, G, N, Wt, H, backward: bool):
    """(bound ms, what bounds it) of the bias forward or backward: bytes
    (each input read once, each output written once) against float32
    operations (forward 12 per element: phi, floor, frac and three lerps of
    three; backward 28: window fractions 3, two x-lerps 6, the tail 15 (dwy
    3, d0/d1 3, df 7, 1 - wx, 4 weights as 2 per pair of corners) and 4 adds
    into the table gradient) at the H100's published peaks."""
    elems = B * G * HPG * N * H * H
    table = G * HPG * (2 * H - 1) * Wt
    if backward:
        nbytes = elems * 2 + table * (2 + 4) + B * G * N * (16 + 8) + H * 8
        ops = elems * 28
    else:
        nbytes = elems * 2 + table * 2 + B * G * N * 16 + H * 8
        ops = elems * 12
    by = "bytes" if nbytes / HBM_BPS >= ops / F32_FLOPS else "operations"
    return max(nbytes / HBM_BPS, ops / F32_FLOPS) * 1e3, by


def grid_sample_args(da, table, k_pos, gout, H):
    """The bias and its backward as one PyTorch call computes them, up to
    rounding: ``grid_sample`` (bilinear, zero padding, align_corners) of
    the raw bf16 table, as float32, at (ys + iy + wy - PAD, ms + u0[ix] +
    g[ix] + f - PAD), the clipped starts plus the fractions as the kernels
    read them. Returns (input (G, Hpg, Ht, Wt), grid (G, B N H, W, 2), the
    cotangent ``gout`` as (G, Hpg, B N H, W)), all float32 and contiguous,
    so that one call serves every head and the permutes stay outside it;
    the cotangent None where ``gout`` is None."""
    import torch

    G, Hpg, Ht, Wt = table.shape
    B, _, N = k_pos.shape[:3]
    ys, ms, wy, f = da.lattice_geometry(table.shape, k_pos, H, H)
    u0, g = da._comb_tensors(Wt, H, table.device)
    iy = torch.arange(H, device=table.device, dtype=torch.float32)
    y = (ys.float() + wy - da.PAD)[..., None] + iy  # (B, G, N, H)
    x = (ms.float() + f - da.PAD)[..., None] + (u0.float() + g)  # (B, G, N, W)
    gy = (y * (2.0 / (Ht - 1)) - 1.0)[..., None].expand(B, G, N, H, H)
    gx = (x * (2.0 / (Wt - 1)) - 1.0)[..., None, :].expand(B, G, N, H, H)
    grid = torch.stack((gx, gy), -1).permute(1, 0, 2, 3, 4, 5).reshape(
        G, B * N * H, H, 2).contiguous()
    go = None if gout is None else gout.view(B, G, Hpg, N, H, H).permute(
        1, 2, 0, 3, 4, 5).reshape(G, Hpg, B * N * H, H).float().contiguous()
    return table.bfloat16().float().contiguous(), grid, go


def library_bias_ms(da, table, k_pos, gout, H, ref=None) -> dict:
    """Times of the one PyTorch call that computes the bias
    (``F.grid_sample``) and, given ``gout``, of the one that computes its
    backward (``grid_sampler_2d_backward``, the input's and the grid's
    gradients) at these inputs (``grid_sample_args``); with ``ref``, the
    plain bias, the phase fails unless grid_sample's output is within
    GRID_SAMPLE_TOL of it. Used only as a yardstick."""
    import torch

    inp, grid, go = grid_sample_args(da, table, k_pos, gout, H)

    def fwd():
        return torch.nn.functional.grid_sample(
            inp, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)

    res = dict(fwd_ms=queued_ms(fwd, 5))
    if ref is not None:
        B, G, Hpg, N, _ = ref.shape
        got = fwd().view(G, Hpg, B, N, H * H).permute(2, 0, 1, 3, 4)
        err = rel_err(got, ref.float())
        if not err <= GRID_SAMPLE_TOL:
            fail(f"grid_sample differs from the plain bias by {err:.3g} of "
                 f"its largest entry: the yardstick's grid is wrong")
        res["fwd_rel_err"] = err
    if gout is not None:
        res["bwd_ms"] = queued_ms(
            lambda: torch.ops.aten.grid_sampler_2d_backward(
                go, inp, grid, 0, 0, True, [True, True]), 5)
    return res


def bwd_plan(bwd_mod, wide: bool, B, G, N, Wt, H) -> dict:
    """The bias backward's plan at a shape (``lattice_bias_bwd.plan``) and
    the blocks one SM holds of it (the library's ``<kernel>_occupancy``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import torch

    from bevrender_tpu_torch.ops.kernels._launch import blocks_per_sm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = bwd_mod.plan(B, G, HPG, 2 * H - 1, Wt, N, H, H, sms)
    name = "lattice_bias_wide_bwd" if wide else "lattice_bias_bwd"
    return dict(p._asdict(), blocks=B * G * HPG * p.bands * p.runs,
                blocks_per_sm=blocks_per_sm(name, f"{name}_occupancy", H,
                                            p.smem))


def plan_text(plan: dict) -> str:
    return (f"plan {plan['rows']} rows x {plan['bands']} bands, "
            f"{plan['runs']} runs of {plan['keys']} keys, {plan['smem']} B, "
            f"{plan['blocks']} blocks, {plan['blocks_per_sm']} an SM")


def fwd_plan(fwd_mod, kernel: str, B, G, N, Wt, H) -> dict:
    """A bias forward's plan at a shape (``lattice_bias.fwd_plan`` of
    ``kernel``: ``lattice_bias``, ``lattice_bias_wide`` or
    ``lattice_bias_wide_prefetch``) and the blocks one SM holds of it (the
    library's ``<kernel>_occupancy``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import torch

    from bevrender_tpu_torch.ops.kernels._launch import blocks_per_sm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = fwd_mod.fwd_plan(B, G, HPG, 2 * H - 1, Wt, N, H, H, sms, kernel)
    whole = (int(p.path == "whole"),)
    args = {"lattice_bias": whole, "lattice_bias_wide": (),
            "lattice_bias_wide_prefetch": whole}[kernel] + (H, p.smem)
    return dict(p._asdict(), blocks_per_sm=blocks_per_sm(
        kernel, f"{kernel}_occupancy", *args))


def fwd_plan_text(plan: dict) -> str:
    return (f"plan {plan['path']}, {plan['runs']} runs of {plan['keys']} "
            f"keys a head, {plan['strips']} strips of {plan['rows']} rows, "
            f"{plan['smem']} B, {plan['blocks']} blocks, "
            f"{plan['blocks_per_sm']} an SM")


def site_plan(kernels, kernel: str, B, G, ch, Wt, side=H) -> dict:
    """The plan of a whole-table site kernel (``fused_site`` and its
    logsumexp instance: ``fused_site.site_plan``; ``fused_site_wide`` and
    its logsumexp instance: ``fused_site_wide.wide_plan``;
    ``fused_site_fold_rows``: ``fused_site_fold.rows_plan``) at a shape of
    BEV side x side on this card, with the blocks one SM holds of it (the
    library's occupancy query) beside the blocks an SM the plan counts
    on."""
    import torch

    from bevrender_tpu_torch.ops.kernels._launch import padded_width

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    Ht = 2 * side - 1
    if kernel in ("fused_site", "fused_site_lse"):
        fs = kernels.fused_site
        p = fs.site_plan(B, G, HPG, Ht, padded_width(Wt), side, side, ch, sms)
        on_card = fs.site_blocks_per_sm(p, ch)
    elif kernel == "fused_site_fold_rows":
        fold = kernels.fused_site_fold
        p = fold.rows_plan(B, G, HPG, Ht, padded_width(Wt), side, side, ch,
                           sms)
        on_card = fold.rows_blocks_per_sm(p, ch)
    else:
        wide = kernels.fused_site_wide
        p = wide.wide_plan(Ht, Wt, side, side, ch, B * G * HPG, sms)
        on_card = wide.wide_blocks_per_sm(p, ch)
    return dict(p._asdict(), blocks_per_sm=on_card)


def site_plan_text(plan: dict) -> str:
    return (f"plan {plan['path']}, {plan['heads']} head x {plan['strip']} "
            f"queries a block, {plan['smem']} B, {plan['blocks']} blocks, "
            f"{plan['per_sm']} an SM planned ({plan['blocks_per_sm']} on "
            f"the card), {plan['waves']} wave(s)")


def bias_siblings(fwd_mod, out, ref, args, H) -> dict:
    """``lattice_bias``'s output ``out`` against the plain bias (float32
    lerps on the bf16 table) rounded to bf16, ``ref``, and against
    ``lattice_bias_wide`` and ``lattice_bias_wide_prefetch`` on the same
    inputs (``args``, from ``_kernel_args``): {name: equal bit for bit}."""
    import torch

    return {"plain": torch.equal(out, ref),
            "lattice_bias_wide": torch.equal(
                out, fwd_mod.lattice_bias_wide_cuda(*args[:7], H, H)),
            "lattice_bias_wide_prefetch": torch.equal(
                out, fwd_mod.lattice_bias_wide_prefetch_cuda(*args[:7], H, H))}


def sum_text(rows: list, per: str) -> str:
    """Kernel and ``grid_sample`` times summed over a forward or step's
    launches of every shape in ``rows``."""
    ms = sum(r["ms"] * r[per] for r in rows)
    lib = sum(r["library_ms"] * r[per] for r in rows)
    return (f"{ms:.4f} ms (grid_sample {lib:.4f}; "
            f"{sum(r[per] for r in rows)} launches)")


def check_bwd_order(bwd_mod, bwd_call, args, gout, H, plan, first):
    """A second run of the bias backward ``bwd_call`` equal to the ``first``
    (dtable, dwy, df) bit for bit and, with ``plan``, dtable equal to
    ``lattice_bias_bwd_ordered`` under that plan. Returns (same as the
    second run, equal to the mirror or None)."""
    import torch

    again = bwd_call(*args, gout, H, H)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    del again
    if plan is None:
        return same, None
    p = bwd_mod.Plan(*(plan[k] for k in bwd_mod.Plan._fields))
    ref = bwd_mod.lattice_bias_bwd_ordered(*args, gout, H, H, p)
    mirror = torch.equal(first[0], ref[0])
    del ref
    torch.cuda.empty_cache()
    return same, mirror


def check_pyramid_bias(da, kernels) -> dict:
    """The bias kernels at every pyramid shape, forward equal bit for bit
    to the plain version rounded to bf16 (``lattice_bias`` also to the two
    wide forwards, ``bias_siblings``) and backward against autograd through
    it (BWD_SUM_TOL of the largest entry), at two table scales: the
    whole-table kernels at every shape, the wide ones at BEV 56. Two runs of
    the backward equal bit for bit, and at table std 0.01 its dtable equal to
    ``lattice_bias_bwd_ordered`` under its plan. Times at table std 0.01,
    with ``grid_sample``'s forward and backward as the library times; the
    plain version's peak memory at SCA 56."""
    import torch

    fwd = kernels.lattice_bias
    bwd = kernels.lattice_bias_bwd
    out_rows = {k: [] for k in ("lattice_bias", "lattice_bias_wide",
                                "lattice_bias_bwd", "lattice_bias_wide_bwd")}
    worst = {k: 0.0 for k in out_rows}
    bad = []
    for i, (name, H, B, G, N, Wt) in enumerate(PYR_BIAS_SITES):
        routes = ["whole"] + (["wide"] if name in PYR_WIDE_SITES else [])
        if da.bias_route((G, HPG, 2 * H - 1, Wt), H, H) == "wide":
            routes = ["wide"]
        plans = {r: bwd_plan(bwd, r == "wide", B, G, N, Wt, H) for r in routes}
        fkern = {r: "lattice_bias_wide" if r == "wide" else "lattice_bias"
                 for r in routes}
        fplans = {r: fwd_plan(fwd, fkern[r], B, G, N, Wt, H) for r in routes}
        for r in routes:
            print(f"pyramid {fkern[r]} {name}: {fwd_plan_text(fplans[r])}",
                  flush=True)
        for std in SITE_TABLE_STDS:
            table, k_pos, gout = bias_inputs(70 + i, B, G, N, Wt, H, std)
            args = da._kernel_args(table, k_pos, H, H)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t2 = table.bfloat16().float().requires_grad_()
            p2 = k_pos.clone().requires_grad_()
            ref = da.lattice_bias_plain(t2, p2, H, H, torch.float32)
            rdt, rdp = torch.autograd.grad(ref, (t2, p2), gout.float(),
                                           retain_graph=True)
            plain_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            rb = ref.detach().bfloat16()
            timed = std == SITE_TABLE_STDS[0]
            lib = (library_bias_ms(da, table, k_pos, gout, H, ref.detach())
                   if timed else None)
            for route in routes:
                wide = route == "wide"
                kf, kb = (("lattice_bias_wide", "lattice_bias_wide_bwd")
                          if wide else ("lattice_bias", "lattice_bias_bwd"))

                def f_launch():
                    if wide:
                        return fwd.lattice_bias_wide_cuda(*args[:7], H, H)
                    return fwd.lattice_bias_cuda(*args, H, H)

                def b_launch():
                    call = (bwd.lattice_bias_wide_bwd_cuda if wide
                            else bwd.lattice_bias_bwd_cuda)
                    return call(*args, gout, H, H)

                with torch.no_grad():
                    out = f_launch()
                    dt, dwy, df = b_launch()
                    same, mirror = check_bwd_order(
                        bwd, (bwd.lattice_bias_wide_bwd_cuda if wide
                              else bwd.lattice_bias_bwd_cuda), args, gout, H,
                        plans[route] if timed else None, (dt, dwy, df))
                # dk_pos from the kernels' dwy, df through the geometry, as
                # _LatticeBiasFn hands them to autograd
                p3 = k_pos.clone().requires_grad_()
                _, _, wy3, f3 = da.lattice_geometry(table.shape, p3, H, H)
                (dp,) = torch.autograd.grad((wy3, f3), p3, (dwy, df))
                torch.cuda.synchronize()
                e_f = (out.float() - rb.float()).abs()
                with torch.no_grad():
                    same_f = (dict(plain=torch.equal(out, rb)) if wide else
                              bias_siblings(fwd, out, rb, args, H))
                ok_f = all(same_f.values())
                e_t, e_p = rel_err(dt, rdt), rel_err(dp, rdp)
                ok = (ok_f and e_t <= BWD_SUM_TOL and e_p <= BWD_SUM_TOL
                      and same and mirror is not False
                      and bool(torch.isfinite(dt).all()))
                print(f"pyramid bias {route} {name} table std {std}: forward "
                      f"max abs err {float(e_f.max()):.3g}, equal bit for "
                      f"bit to {same_f}; "
                      f"dtable rel err {e_t:.3g}, dk_pos rel err {e_p:.3g}; "
                      f"two runs {'equal' if same else 'DIFFER'}"
                      + ("" if mirror is None else
                         f", dtable {'equals' if mirror else 'DIFFERS FROM'} "
                         f"lattice_bias_bwd_ordered")
                      + f" ({'ok' if ok else 'FAIL'}); plain version's peak "
                      f"{plain_gib:.3f} GiB", flush=True)
                if not ok:
                    bad.append(f"{route} {name} std {std}")
                if not timed:
                    continue
                worst[kf] = max(worst[kf], float(e_f.max()))
                worst[kb] = max(worst[kb], float((dt - rdt).abs().max()))
                ms_f = queued_ms(f_launch, 10)
                ms_b = queued_ms(b_launch, 5)
                plain_f = queued_ms(lambda: da.lattice_bias_plain(
                    t2, p2, H, H, torch.float32), 3)
                gf = gout.float()
                plain_b = queued_ms(lambda: torch.autograd.grad(
                    ref, (t2, p2), gf, retain_graph=True), 3)
                per = PYR_BIAS_PER_FORWARD[name] if (route == da.bias_route(
                    table.shape, H, H)) else 0
                # a training step runs the history pass, the final pass and
                # its recomputation forward, and the final pass backward
                for kname, ms, plain, err, launches in (
                        (kf, ms_f, plain_f, float(e_f.max()),
                         dict(per_forward=per, per_step=per * 3 // 2,
                              plan=fplans[route])),
                        (kb, ms_b, plain_b, float((dt - rdt).abs().max()),
                         dict(per_step=per // 2, plan=plans[route]))):
                    bound, by = bias_bounds(B, G, N, Wt, H, kname == kb)
                    lib_ms = lib["bwd_ms" if kname == kb else "fwd_ms"]
                    out_rows[kname].append(dict(
                        site=name, ms=ms, plain_ms=plain, bound_ms=bound,
                        bound_by=by, library_ms=lib_ms, max_abs_err=err,
                        plain_peak_gib=plain_gib, **launches))
                    print(f"pyramid {kname} {name}: kernel {ms:.4f} ms plain "
                          f"{plain:.4f} ms grid_sample {lib_ms:.4f} ms bound "
                          f"{bound:.4f} ms ({by}); launches {launches}"
                          + (f"; {plan_text(plans[route])}" if kname == kb
                             else f"; {fwd_plan_text(fplans[route])}"),
                          flush=True)
                del out, dt, dwy, df, dp
            del ref, rdt, rdp, rb, t2, p2, table, k_pos, gout, args
            torch.cuda.empty_cache()
    if bad:
        fail(f"pyramid bias kernels beyond tolerance at {bad}")
    return {k: dict(rows=v, worst=worst[k]) for k, v in out_rows.items()}


def site_bwd_errors(da, kernels, seed, B, G, ch, N, Wt, table_std):
    """Run the fused training site (logsumexp forward, fused backward) once
    at one shape and hold it against its plain versions and against the
    online mirrors. Returns the errors and what the timings reuse."""
    import torch

    table, k_pos, q, k, v = site_inputs(seed, B, G, ch, N, Wt, table_std)
    scale = ch ** -0.5
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    kargs = da._kernel_args(table, k_pos, H, W) + (
        q.to(bf).contiguous(), k.to(bf).contiguous(), v.to(bf).contiguous())
    with torch.no_grad():
        out, lse = kernels.fused_site.fused_site_lse_cuda(*kargs, H, W, scale)
        base = kernels.fused_site.fused_site_cuda(*kargs, H, W, scale)
        tb = table.bfloat16().float()
        bias = da.lattice_bias_plain(tb, k_pos, H, W, torch.float32)
        _, on_lse = da.site_consumer_online(q, k, v, bias, scale,
                                            return_lse=True)
        del bias
    a = [t.clone().requires_grad_() for t in (q, k, v, k_pos, table)]
    got = torch.autograd.grad(da.fused_site_train(*a, H, W, scale), a, dout)
    b = [t.clone().requires_grad_() for t in (q, k, v, k_pos)]
    tbg = tb.clone().requires_grad_()
    ref_out, ref_lse = da.site_plain_lse(*b, tbg, H, W, scale, torch.float32)
    ref = torch.autograd.grad(ref_out, b + [tbg], dout, retain_graph=True)
    dsum = (dout * out).sum(-1)
    on = da.site_bwd_online(q, k, v, k_pos, table, H, W, scale, dout, lse, dsum)
    on = on[:3] + (on[4], on[3])  # (dq, dk, dv, dk_pos, dtable)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "dk_pos", "dtable")
    e_plain = {n: rel_err(x, r) for n, x, r in zip(names, got, ref)}
    e_online = {n: rel_err(x, o) for n, x, o in zip(names, got, on)}
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    return dict(
        same_out=bool(torch.equal(out, base)),
        lse_err=float((lse - ref_lse.detach()).abs().max()),
        lse_err_online=float((lse - on_lse).abs().max()),
        e_plain=e_plain, e_online=e_online, finite=finite,
        abs_err=max(float((x - r).abs().max()) for x, r in zip(got, ref)),
        abs_err_online=max(float((x - o).abs().max()) for x, o in zip(got, on)),
        keep=(table, k_pos, q, k, v, kargs, scale, dout, lse, dsum, ref_out,
              b + [tbg]))


def check_site_train(da, kernels) -> tuple:
    """fused_site_lse and fused_site_bwd at the narrow sites of a training
    step. Returns (lse record, backward record)."""
    import torch
    import torch.nn.functional as F

    rows_l, rows_b, bad = [], [], []
    worst = dict(lse=0.0, lse_online=0.0, bwd=0.0, bwd_online=0.0)
    for i, (name, B, G, ch, N, Wt, per_step) in enumerate(TRAIN_SITE_SITES):
        for std in SITE_TABLE_STDS:
            e = site_bwd_errors(da, kernels, 60 + i, B, G, ch, N, Wt, std)
            ok = (e["same_out"] and e["finite"] and e["lse_err"] <= LSE_TOL
                  and e["lse_err_online"] <= LSE_ONLINE_TOL
                  and max(e["e_plain"].values()) <= SITE_BWD_TOL
                  and max(e["e_online"].values()) <= SITE_BWD_ONLINE_TOL)
            fmt = lambda d: " ".join(f"{k} {v:.2g}" for k, v in d.items())  # noqa: E731
            print(f"fused_site_lse/bwd {name} table std {std}: out "
                  f"{'equals' if e['same_out'] else 'DIFFERS FROM'} fused_site; "
                  f"lse err {e['lse_err']:.3g} (online {e['lse_err_online']:.3g}); "
                  f"grads vs autograd(site_plain) [{fmt(e['e_plain'])}]; vs "
                  f"site_bwd_online [{fmt(e['e_online'])}] "
                  f"({'ok' if ok else 'FAIL'})", flush=True)
            if not ok:
                bad.append(f"{name} std {std}")
            if std == SITE_TABLE_STDS[0]:
                kept = e
            else:
                del e
            torch.cuda.empty_cache()
        worst["lse"] = max(worst["lse"], kept["lse_err"])
        worst["lse_online"] = max(worst["lse_online"], kept["lse_err_online"])
        worst["bwd"] = max(worst["bwd"], kept["abs_err"])
        worst["bwd_online"] = max(worst["bwd_online"], kept["abs_err_online"])
        (table, k_pos, q, k, v, kargs, scale, dout, lse, dsum, ref_out,
         leaves) = kept["keep"]
        bf = torch.bfloat16
        plan = site_plan(kernels, "fused_site_lse", B, G, ch, Wt)
        fwd = lambda: kernels.fused_site.fused_site_lse_cuda(  # noqa: E731
            *kargs, H, W, scale)
        bwd = lambda: kernels.fused_site_bwd.fused_site_bwd_cuda(  # noqa: E731
            *kargs, dout, lse, dsum, H, W, scale)
        ms_l = queued_ms(fwd, 10)
        ms_b = queued_ms(bwd, 5)
        ev_b = events_ms(bwd, 5)
        tb = table.bfloat16().float()
        with torch.no_grad():
            plain_l = queued_ms(lambda: da.site_plain_lse(
                q, k, v, k_pos, tb, H, W, scale, torch.float32), 3)
        plain_b = queued_ms(lambda: torch.autograd.grad(
            ref_out, leaves, dout, retain_graph=True), 3)
        # yardstick: PyTorch's attention with the bias as an additive mask
        # that requires grad; forward for the lse instance, autograd.grad
        # through it for the backward (the bias itself is not timed)
        with torch.no_grad():
            bias = da.lattice_bias_plain(tb, k_pos, H, W, torch.float32)
            mask = bias.transpose(-1, -2).to(bf).reshape(
                -1, H * W, N).contiguous()
            del bias
        qs, ks, vs = (x.to(bf).reshape(-1, x.shape[-2], ch).requires_grad_()
                      for x in (q, k, v))
        with torch.no_grad():
            lib_l = queued_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, scale=scale), 10)
        mask.requires_grad_()
        sd = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                            scale=scale)
        dob = dout.to(bf).reshape(sd.shape)
        lib_b = queued_ms(lambda: torch.autograd.grad(
            sd, (qs, ks, vs, mask), dob, retain_graph=True), 3)
        del sd, mask
        pairs = B * G * HPG * H * W * N
        geo = B * G * N * 16 + W * 8
        by_b = ((q.numel() + k.numel() + v.numel()) * 2 + dout.numel() * 4
                + lse.numel() * 8 + (q.numel() + k.numel() + v.numel()) * 4
                + table.numel() * (2 + 4) + geo + B * G * N * 8)
        # five products of 2 ch FLOP per pair from bf16 factors (QK, dV, dp,
        # dK, dQ) at the tensor-core rate; float32 per pair: window 3, bias
        # 9 (two x-lerps 6, y-lerp 3), score 3, exp2 and its argument 2, ds
        # 2, and of the bias tail's 28 the 19 that are its own (it shares
        # the window fractions and the x-lerps with the forward bias)
        t_b = pairs * 10 * ch / BF16_FLOPS + pairs * 38 / F32_FLOPS
        bound_b = (max(by_b / HBM_BPS, t_b) * 1e3,
                   "bytes" if by_b / HBM_BPS >= t_b else "operations")
        for rows, ms, plain, lib, (bound, by), extra in (
                (rows_l, ms_l, plain_l, lib_l,
                 site_bound(B, G, ch, N, Wt, lse=True),
                 dict(max_abs_err=kept["lse_err"],
                      max_abs_err_online=kept["lse_err_online"], plan=plan)),
                (rows_b, ms_b, plain_b, lib_b, bound_b,
                 dict(events_ms=ev_b, max_abs_err=kept["abs_err"],
                      max_abs_err_online=kept["abs_err_online"],
                      rel_err=kept["e_plain"],
                      rel_err_online=kept["e_online"]))):
            rows.append(dict(
                site=name, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bound, bound_by=by, per_step=per_step, **extra))
        print(f"fused_site_lse {name}: kernel {ms_l:.4f} ms plain "
              f"{plain_l:.4f} ms sdpa+mask {lib_l:.4f} ms bound "
              f"{rows_l[-1]['bound_ms']:.4f} ms ({rows_l[-1]['bound_by']}) "
              f"x{per_step}/step; {site_plan_text(plan)}", flush=True)
        print(f"fused_site_bwd {name}: kernel {ms_b:.4f} ms (events "
              f"{ev_b:.4f}) plain {plain_b:.4f} ms sdpa+mask backward "
              f"{lib_b:.4f} ms bound {rows_b[-1]['bound_ms']:.4f} ms "
              f"({rows_b[-1]['bound_by']}) x{per_step}/step", flush=True)
        del kept, ref_out, leaves, qs, ks, vs
        torch.cuda.empty_cache()
    if bad:
        fail(f"fused_site_lse / fused_site_bwd beyond tolerance at {bad}")
    return (dict(rows=rows_l, worst=worst["lse"],
                 worst_online=worst["lse_online"]),
            dict(rows=rows_b, worst=worst["bwd"],
                 worst_online=worst["bwd_online"]))


def pitched_bytes(G, Ht, Wt) -> int:
    """Bytes that a prefetch kernel's pitched table copy writes and reads
    back: (Ht + 2 PAD) x Xs bf16 per head, twice."""
    from bevrender_tpu_torch.ops.kernels._launch import PAD, window_columns

    return 2 * G * HPG * (Ht + 2 * PAD) * window_columns(Wt)[1] * 2


# a site of fused_site_wide_prefetch's ring path, (name, B, G, ch, N, Wt, per
# forward, BEV side): one head's padded table of BEV 64 at depth 5 (135 x 969
# bf16, 264,702 bytes with the key stages) overflows one block, the ring
# (4 rows x 336 columns a key, 174,464 bytes) does not. No supported model
# has such a site (0 a forward), so phase 18 alone launches the ring.
PREFETCH_RING_SITE = ("ring_bev64_g4_ch8_n1960", 2, 4, 8, 1960, 639, 0, 64)


def check_wide_site(da, kernels) -> tuple:
    """Phase 18, the fused sites of the wide route at every serving shape of
    phases 14-15 (SITE_SITES) and at PREFETCH_RING_SITE, two table scales
    each: ``fused_site_wide`` equal to ``fused_site`` bit for bit (where
    ``fused_site`` takes the table: not at the ring site) and
    ``fused_site_wide_prefetch`` equal to ``fused_site_wide``, both within
    the fused site's tolerances of the plain version and of the online
    mirror. Each line names the paths ``wide_plan`` and ``prefetch_plan``
    take, ``fused_site_wide``'s plan and the blocks one SM holds of each;
    the phase fails unless every SITE_SITES shape takes "whole" on both and
    the ring site "raw" and "ring". Times (the prefetch
    variant's on its ring path as the sum of its kernel's and its pitched
    table copy's, with that copy in its bound), bounds, plain and library
    times, and ``fused_site``'s time at the same shapes for comparison.
    Returns (fused_site_wide record, fused_site_wide_prefetch record)."""
    import torch

    wide = kernels.fused_site_wide
    rows_w, rows_p, bad = [], [], []
    worst = dict(wide=0.0, wide_online=0.0, prefetch=0.0, prefetch_online=0.0)
    sites = [(*site, H) for site in SITE_SITES] + [PREFETCH_RING_SITE]
    for i, (name, B, G, ch, N, Wt, per_fwd, side) in enumerate(sites):
        ring = name == PREFETCH_RING_SITE[0]
        Ht = 2 * side - 1
        grid = (B * G * HPG, torch.cuda.get_device_properties(
            0).multi_processor_count)
        plan = dict(path=wide.prefetch_plan(Ht, Wt, side, side, ch, *grid)[0],
                    blocks_per_sm=wide.prefetch_blocks_per_sm(
                        Ht, Wt, side, side, ch, *grid))
        wplan = site_plan(kernels, "fused_site_wide", B, G, ch, Wt, side)
        for std in SITE_TABLE_STDS:
            table, k_pos, q, k, v = site_inputs(80 + i, B, G, ch, N, Wt, std,
                                                side)
            scale = ch ** -0.5
            bf = torch.bfloat16
            kargs = da._kernel_args(table, k_pos, side, side) + tuple(
                x.to(bf).contiguous() for x in (q, k, v))
            geo, qkv = kargs[:7], kargs[8:]
            out_w = wide.fused_site_wide_cuda(*geo, *qkv, side, side, scale)
            out_p = wide.fused_site_wide_prefetch_cuda(*geo, *qkv, side, side,
                                                       scale)
            whole = None if ring else kernels.fused_site.fused_site_cuda(
                *kargs, side, side, scale)
            tb = table.bfloat16().float()
            bias = da.lattice_bias_plain(tb, k_pos, side, side, torch.float32)
            ref = da.site_consumer(q, k, v, bias, scale)
            wabs = da.site_consumer(q, k, v.abs(), bias, scale)
            online = da.site_consumer_online(q, k, v, bias, scale)
            torch.cuda.synchronize()
            same_w = ring or torch.equal(out_w, whole)
            same_p = torch.equal(out_p, out_w)
            errs = {}
            for tag, out in (("wide", out_w), ("prefetch", out_p)):
                d_plain, d_online = (out - ref).abs(), (out - online).abs()
                errs[tag] = (float(d_plain.max()), float(d_online.max()),
                             bool((d_plain <= SITE_P_ROUND * wabs + 1e-5).all())
                             and bool((d_online <= ONLINE_TOL * wabs
                                       + 1e-7).all()))
            ok = (same_w and same_p and errs["wide"][2] and errs["prefetch"][2]
                  and plan["path"] == ("ring" if ring else "whole")
                  and wplan["path"] == ("raw" if ring else "whole"))
            print(f"fused_site_wide {name} table std {std}: "
                  + ("" if ring else
                     f"{'equals' if same_w else 'DIFFERS FROM'} fused_site; ")
                  + f"prefetch {'equals' if same_p else 'DIFFERS FROM'} "
                  f"fused_site_wide; max abs err vs plain {errs['wide'][0]:.3g}"
                  f" / {errs['prefetch'][0]:.3g}, vs site_consumer_online "
                  f"{errs['wide'][1]:.3g} / {errs['prefetch'][1]:.3g}; wide "
                  f"{site_plan_text(wplan)}; prefetch path {plan['path']}, "
                  f"blocks_per_sm {plan['blocks_per_sm']} "
                  f"({'ok' if ok else 'FAIL'})", flush=True)
            if not ok:
                bad.append(f"{name} std {std}")
            for tag in ("wide", "prefetch"):
                worst[tag] = max(worst[tag], errs[tag][0])
                worst[tag + "_online"] = max(worst[tag + "_online"],
                                             errs[tag][1])
            if std != SITE_TABLE_STDS[0]:
                continue
            ms_whole = None if ring else queued_ms(
                lambda: kernels.fused_site.fused_site_cuda(
                    *kargs, side, side, scale), 20)
            ms_w = queued_ms(lambda: wide.fused_site_wide_cuda(
                *geo, *qkv, side, side, scale), 20)
            launch_p = lambda: wide.fused_site_wide_prefetch_cuda(  # noqa: E731
                *geo, *qkv, side, side, scale)
            ms_p_kernel = device_ms(launch_p, 20,
                                    "fused_site_wide_prefetch_kernel" if ring
                                    else "fused_site_whole_kernel")
            ms_p = queued_ms(launch_p, 20)
            plain = queued_ms(lambda: da.site_plain(
                q, k, v, k_pos, tb, side, side, scale, torch.float32), 5)
            lib = sdpa_ms(q, k, v, bias, scale, 20)
            b_w = site_bound(B, G, ch, N, Wt, side=side)
            b_p = site_bound(B, G, ch, N, Wt,
                             pitched_bytes(G, Ht, Wt) if ring else 0,
                             side=side)
            common = dict(site=name, plain_ms=plain, library_ms=lib,
                          per_forward=per_fwd, fused_site_ms=ms_whole)
            rows_w.append(dict(common, ms=ms_w, bound_ms=b_w[0],
                               bound_by=b_w[1], max_abs_err=errs["wide"][0],
                               max_abs_err_online=errs["wide"][1],
                               plan=wplan))
            rows_p.append(dict(common, ms=ms_p, kernel_only_ms=ms_p_kernel,
                               bound_ms=b_p[0], bound_by=b_p[1],
                               max_abs_err=errs["prefetch"][0],
                               max_abs_err_online=errs["prefetch"][1],
                               **plan))
            print(f"fused_site_wide {name}: kernel {ms_w:.4f} ms, prefetch "
                  f"{ms_p:.4f} ms (kernel alone {ms_p_kernel:.4f}), "
                  + ("" if ring else f"fused_site {ms_whole:.4f} ms; ")
                  + f"plain {plain:.4f} ms sdpa+mask {lib:.4f} ms; bound "
                  f"{b_w[0]:.4f} / {b_p[0]:.4f} ms ({b_w[1]}) "
                  f"x{per_fwd}/forward; wide {site_plan_text(wplan)}; "
                  f"prefetch path {plan['path']}, blocks_per_sm "
                  f"{plan['blocks_per_sm']}", flush=True)
            del bias, ref, wabs, online
        torch.cuda.empty_cache()
    if bad:
        fail(f"fused_site_wide / fused_site_wide_prefetch at {bad}")
    return (dict(rows=rows_w, worst=worst["wide"],
                 worst_online=worst["wide_online"]),
            dict(rows=rows_p, worst=worst["prefetch"],
                 worst_online=worst["prefetch_online"]))


def check_wide_site_lse(da, kernels) -> dict:
    """Phase 18, ``fused_site_wide_lse`` at every narrow site of a training
    step (TRAIN_SITE_SITES, phase 16) and two table scales: output and
    logsumexp equal to ``fused_site_lse``'s bit for bit, the output within
    the fused site's tolerance of the plain version and the logsumexp
    within LSE_TOL of the plain one and LSE_ONLINE_TOL of the online
    mirror's; each shape's plan (``wide_plan``) and the blocks one SM holds
    of it, and the phase fails unless every shape takes path "whole".
    Times, bound, plain and library (SDPA forward) times."""
    import torch

    wide = kernels.fused_site_wide
    rows, bad = [], []
    worst = dict(err=0.0, lse=0.0, lse_online=0.0)
    for i, (name, B, G, ch, N, Wt, per_step) in enumerate(TRAIN_SITE_SITES):
        plan = site_plan(kernels, "fused_site_wide", B, G, ch, Wt)
        for std in SITE_TABLE_STDS:
            table, k_pos, q, k, v = site_inputs(90 + i, B, G, ch, N, Wt, std)
            scale = ch ** -0.5
            bf = torch.bfloat16
            kargs = da._kernel_args(table, k_pos, H, W) + tuple(
                x.to(bf).contiguous() for x in (q, k, v))
            geo, qkv = kargs[:7], kargs[8:]
            o_whole, l_whole = kernels.fused_site.fused_site_lse_cuda(
                *kargs, H, W, scale)
            out, lse = wide.fused_site_wide_lse_cuda(*geo, *qkv, H, W, scale)
            tb = table.bfloat16().float()
            ref, ref_lse = da.site_plain_lse(q, k, v, k_pos, tb, H, W, scale,
                                             torch.float32)
            bias = da.lattice_bias_plain(tb, k_pos, H, W, torch.float32)
            _, on_lse = da.site_consumer_online(q, k, v, bias, scale,
                                                return_lse=True)
            wabs = da.site_consumer(q, k, v.abs(), bias, scale)
            torch.cuda.synchronize()
            same = torch.equal(out, o_whole) and torch.equal(lse, l_whole)
            err = float((out - ref).abs().max())
            e_l = float((lse - ref_lse).abs().max())
            e_lo = float((lse - on_lse).abs().max())
            ok = (same and e_l <= LSE_TOL and e_lo <= LSE_ONLINE_TOL and bool(
                ((out - ref).abs() <= SITE_P_ROUND * wabs + 1e-5).all())
                and plan["path"] == "whole")
            print(f"fused_site_wide_lse {name} table std {std}: out and lse "
                  f"{'equal' if same else 'DIFFER FROM'} fused_site_lse's; "
                  f"out err {err:.3g}, lse err {e_l:.3g} (online {e_lo:.3g}); "
                  f"{site_plan_text(plan)} ({'ok' if ok else 'FAIL'})",
                  flush=True)
            if not ok:
                bad.append(f"{name} std {std}")
            worst = dict(err=max(worst["err"], err),
                         lse=max(worst["lse"], e_l),
                         lse_online=max(worst["lse_online"], e_lo))
            if std != SITE_TABLE_STDS[0]:
                continue
            ms = queued_ms(lambda: wide.fused_site_wide_lse_cuda(
                *geo, *qkv, H, W, scale), 10)
            ms_whole = queued_ms(
                lambda: kernels.fused_site.fused_site_lse_cuda(
                    *kargs, H, W, scale), 10)
            plain = queued_ms(lambda: da.site_plain_lse(
                q, k, v, k_pos, tb, H, W, scale, torch.float32), 3)
            lib = sdpa_ms(q, k, v, bias, scale, 10)
            bound, by = site_bound(B, G, ch, N, Wt, lse=True)
            rows.append(dict(site=name, ms=ms, fused_site_lse_ms=ms_whole,
                             plain_ms=plain, library_ms=lib, bound_ms=bound,
                             bound_by=by, per_step=per_step, max_abs_err=e_l,
                             max_abs_err_online=e_lo, max_abs_err_out=err,
                             plan=plan))
            print(f"fused_site_wide_lse {name}: kernel {ms:.4f} ms "
                  f"(fused_site_lse {ms_whole:.4f}) plain {plain:.4f} ms "
                  f"sdpa+mask {lib:.4f} ms bound {bound:.4f} ms ({by}) "
                  f"x{per_step}/step", flush=True)
        torch.cuda.empty_cache()
    if bad:
        fail(f"fused_site_wide_lse beyond tolerance at {bad}")
    return dict(rows=rows, worst=worst["lse"], worst_online=worst["lse_online"],
                worst_out=worst["err"])


# The prefetch bias at every shape that phases 15 (the flagship's serving
# bias sites, H = 28) and 17 (the pyramid's SCA at BEV 56) give it: (name,
# H, batch, G, N, table width, launches per forward)
PREFETCH_BIAS_SITES = [
    (name, H, B, G, N, Wt, per_fwd)
    for name, B, G, ch, N, Wt, per_fwd in BIAS_SITES
] + [("pyramid_sca56_g1_n7840", 56, 2, 1, 7840, 559,
      PYR_BIAS_PER_FORWARD["sca56_g1_n7840"])]
# every other shape the bias forward takes on a main path, where phase 18
# holds the two wide forwards without timing them: phase 8's training
# shapes and phase 12's pyramid shapes, (name, H, batch, G, N, table width)
FWD_CHECK_SITES = [
    (f"train_{name}", H, B, G, N, Wt)
    for name, B, G, _, N, Wt, _ in TRAIN_BIAS_SITES
] + [(f"pyramid_{name}", Hs, B, G, N, Wt)
     for name, Hs, B, G, N, Wt in PYR_BIAS_SITES if name != "sca56_g1_n7840"]


def check_prefetch_bias(da, kernels) -> tuple:
    """Phase 18, ``lattice_bias_wide_prefetch`` and ``lattice_bias_wide``
    (one template, csrc/bias_fwd_rows.cuh) at every shape of
    PREFETCH_BIAS_SITES and FWD_CHECK_SITES and two table scales: the
    prefetch kernel equal to the wide one bit for bit and both to the
    whole-table one where its shared memory holds the table, all within one
    bf16 ulp of the plain version. Each instance's plan (``fwd_plan``): its
    path and blocks an SM; the phase fails unless the prefetch kernel takes
    its whole-table path at every such shape. Times, at PREFETCH_BIAS_SITES
    only, bounds, plain times, ``grid_sample``'s.
    Returns (prefetch record, wide record at the flagship's shapes)."""
    import torch

    fwd = kernels.lattice_bias
    rows_p, rows_w, bad = [], [], []
    worst = dict(prefetch=0.0, wide=0.0)
    sites = ([(*site, True) for site in PREFETCH_BIAS_SITES]
             + [(*site, 0, False) for site in FWD_CHECK_SITES])
    for i, (name, Hs, B, G, N, Wt, per_fwd, timed) in enumerate(sites):
        plan_w = fwd_plan(fwd, "lattice_bias_wide", B, G, N, Wt, Hs)
        plan_p = fwd_plan(fwd, "lattice_bias_wide_prefetch", B, G, N, Wt, Hs)
        print(f"lattice_bias_wide {name}: {fwd_plan_text(plan_w)}; "
              f"lattice_bias_wide_prefetch: {fwd_plan_text(plan_p)}",
              flush=True)
        if plan_p["path"] != "whole":
            bad.append(f"{name}: prefetch path {plan_p['path']}")
        for std in SITE_TABLE_STDS:
            table, k_pos, _ = bias_inputs(100 + i, B, G, N, Wt, Hs, std)
            args = da._kernel_args(table, k_pos, Hs, Hs)
            out_w = fwd.lattice_bias_wide_cuda(*args[:7], Hs, Hs)
            out_p = fwd.lattice_bias_wide_prefetch_cuda(*args[:7], Hs, Hs)
            whole = da.bias_route(table.shape, Hs, Hs) == "whole"
            same_whole = (not whole or torch.equal(
                fwd.lattice_bias_cuda(*args, Hs, Hs), out_w))
            r32 = da.lattice_bias_plain(table.bfloat16().float(), k_pos, Hs,
                                        Hs, torch.float32)
            rb = r32.bfloat16().float()
            torch.cuda.synchronize()
            same = torch.equal(out_p, out_w)
            err = (out_p.float() - rb).abs()
            ok = (same and same_whole
                  and bool((err <= rb.abs() * BIAS_ULP).all()))
            err = float(err.max())
            vs_whole = ("" if not whole else ", which equals lattice_bias"
                        if same_whole else ", which DIFFERS FROM lattice_bias")
            print(f"lattice_bias_wide_prefetch {name} table std {std}: "
                  f"{'equals' if same else 'DIFFERS FROM'} lattice_bias_wide"
                  f"{vs_whole}; max abs err vs plain {err:.3g} "
                  f"({'ok' if ok else 'FAIL'})", flush=True)
            if not ok:
                bad.append(f"{name} std {std}")
            worst["prefetch"] = max(worst["prefetch"], err)
            worst["wide"] = max(worst["wide"], err)
            del out_w, out_p, rb
            if std != SITE_TABLE_STDS[0] or not timed:
                del r32
                continue
            lib = library_bias_ms(da, table, k_pos, None, Hs, r32)["fwd_ms"]
            del r32
            launch_p = lambda: fwd.lattice_bias_wide_prefetch_cuda(  # noqa: E731
                *args[:7], Hs, Hs)
            ms_p_kernel = device_ms(launch_p, 10,
                                    "lattice_bias_wide_prefetch_kernel")
            ms_p = queued_ms(launch_p, 10)
            ms_w = queued_ms(lambda: fwd.lattice_bias_wide_cuda(
                *args[:7], Hs, Hs), 10)
            tb = table.bfloat16().float()
            plain = queued_ms(lambda: da.lattice_bias_plain(
                tb, k_pos, Hs, Hs, torch.float32), 3)
            b_w = b_p = bias_bounds(B, G, N, Wt, Hs, backward=False)
            common = dict(site=name, plain_ms=plain, library_ms=lib,
                          per_forward=per_fwd, max_abs_err=err)
            rows_p.append(dict(common, ms=ms_p, kernel_only_ms=ms_p_kernel,
                               wide_ms=ms_w, bound_ms=b_p[0],
                               bound_by=b_p[1], plan=plan_p))
            if whole:  # the flagship's shapes (phase 14)
                rows_w.append(dict(common, ms=ms_w, bound_ms=b_w[0],
                                   bound_by=b_w[1], plan=plan_w))
            print(f"lattice_bias_wide_prefetch {name}: {ms_p:.4f} ms (kernel "
                  f"alone {ms_p_kernel:.4f}), lattice_bias_wide {ms_w:.4f} "
                  f"ms, plain {plain:.4f} ms, grid_sample {lib:.4f} ms; bound "
                  f"{b_p[0]:.4f} / "
                  f"{b_w[0]:.4f} ms ({b_p[1]}) x{per_fwd}/forward",
                  flush=True)
        torch.cuda.empty_cache()
    if bad:
        fail(f"lattice_bias_wide_prefetch beyond tolerance at {bad}")
    return (dict(rows=rows_p, worst=worst["prefetch"]),
            dict(rows=rows_w, worst=worst["wide"]))


# a site of the head-folded kernels' ring path, (name, B, G, ch, N, Wt,
# per forward / step, BEV side): two heads' padded tables of BEV 60 at depth
# 5 (127 x 459 bf16, 233 KB) overflow one block. No supported model has such
# a site (0 a forward), so phase 22 alone launches the ring.
FOLD_RING_SITE = ("ring_bev60_g4_ch8_n1960", 2, 4, 8, 1960, 299, 0, 60)


def check_fold_sites(da, kernels) -> tuple:
    """Phase 22, the folded fused sites at every shape phases 19-21 give
    them and two table scales: ``fused_site_fold_rows`` and
    ``fused_site_fold_heads`` at the serving sites (SITE_SITES) equal to
    ``fused_site`` and ``fused_site_wide_prefetch`` bit for bit, and
    ``fused_site_fold_heads_lse`` at the training sites (TRAIN_SITE_SITES)
    equal to ``fused_site_lse`` in output and logsumexp; every output within
    SITE_P_ROUND of the plain version, the logsumexp within LSE_TOL of the
    plain one. The head-folded kernels are held so at FOLD_RING_SITE too,
    which must take their ring path (every serving and training site takes
    the whole-table path). Times (a head-folded kernel's on its ring path
    the sum of its kernel's and its pitched table copy's), bounds (with that copy on the ring path only), plain and
    library times, and the sibling's time in the same call; a head-folded
    line also names its path (``fused_site_fold.heads_plan``) and the
    blocks one SM holds, a row-folded line its plan
    (``fused_site_fold.rows_plan``: path "whole" at every serving site, or
    the phase fails) and the blocks one SM holds. Returns the records of
    (fused_site_fold_rows, fused_site_fold_heads,
    fused_site_fold_heads_lse)."""
    import torch

    fold, wide = kernels.fused_site_fold, kernels.fused_site_wide
    bf = torch.bfloat16
    recs = {n: dict(rows=[], worst=0.0) for n in ("rows", "heads", "lse")}
    bad = []

    def run(tag, name, B, G, ch, N, Wt, per, std, seed, side=H):
        H = W = side  # noqa: N806
        table, k_pos, q, k, v = site_inputs(seed, B, G, ch, N, Wt, std, side)
        scale = ch ** -0.5
        kargs = da._kernel_args(table, k_pos, H, W) + tuple(
            x.to(bf).contiguous() for x in (q, k, v))
        geo, qkv = kargs[:7], kargs[8:]
        tb = table.bfloat16().float()
        bias = da.lattice_bias_plain(tb, k_pos, H, W, torch.float32)
        wabs = da.site_consumer(q, k, v.abs(), bias, scale)
        if tag == "lse":
            launch = lambda: fold.fused_site_fold_heads_lse_cuda(  # noqa: E731
                *geo, *qkv, H, W, scale)
            sibling = lambda: kernels.fused_site.fused_site_lse_cuda(  # noqa: E731
                *kargs, H, W, scale)
            plain = lambda: da.site_plain_lse(  # noqa: E731
                q, k, v, k_pos, tb, H, W, scale, torch.float32)
            (out, lse), (s_out, s_lse), (ref, ref_lse) = (
                launch(), sibling(), plain())
            same = torch.equal(out, s_out) and torch.equal(lse, s_lse)
            err = float((lse - ref_lse).abs().max())
            ok = err <= LSE_TOL
        else:
            launch, sibling = {
                "rows": (
                    lambda: fold.fused_site_fold_rows_cuda(*kargs, H, W,
                                                           scale),
                    lambda: kernels.fused_site.fused_site_cuda(*kargs, H, W,
                                                               scale)),
                "heads": (
                    lambda: fold.fused_site_fold_heads_cuda(*geo, *qkv, H, W,
                                                            scale),
                    lambda: wide.fused_site_wide_prefetch_cuda(
                        *geo, *qkv, H, W, scale))}[tag]
            plain = lambda: da.site_plain(  # noqa: E731
                q, k, v, k_pos, tb, H, W, scale, torch.float32)
            out, s_out, ref = launch(), sibling(), plain()
            same = torch.equal(out, s_out)
            err = float((out - ref).abs().max())
            ok = True
        torch.cuda.synchronize()
        d_out = (out - ref).abs()
        ok = ok and same and bool((d_out <= SITE_P_ROUND * wabs + 1e-5).all())
        sib = dict(rows="fused_site", heads="fused_site_wide_prefetch",
                   lse="fused_site_lse")[tag]
        plan = {}
        if tag != "rows":
            plan = dict(path=fold.heads_plan(HPG, Wt, H, W, ch)[0],
                        blocks_per_sm=fold.heads_blocks_per_sm(HPG, Wt, H, W,
                                                               ch))
            ok = ok and plan["path"] == ("ring" if name == FOLD_RING_SITE[0]
                                         else "whole")
        else:
            rplan = site_plan(kernels, "fused_site_fold_rows", B, G, ch, Wt,
                              side)
            plan = dict(plan=rplan)
            ok = ok and rplan["path"] == "whole"
        shown = (f"; {site_plan_text(plan['plan'])}" if tag == "rows" else
                 "".join(f"; {k} {v}" for k, v in plan.items()))
        print(f"fold {tag} {name} table std {std}: "
              f"{'equals' if same else 'DIFFERS FROM'} {sib}; max abs err vs "
              f"plain {err:.3g}{' (lse)' if tag == 'lse' else ''}, out "
              f"{float(d_out.max()):.3g} ({'ok' if ok else 'FAIL'})" + shown,
              flush=True)
        if not ok:
            bad.append(f"{tag} {name} std {std}")
        rec = recs[tag]
        rec["worst"] = max(rec["worst"], err)
        if std != SITE_TABLE_STDS[0]:
            return
        ms = queued_ms(launch, 20)
        ms_sib = queued_ms(sibling, 20)
        extra = (pitched_bytes(G, 2 * H - 1, Wt)
                 if plan.get("path") == "ring" else 0)
        bound, by = site_bound(B, G, ch, N, Wt, extra, lse=tag == "lse",
                               side=side)
        plain_ms = queued_ms(plain, 5)
        lib = sdpa_ms(q, k, v, bias, scale, 20)
        rec["rows"].append({
            "site": name, "ms": ms, "sibling_ms": ms_sib, "plain_ms": plain_ms,
            "library_ms": lib, "bound_ms": bound, "bound_by": by,
            ("per_step" if tag == "lse" else "per_forward"): per,
            "max_abs_err": err, **plan})
        print(f"fold {tag} {name}: kernel {ms:.4f} ms, {sib} {ms_sib:.4f} ms; "
              f"plain {plain_ms:.4f} ms sdpa+mask {lib:.4f} ms; bound "
              f"{bound:.4f} ms ({by}) x{per}/"
              f"{'step' if tag == 'lse' else 'forward'}" + shown, flush=True)

    ring = [FOLD_RING_SITE[:-1]]
    for tag, sites in (("rows", SITE_SITES), ("heads", SITE_SITES + ring),
                       ("lse", TRAIN_SITE_SITES + ring)):
        for i, (name, B, G, ch, N, Wt, per) in enumerate(sites):
            side = FOLD_RING_SITE[-1] if name == FOLD_RING_SITE[0] else H
            for std in SITE_TABLE_STDS:
                run(tag, name, B, G, ch, N, Wt, per, std, 110 + i, side)
            torch.cuda.empty_cache()
    if bad:
        fail(f"folded fused sites beyond tolerance or unequal at {bad}")
    return recs["rows"], recs["heads"], recs["lse"]


@contextlib.contextmanager
def plain_windows(da):
    """Cut every window of the windowed bias with ``lattice_windows_plain``
    on the card; the rest of the windowed bias is unchanged."""
    from bevrender_tpu_torch.ops.kernels.lattice_windows import (
        lattice_windows_plain,
    )

    saved = da.lattice_windows
    da.lattice_windows = lattice_windows_plain
    try:
        yield
    finally:
        da.lattice_windows = saved


def windows_render_check(da, tag: str):
    """A ``serving_phase`` comparison: the pipeline's render through the
    window kernel against its render with the plain windows, which must be
    equal (the windows are exact copies; everything else is the same)."""
    import torch

    def compare(pipe, batch):
        with torch.no_grad():
            got = pipe.render(batch)
            with plain_windows(da):
                ref = pipe.render(batch)
        torch.cuda.synchronize()
        diff = float((got.float() - ref.float()).abs().max())
        print(f"{tag}: render through lattice_windows against the render with "
              f"lattice_windows_plain on the card, max abs difference {diff}",
              flush=True)
        if diff != 0.0 or not bool(torch.isfinite(got).all()):
            fail(f"{tag}: the windowed render differs from the plain-windows "
                 f"render by {diff}")
        return dict(render_diff_plain_windows=diff)

    return compare


def windows_bounds(keys, G, Y, m_max, WH, h1, backward: bool):
    """(bound ms, what bounds it) of the window kernels: the forward writes
    every window (keys x 3 x h1 x WH bf16) and reads t3 (bf16) and 8 bytes of
    starts a key; the backward reads every window's cotangent (bf16) and the
    starts and writes the t3 gradient (bf16), against one float32 add per
    cotangent entry. The backward's bucketed keys and bin offsets (4 bytes a
    key and a bin, written and read again) are its design, not the
    function's, and are not counted."""
    win = keys * 3 * h1 * WH
    t3 = G * Y * m_max * WH
    nbytes = win * 2 + t3 * 2 + keys * 8
    ops = win if backward else 0
    by = "bytes" if nbytes / HBM_BPS >= ops / F32_FLOPS else "operations"
    return max(nbytes / HBM_BPS, ops / F32_FLOPS) * 1e3, by


def window_starts(ys, ms, t3_shape, h1) -> dict:
    """How one call's window starts fall: the keys, the largest bin (keys
    sharing one start (g, ms, ys)) and the share of keys whose ms is
    clipped to the first or last start (``lattice_geometry``'s clamp)."""
    import torch

    G, Y, m_max, _ = t3_shape
    g = torch.arange(G, device=ys.device).view(1, G, 1)
    bins = ((g * (m_max - 2) + ms.long()) * (Y - h1 + 1) + ys.long())
    clipped = int(((ms == 0) | (ms == m_max - 3)).sum())
    return dict(keys=bins.numel(),
                largest_bin=int(torch.bincount(bins.reshape(-1)).max()),
                clipped_share=clipped / bins.numel())


# Every shape the bias sees in phases 3, 6, 10 (and so 23-25): (name, H,
# batch, G, N, table width, #14 launches per serving forward, #14 and #15
# launches per training step under bias_forward "windows"). A training step
# runs its history pass (eval: the sites of head width 16 and 32; the others
# take the fused site), its final pass and, under site_remat "nothing", the
# final pass's bias again in the backward.
WINDOW_SITES = (
    [(f"serve_{name}", H, B, G, N, Wt, per, 0, 0)
     for name, B, G, ch, N, Wt, per in BIAS_SITES]
    + [(f"train_{name}", H, B, G, N, Wt, 0, per * (3 if ch > 8 else 2), per)
       for name, B, G, ch, N, Wt, per in TRAIN_BIAS_SITES]
    + [(f"pyramid_{name}", Hs, B, G, N, Wt,
        PYR_BIAS_PER_FORWARD[name], 0, 0)
       for name, Hs, B, G, N, Wt in PYR_BIAS_SITES
       if name in ("sca56_g1_n7840", "tsa7_g8_n49", "sca7_bv6_g8_n140")])


def check_windows(da, kernels) -> tuple:
    """Phase 25: ``lattice_windows`` equal to ``lattice_windows_plain`` at
    every shape of WINDOW_SITES; ``lattice_windows_bwd`` against
    ``lattice_windows_bwd_plain`` at the training shapes and the pyramid's
    SCA 56, its float32 sums within BWD_SUM_TOL of the largest entry and its
    bf16 result within one bf16 ulp, and, in both types, bit-equal to a
    second run and to ``lattice_windows_bwd_ordered``; kernel, plain,
    library (``index_select`` / ``index_add_`` of t3's rows) and bound
    times, the kernels and the library calls by ``queued_ms``, and how the
    starts fall (``window_starts``). Then
    the windowed bias at the serving and pyramid shapes and two table
    scales: equal to ``lattice_bias_plain`` in bf16, and within WINDOWED_TOL
    of the bias kernel of the site's route; both biases' times. Returns the
    records of (lattice_windows, lattice_windows_bwd, windowed bias)."""
    import torch

    lw = kernels.lattice_windows
    rows_f, rows_b, rec_bias, bad = [], [], [], []
    worst_f = worst_b = 0.0
    for i, (name, Hs, B, G, N, Wt, per_fwd, per_step, per_bwd) in enumerate(
            WINDOW_SITES):
        table, k_pos, _ = bias_inputs(130 + i, B, G, N, Wt, Hs,
                                      SITE_TABLE_STDS[0])
        ys, ms, _, _ = da.lattice_geometry(table.shape, k_pos, Hs, Hs)
        ys, ms = ys.contiguous(), ms.contiguous()
        t3 = da.lattice_t3(table, Hs, torch.bfloat16)
        _, Y, m_max, WH = t3.shape
        h1 = Hs + 1
        win = lw.lattice_windows_cuda(t3, ys, ms, h1)
        same = torch.equal(win, lw.lattice_windows_plain(t3, ys, ms, h1))
        torch.cuda.synchronize()
        rows = lw.window_rows(ys, ms, h1, Y, m_max).reshape(-1)
        flat = t3.reshape(-1, WH)
        ms_k = queued_ms(lambda: lw.lattice_windows_cuda(t3, ys, ms, h1), 20)
        plain = queued_ms(lambda: lw.lattice_windows_plain(t3, ys, ms, h1), 5)
        lib = queued_ms(lambda: torch.index_select(flat, 0, rows), 20)
        bound, by = windows_bounds(B * G * N, G, Y, m_max, WH, h1, False)
        rows_f.append(dict(site=name, ms=ms_k, plain_ms=plain, library_ms=lib,
                           bound_ms=bound, bound_by=by, per_forward=per_fwd,
                           per_step=per_step, max_abs_err=0.0 if same else None,
                           window_mb=win.numel() * 2 / 1e6))
        print(f"lattice_windows {name} ({tuple(win.shape)}): "
              f"{'equals' if same else 'DIFFERS FROM'} lattice_windows_plain; "
              f"kernel {ms_k:.4f} ms plain {plain:.4f} ms index_select "
              f"{lib:.4f} ms bound {bound:.4f} ms ({by}) x{per_fwd}/forward "
              f"x{per_step}/step", flush=True)
        if not same:
            bad.append(f"lattice_windows {name}")
        if per_bwd or name.startswith("pyramid_sca56"):
            gen = torch.Generator(device="cuda").manual_seed(150 + i)
            gout = torch.randn(win.shape, generator=gen,
                               device="cuda").bfloat16()
            del win
            acc = lw.lattice_windows_bwd_cuda(gout, ys, ms, t3.shape,
                                              torch.float32)
            ref = lw.lattice_windows_bwd_plain(gout, ys, ms, t3.shape,
                                               torch.float32)
            out = lw.lattice_windows_bwd_cuda(gout, ys, ms, t3.shape,
                                              torch.bfloat16)
            refb = ref.to(torch.bfloat16).float()
            torch.cuda.synchronize()
            e_rel = rel_err(acc, ref)
            e_abs = float((acc - ref).abs().max())
            ulp = bool(((out.float() - refb).abs() <= torch.maximum(
                out.float().abs(), refb.abs()) * BIAS_ULP).all())
            ok = e_rel <= BWD_SUM_TOL and ulp and bool(
                torch.isfinite(acc).all()) and float(ref.abs().max()) > 0
            del ref, refb
            # the same bits on a second run, and those of the ordered mirror
            repeat = torch.equal(acc, lw.lattice_windows_bwd_cuda(
                gout, ys, ms, t3.shape, torch.float32)) and torch.equal(
                out, lw.lattice_windows_bwd_cuda(gout, ys, ms, t3.shape,
                                                 torch.bfloat16))
            t0 = time.perf_counter()
            mirror = lw.lattice_windows_bwd_ordered(gout, ys, ms, t3.shape,
                                                    torch.float32)
            ordered = torch.equal(acc, mirror) and torch.equal(
                out, mirror.to(torch.bfloat16))
            mirror_s = time.perf_counter() - t0
            ok = ok and repeat and ordered
            del acc, out, mirror
            starts = window_starts(ys, ms, t3.shape, h1)
            launch = lambda: lw.lattice_windows_bwd_cuda(  # noqa: E731
                gout, ys, ms, t3.shape, torch.bfloat16)
            ms_b = queued_ms(launch, 10)
            plain_b = queued_ms(lambda: lw.lattice_windows_bwd_plain(
                gout, ys, ms, t3.shape, torch.bfloat16), 3)
            gf = gout.reshape(-1, WH).float()
            buf = torch.zeros(G * Y * m_max, WH, device="cuda")
            lib_b = queued_ms(lambda: buf.index_add_(0, rows, gf), 10)
            del gf, buf, gout
            bound_b, by_b = windows_bounds(B * G * N, G, Y, m_max, WH, h1, True)
            rows_b.append(dict(site=name, ms=ms_b,
                               plain_ms=plain_b, library_ms=lib_b,
                               bound_ms=bound_b, bound_by=by_b,
                               per_step=per_bwd, max_abs_err=e_abs,
                               rel_err=e_rel, repeat_equal=repeat,
                               ordered_equal=ordered, **starts))
            worst_b = max(worst_b, e_abs)
            print(f"lattice_windows_bwd {name}: float32 sums rel err "
                  f"{e_rel:.3g} (abs {e_abs:.3g}), bf16 result "
                  f"{'within' if ulp else 'BEYOND'} one ulp; two runs "
                  f"{'bit-equal' if repeat else 'DIFFER'}; "
                  f"{'equal to' if ordered else 'DIFFERS FROM'} "
                  f"lattice_windows_bwd_ordered ({mirror_s:.1f} s) "
                  f"({'ok' if ok else 'FAIL'}); kernel {ms_b:.4f} ms plain "
                  f"{plain_b:.4f} ms index_add_ "
                  f"{lib_b:.4f} ms bound {bound_b:.4f} ms ({by_b}) "
                  f"x{per_bwd}/step; largest bin {starts['largest_bin']} of "
                  f"{starts['keys']} keys, clipped ms "
                  f"{starts['clipped_share']:.4f}", flush=True)
            if not ok:
                bad.append(f"lattice_windows_bwd {name}")
        del t3, rows, flat, table, k_pos
        torch.cuda.empty_cache()
    # the windowed bias, whole, at the serving and pyramid shapes
    for i, (name, Hs, B, G, N, Wt, per_fwd, _, _) in enumerate(WINDOW_SITES):
        if not per_fwd:
            continue
        for std in SITE_TABLE_STDS:
            table, k_pos, _ = bias_inputs(170 + i, B, G, N, Wt, Hs, std)
            with torch.no_grad():
                wb = da.lattice_bias_windowed(table, k_pos, Hs, Hs)
                pb = da.lattice_bias_plain(table, k_pos, Hs, Hs)
                same = torch.equal(wb, pb)
                del pb
                kb = da.lattice_bias(table, k_pos, Hs, Hs).float()
            a = float(table.bfloat16().float().abs().max())
            err = float((wb - kb).abs().max())
            torch.cuda.synchronize()
            ok = same and err <= WINDOWED_TOL * a
            route = da.bias_route(table.shape, Hs, Hs)
            print(f"windowed bias {name} table std {std}: "
                  f"{'equals' if same else 'DIFFERS FROM'} lattice_bias_plain "
                  f"(bf16); against the {route}-route bias kernel max abs "
                  f"{err:.3g} = {err / (a * 2.0 ** -8):.3g} u of the largest "
                  f"table entry {a:.3g} (tolerance {WINDOWED_TOL / 2.0 ** -8:.0f}"
                  f" u) ({'ok' if ok else 'FAIL'})", flush=True)
            if not ok:
                bad.append(f"windowed bias {name} std {std}")
            del wb, kb
            if std != SITE_TABLE_STDS[0]:
                continue
            with torch.no_grad():
                ms_w = queued_ms(lambda: da.lattice_bias_windowed(
                    table, k_pos, Hs, Hs), 5)
                ms_c = queued_ms(lambda: da.lattice_bias(
                    table, k_pos, Hs, Hs), 5)
            rec_bias.append(dict(site=name, windowed_ms=ms_w,
                                 bias_kernel_ms=ms_c, route=route,
                                 per_forward=per_fwd, max_abs_err=err,
                                 table_max=a))
            print(f"windowed bias {name}: {ms_w:.4f} ms per call (every "
                  f"kernel of t3, windows and mix), {route}-route bias kernel "
                  f"{ms_c:.4f} ms x{per_fwd}/forward", flush=True)
            torch.cuda.empty_cache()
    if bad:
        fail(f"window kernels or windowed bias beyond tolerance at {bad}")
    return (dict(rows=rows_f, worst=worst_f), dict(rows=rows_b, worst=worst_b),
            rec_bias)


class SeededTiles:
    """``n`` map tiles (224 x 224 x 3, uniform in [0, 1), float32) drawn
    from ``seed`` ``batch`` at a time, so that no array of all of them is
    ever built; the rows of ``inserted`` ({row: image}) replaced."""

    def __init__(self, n: int, seed: int, inserted: dict, batch: int):
        self.n, self.seed, self.inserted, self.batch = n, seed, inserted, batch

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        import numpy as np

        rng = np.random.default_rng(self.seed)
        for start in range(0, self.n, self.batch):
            block = rng.random((min(self.batch, self.n - start), 224, 224, 3),
                               dtype=np.float32)
            for i, tile in enumerate(block):
                yield self.inserted.get(start + i, tile)


def per_call_text(ms: list) -> str:
    q = statistics.quantiles(ms, n=20)
    return (f"min {min(ms):.3f} median {statistics.median(ms):.3f} p95 "
            f"{q[-1]:.3f} max {max(ms):.3f}")


def head_phase(card: str, auto_render) -> tuple:
    """Phase 26: render+register through the retrieval head. Returns the
    record, the pipeline and its database (phase 27 streams on them)."""
    import copy

    import torch

    from bevrender_tpu_torch.config import flagship_config
    from bevrender_tpu_torch.data.synthetic import SyntheticDataset
    from bevrender_tpu_torch.inference.register import RegistrationPipeline
    from bevrender_tpu_torch.models.retrieval import tf32
    from bevrender_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    cfg = flagship_config(dtype="bfloat16", retrieval_embed_dim=HEAD_DIM,
                          retrieval_head_widths=HEAD_WIDTHS)
    pipe = RegistrationPipeline(cfg, device="cuda", seed=0)
    ds = SyntheticDataset(n_items=SERVE_B, num_views=cfg.model.num_views,
                          window_num_imgs=1, img_height=224, img_width=224)
    batch = {k: torch.as_tensor(v) for k, v in ds.batch(SERVE_B).items()}
    tiles = SeededTiles(HEAD_TILES, 2, dict(zip(HEAD_ROWS,
                                                auto_render.numpy())),
                        HEAD_TILE_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db = pipe.build_tile_database(tiles, batch_size=HEAD_TILE_BATCH)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    db_bytes = db.numel() * db.element_size()
    norms = torch.linalg.vector_norm(db, dim=-1)
    if (tuple(db.shape) != (HEAD_TILES, HEAD_DIM) or db.dtype != torch.float32
            or not bool(torch.isfinite(db).all())
            or float((norms - 1).abs().max()) > 1e-5):
        fail(f"head database: shape {tuple(db.shape)}, dtype {db.dtype}, "
             f"norms {float(norms.min())}-{float(norms.max())}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand(HEAD_TILE_BATCH, 224, 224, 3, device="cuda", generator=gen)
    with torch.no_grad():
        head_batch_ms = queued_ms(lambda: pipe.net.embed(x), 5)
        head_request_ms = queued_ms(lambda: pipe.net.embed(x[:SERVE_B]), 20)
    del x
    print(f"head database: {HEAD_TILES} tiles -> {tuple(db.shape)} float32, "
          f"{db_bytes} bytes ({db_bytes / 2 ** 20:.3f} MiB), built in "
          f"{build_s:.3f} s, {HEAD_TILES / build_s:.1f} tiles/s (the host's "
          f"seeded tiles and copies included); the head alone on "
          f"{HEAD_TILE_BATCH} tiles {head_batch_ms:.3f} ms on the card, "
          f"{HEAD_TILE_BATCH / head_batch_ms * 1e3:.1f} tiles/s; on a "
          f"request's {SERVE_B} renders {head_request_ms:.4f} ms [{card}]",
          flush=True)

    pipe.register(batch, top_k=10)  # warm-up request
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(HEAD_REQUESTS + 1)]
    cpu0 = time.process_time()
    marks[0].record()
    for i in range(HEAD_REQUESTS):
        render, idx, dist = pipe.register(batch, top_k=10)
        marks[i + 1].record()
    marks[-1].synchronize()
    host_cpu_ms = (time.process_time() - cpu0) * 1e3 / HEAD_REQUESTS
    counts = kernels.counts()
    req_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    ms = marks[0].elapsed_time(marks[-1]) / HEAD_REQUESTS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = expected(fused_site=FUSED_PER_FORWARD * HEAD_REQUESTS,
                    fused_site_mma=MMA_PER_FORWARD * HEAD_REQUESTS)
    print(f"head serving launches over {HEAD_REQUESTS} requests: {counts} "
          f"(expected {want})", flush=True)
    if counts != want:
        fail(f"head serving: launch counts {counts} != {want}")
    render_diff = float((render.float().cpu() - auto_render).abs().max())
    rows = torch.tensor(HEAD_ROWS)
    top1 = idx[:, 0].cpu()
    self_dist = dist[:, 0].float().cpu()
    margin = (dist[:, 1] - dist[:, 0]).float().cpu()
    with torch.no_grad():
        ref = copy.deepcopy(pipe.net.retrieval_head).cpu().double()(
            render.double().cpu())
        with tf32(True):
            emb = pipe.net.embed(render)
    head_rel = float((emb.double().cpu() - ref).abs().max()
                     / ref.abs().max())
    print(f"render+register through the head, flagship bf16 B={SERVE_B} T=2: "
          f"{HEAD_REQUESTS} requests, {ms:.3f} ms/request, "
          f"{SERVE_B / ms * 1e3:.2f} frames/s; per request "
          f"{per_call_text(req_ms)} ms; host CPU {host_cpu_ms:.3f} "
          f"ms/request; peak {peak_gb:.3f} GiB [{card}]", flush=True)
    print(f"head: render against phase 3's (max abs) {render_diff}; top-1 "
          f"{top1.tolist()} (inserted at {list(HEAD_ROWS)}), distance "
          f"{self_dist.tolist()} (limit {HEAD_SELF_DIST}), to the second "
          f"{margin.tolist()}; embedding with TF32 enabled against float64 "
          f"on the CPU {head_rel:.3g} of its largest entry (limit "
          f"{HEAD_REL_TOL})", flush=True)
    if render_diff != 0.0:
        fail(f"head serving: render differs from phase 3's by {render_diff}")
    if not torch.equal(top1, rows) or float(self_dist.max()) > HEAD_SELF_DIST:
        fail(f"head serving: inserted renders at {list(HEAD_ROWS)} came back "
             f"as {top1.tolist()} at {self_dist.tolist()}")
    if not head_rel <= HEAD_REL_TOL:
        fail(f"head serving: the head is {head_rel} from float64")
    wall_s = time.perf_counter() - t_start
    print(f"phase 26: {wall_s:.1f} s", flush=True)
    record = dict(requests=HEAD_REQUESTS, request_ms=ms,
                  request_ms_min=min(req_ms),
                  request_ms_median=statistics.median(req_ms),
                  request_ms_p95=statistics.quantiles(req_ms, n=20)[-1],
                  host_cpu_ms=host_cpu_ms, peak_gib=peak_gb, counts=counts,
                  db_tiles=HEAD_TILES, db_bytes=db_bytes, db_build_s=build_s,
                  head_batch_ms=head_batch_ms,
                  head_request_ms=head_request_ms, render_diff=render_diff,
                  self_dist_max=float(self_dist.max()),
                  margin_min=float(margin.min()), head_rel_err=head_rel,
                  wall_s=wall_s)
    return record, pipe, db


def streaming_phase(card: str, pipe, db, auto_render, serve: dict) -> dict:
    """Phase 27: the streaming step and the replay on phase 26's pipeline
    and database."""
    import warnings

    import numpy as np
    import torch

    from bevrender_tpu_torch.data.synthetic import SyntheticDataset
    from bevrender_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    views = pipe.config.model.num_views
    seq = SyntheticDataset(n_items=SERVE_B, num_views=views,
                           window_num_imgs=STREAM_FRAMES - 1, img_height=224,
                           img_width=224).batch(SERVE_B)
    window = SyntheticDataset(n_items=SERVE_B, num_views=views,
                              window_num_imgs=1, img_height=224,
                              img_width=224).batch(SERVE_B)
    if not all(np.array_equal(seq[k][:, :2], window[k])
               for k in ("camera", "vehicle_pose")):
        fail("streaming: the sequence's first two frames are not phase 3's "
             "window")
    cam = torch.as_tensor(seq["camera"]).cuda()
    pose = torch.as_tensor(seq["vehicle_pose"]).cuda()
    vt = torch.as_tensor(seq["vehicle_type"]).cuda()
    # frame t warps with pose[:, lo:lo + 2], lo = min(t, T - 2) (the JAX
    # package's rule, tests/test_inference.py:87-114)
    lo = [min(t, STREAM_FRAMES - 2) for t in range(STREAM_FRAMES)]
    pairs = [pose[:, i:i + 2] for i in lo]
    step, replay = pipe.make_streaming_step(), pipe.make_replay_scan()

    # the first two frames under the two-frame window's rule: phase 3's render
    bev, _, _ = step(cam[:, 0], None, pose[:, 0:2], vt, db)
    _, out, _ = step(cam[:, 1], bev, pose[:, 0:2], vt, db)
    two_diff = float((out.float().cpu() - auto_render).abs().max())

    def chain(marks):
        bev, idx = None, []
        marks[0].record()
        for t in range(STREAM_FRAMES):
            bev, _, i = step(cam[:, t], bev, pairs[t], vt, db)
            idx.append(i)
            marks[t + 1].record()
        return bev, torch.stack(idx)

    torch.cuda.synchronize()
    kernels.reset_counts()
    frame_ms, chains = [], []
    cpu0 = time.process_time()
    for _ in range(STREAM_RUNS):
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(STREAM_FRAMES + 1)]
        chains.append(chain(marks))
        marks[-1].synchronize()
        frame_ms += [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    host_cpu_ms = (time.process_time() - cpu0) * 1e3 / len(frame_ms)
    counts = kernels.counts()
    want = expected(**{k: v * STREAM_FRAMES * STREAM_RUNS
                       for k, v in STREAM_PER_FRAME.items()})
    print(f"streaming launches over {STREAM_RUNS} sequences of "
          f"{STREAM_FRAMES} frames: {counts} (expected {want})", flush=True)
    if counts != want:
        fail(f"streaming: launch counts {counts} != {want}")

    frames = cam.transpose(0, 1)
    pose_pairs = torch.stack(pairs)
    # a first replay, untimed, where a first use may copy a cached constant
    # to the card: its host synchronisations are printed with their place
    # (the mode's own notice on first use, "Synchronization debug mode is a
    # prototype feature ...", is not one)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            replays = [replay(frames, pose_pairs, vt, db)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    first_syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                   if "called a synchronizing" in str(w.message)]
    # the timed replays raise on any host synchronisation
    kernels.reset_counts()
    replay_ms = []
    for _ in range(STREAM_RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            a.record()
            replays.append(replay(frames, pose_pairs, vt, db))
            b.record()
        except RuntimeError as e:
            fail(f"replay: a warm replay synchronised the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        b.synchronize()
        replay_ms.append(a.elapsed_time(b))
    counts_replay = kernels.counts()
    chain_bev, chain_idx = chains[0]
    same = [torch.equal(r[1], chain_idx) and torch.equal(r[0], chain_bev)
            for r in replays]
    same_chains = all(torch.equal(c[1], chain_idx)
                      and torch.equal(c[0], chain_bev) for c in chains)
    finite = bool(torch.isfinite(chain_bev.float()).all()) and bool(
        torch.isfinite(replays[0][2]).all())
    print(f"streaming flagship bf16 B={SERVE_B}, one encoder pass a frame: "
          f"{len(frame_ms)} frames ({STREAM_RUNS} sequences of "
          f"{STREAM_FRAMES}), per frame {per_call_text(frame_ms)} ms, host "
          f"CPU {host_cpu_ms:.3f} ms/frame; phase 3's T=2 window (two "
          f"encoder passes) {serve['request_ms']:.3f} ms/request, per "
          f"request min {serve['request_ms_min']:.3f} median "
          f"{serve['request_ms_median']:.3f} p95 {serve['request_ms_p95']:.3f}"
          f" [{card}]", flush=True)
    print(f"replay of {STREAM_FRAMES} frames: "
          f"{[round(m, 3) for m in replay_ms]} ms a sequence "
          f"({min(replay_ms) / STREAM_FRAMES:.3f} ms a frame at the least); "
          f"launches {counts_replay} (expected {want}); host "
          f"synchronisations: none in the timed replays, {first_syncs} in "
          f"the first; indices "
          f"{chain_idx.cpu().tolist()}; equal to the chain's (indices and "
          f"final BEV, bit for bit) {same}, the chains to each other "
          f"{same_chains}; two-frame render against phase 3's (max abs) "
          f"{two_diff} [{card}]", flush=True)
    if two_diff != 0.0:
        fail(f"streaming: two-frame render differs from phase 3's by "
             f"{two_diff}")
    if counts_replay != want:
        fail(f"replay: launch counts {counts_replay} != {want}")
    if not (all(same) and same_chains and finite):
        fail("replay: indices or final BEV differ from the chain's, or are "
             "not finite")
    wall_s = time.perf_counter() - t_start
    print(f"phase 27: {wall_s:.1f} s", flush=True)
    return dict(frames=len(frame_ms), frame_ms_min=min(frame_ms),
                frame_ms_median=statistics.median(frame_ms),
                frame_ms_p95=statistics.quantiles(frame_ms, n=20)[-1],
                host_cpu_ms=host_cpu_ms, counts=counts, replay_ms=replay_ms,
                first_replay_syncs=first_syncs, two_frame_diff=two_diff,
                wall_s=wall_s)


def train_phase(card: str, tag: str, cfg, fused_bwd: bool, site_remat: str,
                steps: int, profile_step: bool, per_step: dict) -> dict:
    """``steps`` optimizer steps of a bf16 model (``cfg``) on a fixed batch
    after one warm-up step, with every check of a training step; the kernels
    launch ``per_step`` times per step."""
    import shutil
    import tempfile

    import torch

    from bevrender_tpu_torch.data.synthetic import SyntheticDataset
    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.training.trainer import Trainer

    tag = f"{tag} train fused_bwd={fused_bwd} site_remat={site_remat}"
    tc = cfg.train
    tc.batch_size, tc.loss_type = TRAIN_B, "MSE"
    # ten times the default rate, so that ten steps move the loss by more
    # than the drop-path masks do from step to step
    tc.learning_rate = 1e-3
    tc.fused_bwd, tc.site_remat = fused_bwd, site_remat
    tc.work_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ds = SyntheticDataset(n_items=TRAIN_B, num_views=cfg.model.num_views,
                              window_num_imgs=1, img_height=224, img_width=224)
        trainer = Trainer(cfg, ds, device="cuda")
        state = trainer.create_state(seed=0)
        batch = {k: torch.as_tensor(v).cuda() for k, v in
                 ds.batch(TRAIN_B).items()}
        names = [n for n, _ in state.net.named_parameters()]
        params = [p for _, p in state.net.named_parameters()]
        bn_before = {n: b.clone() for n, b in state.net.named_buffers()
                     if n.endswith("running_var")}
        state, _, _ = trainer.train_step(state, batch, rng=7)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        losses, norms, step_ms = [], [], []
        seen = torch.zeros(len(params), device="cuda")
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        cpu_ms = 0.0
        for _ in range(steps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            c0 = time.process_time()
            a.record()
            state, m, render = trainer.train_step(state, batch, rng=7)
            b.record()
            cpu_ms += (time.process_time() - c0) * 1e3
            step_ms.append((a, b))
            losses.append(m["train_batch_loss"])
            norms.append(m["camera_encoder_grad_norm"])
            gn = torch.stack(torch._foreach_norm([p.grad for p in params]))
            finite = finite & torch.isfinite(gn).all()
            seen = torch.maximum(seen, gn)
        torch.cuda.synchronize()
        counts = kernels.counts()
        step_ms = [a.elapsed_time(b) for a, b in step_ms]
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [float(x) for x in losses]
        norms = [float(x) for x in norms]
        want = expected(**{k: v * steps for k, v in per_step.items()})
        print(f"{tag}: launches over {steps} steps {counts} (expected "
              f"{want})", flush=True)
        if counts != want:
            fail(f"{tag}: launch counts {counts} != {want}")
        print(f"{tag}: loss per step {[round(x, 6) for x in losses]}; grad "
              f"norm per step {[round(x, 4) for x in norms]}", flush=True)
        if not all(map(lambda x: x == x and abs(x) != float("inf"),
                       losses + norms)):
            fail(f"{tag}: non-finite loss or gradient norm")
        if not losses[-1] < losses[0]:
            fail(f"{tag}: loss did not fall: {losses[0]} -> {losses[-1]}")
        if not all(n > 0 for n in norms) or not bool(finite):
            fail(f"{tag}: a gradient norm is zero or a gradient non-finite")
        dead = [n for n, s in zip(names, seen.tolist()) if not s > 0]
        if dead:
            fail(f"{tag}: parameters that never had a gradient: {dead[:8]}")
        watched = {n: s for n, s in zip(names, seen.tolist())
                   if any(w in n for w in ("rpe_table", "offset",
                                           "transition", "img_width_fix"))}
        low = min(watched, key=watched.get)
        print(f"{tag}: all {len(names)} parameters had finite non-zero "
              f"gradients; of the {len(watched)} rpe tables, offset heads, "
              f"transitions and width fixes the smallest largest-norm is "
              f"{watched[low]:.3g} ({low})", flush=True)
        for n in [n for n in names if "transition" in n or "img_width_fix" in n
                  or n.endswith("layers.0.spatial_cross_attn.rpe_table")]:
            print(f"  {n}: largest gradient norm {watched[n]:.3g}",
                  flush=True)
        moved = [n for n, b in state.net.named_buffers()
                 if n in bn_before and not torch.equal(b, bn_before[n])]
        if len(moved) != len(bn_before):
            fail(f"{tag}: {len(bn_before) - len(moved)} BatchNorm buffers "
                 f"did not move")
        if tuple(render.shape) != (TRAIN_B, 224, 224, 3):
            fail(f"{tag}: render shape {tuple(render.shape)}")
        ms = sum(step_ms) / steps
        host = cpu_ms / steps
        print(f"{tag}: bf16 B={TRAIN_B} T=2, {steps} steps: "
              f"{ms:.3f} ms/step (min {min(step_ms):.3f} median "
              f"{statistics.median(step_ms):.3f} max {max(step_ms):.3f}); "
              f"host CPU {host:.3f} ms/step; peak {peak_gb:.3f} GiB; "
              f"{len(moved)} BatchNorm running variances moved [{card}]",
              flush=True)
        result = dict(fused_bwd=fused_bwd, site_remat=site_remat, steps=steps,
                      step_ms=ms, step_ms_min=min(step_ms),
                      step_ms_median=statistics.median(step_ms),
                      step_ms_max=max(step_ms), host_cpu_ms=host,
                      peak_gib=peak_gb, loss_first=losses[0],
                      loss_last=losses[-1], counts=counts)
        if profile_step:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                trainer.train_step(state, batch, rng=7)
                torch.cuda.synchronize()
            avgs = sorted(prof.key_averages(),
                          key=lambda e: -e.self_device_time_total)
            busy = sum(e.self_device_time_total for e in avgs) / 1e3
            idle = max(0.0, 1 - busy / ms)
            # fused_site_kernel is both instances, with and without lse, and
            # so is fused_site_wide_kernel
            seen_k = {n: seen_launches(avgs, n)
                      for n in ("fused_site", "lattice_bias",
                                "lattice_bias_bwd", "fused_site_bwd",
                                "lattice_bias_wide", "lattice_bias_wide_bwd",
                                "fused_site_wide", "lattice_bias_wide_prefetch",
                                "fused_site_fold_heads", "lattice_windows",
                                "lattice_windows_bwd")}
            print(f"{tag}: device time of one step (profiler): busy "
                  f"{busy:.3f} ms of {ms:.3f} ms/step, idle share "
                  f"{idle:.3f}; kernels seen by name {seen_k} [{card}]",
                  flush=True)
            for e in avgs[:15]:
                print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
                      f"x{e.count:<4d} {e.key[:100]}", flush=True)
            result.update(busy_ms=busy, idle_share=idle)
        del trainer, state, params
        torch.cuda.empty_cache()
        return result
    finally:
        shutil.rmtree(tc.work_dir, ignore_errors=True)


def small_model_epoch(kernels) -> dict:
    """``Trainer.train`` on the small model on the card: one K-fold epoch
    through ``DataLoader`` and ``device_prefetch`` (pinned memory, a side
    stream), validation with recall, a checkpoint written and read back."""
    import shutil
    import tempfile

    import torch

    from bevrender_tpu_torch.config import Config, tiny_model_config
    from bevrender_tpu_torch.data.synthetic import SyntheticDataset
    from bevrender_tpu_torch.training.trainer import Trainer

    cfg = Config()
    cfg.model = tiny_model_config(embed_dims=(32, 32, 32), n_heads=(2, 8),
                                  n_groups=(1, 4), drop_path_rate=0.1)
    tc = cfg.train
    tc.loss_type, tc.validation_metric = "MSE_CONTRASTIVE", "RECALL"
    tc.k_fold, tc.epoch_per_fold, tc.total_epochs = 2, 1, 2
    tc.num_workers, tc.log_every_steps = 2, 1
    tc.work_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ds = SyntheticDataset(n_items=8, num_views=2, window_num_imgs=1,
                              img_height=32, img_width=32, map_tile=32)
        trainer = Trainer(cfg, ds, device="cuda")
        kernels.reset_counts()
        state = trainer.train(trainer.create_state(seed=4))
        torch.cuda.synchronize()
        used = kernels.counts()
        saved = sorted(p.name for p in Path(tc.work_dir).glob("*.pt"))
        if state.step != 2 or not saved:
            fail(f"small-model epoch: {state.step} steps, checkpoints {saved}")
        resumed = trainer.restore_checkpoint(trainer.create_state(seed=5),
                                             str(Path(tc.work_dir) / saved[0]))
        same = all(torch.equal(a, b) for a, b in zip(
            resumed.net.state_dict().values(), state.net.state_dict().values()))
        if resumed.step != 2 or not same:
            fail("small-model epoch: the checkpoint does not restore the state")
        if not (used["lattice_bias"] > 0 and used["lattice_bias_bwd"] > 0
                and used["fused_site"] > 0):
            fail(f"small-model epoch missed a kernel: {used}")
        print(f"small model, one K-fold epoch on the card through "
              f"Trainer.train: {state.step} steps, checkpoints {saved}, best "
              f"R@5 {trainer.best_epoch_recall:.1f}, kernels {used}",
              flush=True)
        return dict(steps=state.step, used=used)
    finally:
        shutil.rmtree(tc.work_dir, ignore_errors=True)


def small_model_grads(da, kernels, fused_bwd: bool, wide: bool = False) -> dict:
    """Parameter gradients of a small 2-stage model in train mode (float32,
    all drop rates 0) through the kernels and through plain PyTorch with the
    kernels' roundings. The model: BEV 8 x 8 at width 32 (stage 1 of head
    width 4 with G=4: fused site and views folded); with ``wide``, BEV
    56 -> 28 -> 56 at width 32 with 2 heads (head width 16: bias kernels and
    plain consumer in the final pass, ``fused_site_mma`` in the history
    pass, which the mirror run keeps) and depth 5, 224 x 224 images, whose
    SCA table at BEV 56 (2 x 111 x 559) takes the wide kernels."""
    import torch

    from bevrender_tpu_torch.config import tiny_model_config
    from bevrender_tpu_torch.data.synthetic import SyntheticDataset
    from bevrender_tpu_torch.models.attention import set_site_options
    from bevrender_tpu_torch.models.bevrender import BEVRenderNet
    from bevrender_tpu_torch.models.layers import init_params

    if wide:
        img = 224
        mc = tiny_model_config(
            bev_shapes=(56, 28, 56), embed_dims=(32, 32, 32), n_heads=(2, 2),
            n_groups=(1, 1), strides=(8, 4), kernel_sizes=(9, 7),
            bev_depth_dim=5, img_height=img, img_width=img,
            ori_img_height=img, ori_img_width=img)
        need = ("lattice_bias", "lattice_bias_bwd", "lattice_bias_wide",
                "lattice_bias_wide_bwd")
    else:
        img = 32
        mc = tiny_model_config(embed_dims=(32, 32, 32), n_heads=(2, 8),
                               n_groups=(1, 4))
        need = (("lattice_bias", "lattice_bias_bwd", "fused_site")
                + (("fused_site_lse", "fused_site_bwd") if fused_bwd else ()))
    net = init_params(BEVRenderNet(mc), 2).cuda().train()
    set_site_options(net, fused_bwd=fused_bwd, site_remat="nothing")
    sb = {k: torch.as_tensor(v).cuda() for k, v in SyntheticDataset(
        n_items=2, num_views=2, window_num_imgs=1, img_height=img,
        img_width=img, map_tile=32 if img == 32 else 224,
        seed=3).batch(2).items()}
    bn = {n: b.clone() for n, b in net.state_dict().items()
          if "running_" in n}

    def grads():
        net.load_state_dict({**net.state_dict(), **bn})  # same BN buffers
        net.zero_grad(set_to_none=True)
        out = net(sb["camera"], sb["vehicle_pose"], sb["vehicle_type"])
        torch.mean((out - sb["map"]) ** 2).backward()
        return {n: p.grad.clone() for n, p in net.named_parameters()}

    kernels.reset_counts()
    g_k = grads()
    used = kernels.counts()
    with plain_sites(da, online=True, keep_mma=True):
        g_o = grads()
    torch.cuda.synchronize()
    g_k2 = grads()  # the kernels again: their atomics sum in another order
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in g_o.values())

    def dist(a, b):
        return {n: float((a[n] - b[n]).abs().max()
                         / b[n].abs().max().clamp(min=floor))
                for n in a if float(b[n].abs().max()) > 0}

    errs = dist(g_k, g_o)
    noise = max(dist(g_k2, g_k).values())
    worst = max(errs, key=errs.get)
    for n in sorted(errs, key=errs.get)[-3:]:
        print(f"  {errs[n]:.3g}  {n} (largest entry "
              f"{float(g_o[n].abs().max()):.3g}, floor {floor:.3g})", flush=True)
    print(f"small model gradients (2 stages{', BEV 56-28-56' if wide else ''}"
          f", f32, B=2, T=2, train mode, "
          f"fused_bwd={fused_bwd}), kernels {used}: largest difference to "
          f"plain PyTorch with the kernels' roundings {errs[worst]:.3g} of "
          f"the gradient's largest entry ({worst}; tolerance {GRAD_TOL}) "
          f"over {len(errs)} parameters; two runs of the kernels differ by "
          f"{noise:.3g}", flush=True)
    if not all(used[k] > 0 for k in need):
        fail(f"small model's training step missed a kernel: {used}")
    if len(errs) != len(g_k):
        fail("small model: a parameter has no gradient")
    if not errs[worst] <= GRAD_TOL:
        fail(f"small-model gradients differ by {errs[worst]} at {worst}")
    return dict(worst=errs[worst], at=worst, used=used, run_to_run=noise)


# The file-fed trainer (phase 28): a smooth seeded world of FEED_WORLD
# pixels square saved as the full map PNG; a trace of FEED_FRAMES frames at
# 4 Hz with a 5 s gap after frame FEED_GAP_AT (two sequences); a frame is a
# wide camera PNG at the flagship's source size (three 512 x 640 views side
# by side, each a world crop around the pose with noise) and the 224 x 224
# map tile at its pose. Windows: T=2 from overlapping 2 s windows, 14 a
# sequence; half train (7 steps at B=2), half validate.
FEED_WORLD = 2048
FEED_FRAMES = 32
FEED_GAP_AT = 16
FEED_SRC = (512, 640)
FEED_TILE = 224
FEED_CACHE_MB = 256
# the device route against the host route on the same window (cache off,
# float32 throughout on both), normalised values: the device resize takes
# its sample positions in float32 as jax.image.resize does, rounded near
# x = 1920 to ~2^-13 of a pixel, which moves a tap weight by ~6e-5 (1e-4
# measured on a random 512 x 1920 frame on the CPU); a wrong filter or
# rounding to uint8 shows as a level, 1/255/0.225 = 0.017
ROUTE_TOL = 5e-4


def feed_world(rng):
    """(FEED_WORLD, FEED_WORLD, 3) uint8: two octaves of seeded noise
    upsampled bilinearly, as ``SyntheticGeoDataset`` makes its world."""
    import numpy as np

    def octave(res):
        low = rng.standard_normal((res, res, 3)).astype(np.float32)
        s = np.linspace(0, res - 1, FEED_WORLD, dtype=np.float32)
        i0 = np.floor(s).astype(int)
        i1 = np.minimum(i0 + 1, res - 1)
        w = (s - i0)[:, None, None]
        rows = low[i0] * (1 - w) + low[i1] * w
        w = w[None, :, :, 0]
        return rows[:, i0] * (1 - w) + rows[:, i1] * w

    up = octave(FEED_WORLD // 16) + 0.5 * octave(FEED_WORLD // 4)
    up = (up - up.min()) / (up.max() - up.min())
    return (up * 255).round().astype(np.uint8)


def write_feed(root: Path, seed: int = 0) -> dict:
    """The trace's files under ``root``, written by the port's encoder
    (frames in parallel: zlib and numpy release the GIL): rgb/<ts>.png,
    map/<ts>.png, world.png, gps.csv. Returns the paths, the world and the
    per-frame poses."""
    import concurrent.futures

    import numpy as np

    from bevrender_tpu_torch.data.png import encode_png

    rng = np.random.default_rng(seed)
    world = feed_world(rng)
    (root / "rgb").mkdir(parents=True)
    (root / "map").mkdir()
    t = np.arange(FEED_FRAMES) / (FEED_FRAMES - 1)
    px = np.round(600 + 850 * t).astype(int)
    py = np.round(FEED_WORLD / 2 + 300 * np.sin(3 * t)).astype(int)
    yaw = 0.5 * t
    ts, stamp = [], 1_700_000_000_000_000
    for i in range(FEED_FRAMES):
        stamp += 5_000_000 if i == FEED_GAP_AT else 0
        ts.append(stamp)
        stamp += 250_000
    vh, vw = FEED_SRC

    def frame(i):
        r = np.random.default_rng([seed, i])
        views = []
        for v in range(3):
            cy, cx = py[i] + 64 * (v - 1), px[i] + 160 * (v - 1)
            crop = world[cy - vh // 2:cy + vh // 2, cx - vw // 2:cx + vw // 2]
            noisy = crop + r.normal(0.0, 12.75, crop.shape)
            views.append(np.clip(noisy, 0, 255).round().astype(np.uint8))
        encode_png(root / "rgb" / f"{ts[i]}.png", np.concatenate(views, 1))
        h = FEED_TILE // 2
        encode_png(root / "map" / f"{ts[i]}.png",
                   world[py[i] - h:py[i] + h, px[i] - h:px[i] + h])

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        jobs = [pool.submit(frame, i) for i in range(FEED_FRAMES)]
        jobs.append(pool.submit(encode_png, root / "world.png", world))
        for j in jobs:
            j.result()
    rows = [[ts[i], 0, px[i], FEED_WORLD - py[i], -10.0, 0.0, 0.0, yaw[i]]
            for i in range(FEED_FRAMES)]
    np.savetxt(root / "gps.csv", np.asarray(rows, np.float64), delimiter=",")
    return dict(root=root, world=world, csv=root / "gps.csv",
                map=root / "world.png")


def feed_config(feed: dict, on_device_preprocess):
    """The flagship bf16 trainer on the trace: B=2, T=2 (window_num_imgs
    1, overlapping windows), MSE, two folds, one epoch a fold,
    validation on."""
    from bevrender_tpu_torch.config import flagship_config

    cfg = flagship_config(dtype="bfloat16")
    dc = cfg.data
    root = feed["root"]
    dc.gps_file_path = str(feed["csv"])
    dc.rgb_img_dir, dc.map_img_dir = str(root / "rgb"), str(root / "map")
    dc.map_jgw_info = (1.0, 0.0, 0.0, -1.0, 0.0, float(FEED_WORLD))
    dc.map_width = dc.map_height = FEED_WORLD
    dc.map_path, dc.map_month = {"feed": str(feed["map"])}, "feed"
    dc.window_num_imgs, dc.overlap = 1, True
    dc.frame_cache_mb = FEED_CACHE_MB
    dc.on_device_preprocess = on_device_preprocess
    tc = cfg.train
    tc.batch_size, tc.loss_type = TRAIN_B, "MSE"
    tc.k_fold, tc.epoch_per_fold = 2, 1
    tc.ckpt_dir = str(root / f"ckpt_{int(bool(on_device_preprocess))}")
    return cfg


def feed_dataset(cfg, **kw):
    """The trace's windows in a ``GPSDeniedDataset``, as ``train.main``
    builds it, with ``kw`` overriding its arguments."""
    from bevrender_tpu_torch.data.dataset import GPSDeniedDataset
    from bevrender_tpu_torch.train import build_dataset
    from bevrender_tpu_torch.training.metrics import get_logger

    ds = build_dataset(cfg, get_logger())
    if not kw:
        return ds
    dc = cfg.data
    args = dict(mode="train", num_views=dc.num_views,
                window_num_imgs=dc.window_num_imgs,
                resize_img_height=dc.resize_img_height,
                resize_img_width=dc.resize_img_width,
                img_norm_mean=dc.camera_norm_mean,
                img_norm_std=dc.camera_norm_std, seed=cfg.train.seed,
                raw_uint8=bool(dc.on_device_preprocess),
                cache_mb=dc.frame_cache_mb)
    args.update(kw)
    return GPSDeniedDataset(ds.datalist, **args)


def feed_timing(cfg) -> dict:
    """The feed alone on the host: ms a sample over every window, one
    thread, with the cache off (one native call a frame), cold and warm
    through the cache, and for the device route's raw frames; samples/s of
    the loader (``num_workers`` threads, cache off); the bytes a batch of
    each route crosses to the device."""
    from bevrender_tpu_torch.data.prefetch import DataLoader, collate

    def per_sample(ds) -> float:
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        return (time.perf_counter() - t0) * 1e3 / len(ds)

    off = feed_dataset(cfg, cache_mb=0, raw_uint8=False)
    cached = feed_dataset(cfg, cache_mb=FEED_CACHE_MB, raw_uint8=False)
    raw = feed_dataset(cfg, cache_mb=0, raw_uint8=True)
    out = dict(samples=len(off), ms_cache_off=per_sample(off),
               ms_cache_cold=per_sample(cached),
               ms_cache_warm=per_sample(cached),
               ms_raw_uint8=per_sample(raw),
               cache_hits=cached.cache.hits, cache_misses=cached.cache.misses)
    loader = DataLoader(off, TRAIN_B, num_workers=cfg.train.num_workers)
    t0 = time.perf_counter()
    n = sum(len(b["timestamp"]) for b in loader)
    out["loader_samples_s"] = n / (time.perf_counter() - t0)
    out["loader_workers"] = cfg.train.num_workers
    for name, ds in (("host", off), ("raw_uint8", raw)):
        out[f"batch_bytes_{name}"] = sum(
            v.nbytes for v in collate([ds[0], ds[1]]).values())
    out["samples_s_cache_off"] = 1e3 / out["ms_cache_off"]
    out["samples_s_cache_warm"] = 1e3 / out["ms_cache_warm"]
    return out


@contextlib.contextmanager
def step_probe(n_steps: int, profile_last: bool):
    """While ``train.main`` runs: per ``Trainer.train_step``, the kernels'
    launch counts, CUDA events around it, the host clock and the process's
    CPU time at its entry, the calling thread's CPU time and the loss; with
    ``profile_last``, the device time of the last step (the profiler,
    device activity only, as phase 6 profiles one step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.training.trainer import Trainer

    rec = dict(counts=[], events=[], entry=[], cpu=[], thread_cpu=[],
               losses=[], busy_ms=None)
    prof = profile(activities=[ProfilerActivity.CUDA])
    orig = Trainer.train_step

    def probed(self, state, batch, rng=0):
        profiled = profile_last and len(rec["counts"]) == n_steps - 1
        if profiled:
            torch.cuda.synchronize()
            prof.start()
        rec["entry"].append(time.perf_counter())
        rec["cpu"].append(time.process_time())
        before = kernels.counts()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        c0 = time.thread_time()
        a.record()
        out = orig(self, state, batch, rng)
        b.record()
        rec["thread_cpu"].append((time.thread_time() - c0) * 1e3)
        after = kernels.counts()
        rec["counts"].append({k: after[k] - before[k] for k in after})
        rec["events"].append((a, b))
        rec["losses"].append(out[1]["train_batch_loss"])
        if profiled:
            torch.cuda.synchronize()
            prof.stop()
            rec["busy_ms"] = sum(e.self_device_time_total
                                 for e in prof.key_averages()) / 1e3
        return out

    Trainer.train_step = probed
    try:
        yield rec
    finally:
        Trainer.train_step = orig


def feed_train(card: str, tag: str, cfg, n_steps: int,
               profile_last: bool) -> dict:
    """``train.main`` on ``cfg`` (one epoch: ``--epochs 2``) under
    ``step_probe``: every step's launches equal phase 6's, every loss
    finite, a checkpoint and config.yaml written. Steps 2 to n-1 are
    timed (the first warms up, the last may be profiled). Returns the
    step measurements and the checkpoint."""
    import torch

    from bevrender_tpu_torch import train as train_mod

    path = Path(cfg.train.ckpt_dir).with_suffix(".json")
    path.write_text(cfg.to_json())
    t0 = time.perf_counter()
    with step_probe(n_steps, profile_last) as rec:
        state = train_mod.main(["--config", str(path), "--epochs", "2"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    want = expected(**TRAIN_COUNTS[(False, "nothing")])
    steps = len(rec["counts"])
    bad = [i for i, c in enumerate(rec["counts"]) if c != want]
    print(f"{tag}: {steps} steps, launches a step {rec['counts'][0]} "
          f"(expected {want}, phase 6's)", flush=True)
    if steps != n_steps or bad or state.step != n_steps:
        fail(f"{tag}: {steps} steps (want {n_steps}), steps {bad} launched "
             f"other counts than phase 6's: "
             f"{[rec['counts'][i] for i in bad][:2]}")
    losses = [float(x) for x in rec["losses"]]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{tag}: a loss is not finite: {losses}")
    (work,) = Path(cfg.train.ckpt_dir).iterdir()
    ckpts = sorted(p.name for p in work.glob("*.pt"))
    if not ckpts or not (work / "config.yaml").is_file():
        fail(f"{tag}: no checkpoint or config.yaml in {work}: "
             f"{sorted(p.name for p in work.iterdir())}")
    timed = range(1, steps - 1)
    wall = [(rec["entry"][i + 1] - rec["entry"][i]) * 1e3
            for i in timed[:-1]]
    dev = [rec["events"][i][0].elapsed_time(rec["events"][i][1])
           for i in timed]
    out = dict(steps=steps, run_s=run_s, losses=losses, checkpoints=ckpts,
               counts_per_step=rec["counts"][0],
               step_ms_median=statistics.median(wall),
               step_ms_min=min(wall), step_ms_max=max(wall),
               device_span_ms_median=statistics.median(dev),
               host_cpu_ms=statistics.median(rec["thread_cpu"][1:-1]),
               process_cpu_ms=(rec["cpu"][timed[-1]] - rec["cpu"][1]) * 1e3
               / len(wall),
               checkpoint=str(work / ckpts[-1]))
    busy = ""
    if rec["busy_ms"] is not None:
        out.update(busy_ms=rec["busy_ms"], idle_share=max(
            0.0, 1 - rec["busy_ms"] / out["step_ms_median"]))
        busy = (f"; device busy {out['busy_ms']:.3f} ms in step {steps} "
                f"(profiler), idle share {out['idle_share']:.3f} of the "
                f"median step")
    print(f"{tag}: loss per step {[round(x, 6) for x in losses]}; "
          f"checkpoints {ckpts} and config.yaml in {work.name}; "
          f"{out['step_ms_median']:.3f} ms/step median over steps "
          f"2-{steps - 1} (host clock, step entry to entry; min "
          f"{out['step_ms_min']:.3f} max {out['step_ms_max']:.3f}); device "
          f"span of a step {out['device_span_ms_median']:.3f} ms; host CPU "
          f"{out['host_cpu_ms']:.3f} ms/step in the training thread, "
          f"{out['process_cpu_ms']:.3f} ms/step in the process (loader "
          f"threads included){busy}; whole run {run_s:.1f} s [{card}]",
          flush=True)
    del state
    torch.cuda.empty_cache()
    return out


def file_feed_phase(card: str, train_default: dict) -> dict:
    """Phase 28: the flagship trained by ``train.main`` from a GPS trace
    and PNG frames the phase writes, on the host route and the device
    route; the feed timed alone; the two routes' camera tensors compared;
    render+register served from the map PNG's tiles with the trained
    checkpoint."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from bevrender_tpu_torch.data.maploader import MapLoader
    from bevrender_tpu_torch.data.prefetch import collate
    from bevrender_tpu_torch.data.preprocess import make_preprocessor
    from bevrender_tpu_torch.inference.register import RegistrationPipeline
    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.training.trainer import kfold_indices

    t_start = time.perf_counter()
    (HERE / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_feed_", dir=HERE / "build"))
    try:
        feed = write_feed(root)
        write_s = time.perf_counter() - t_start
        host_cfg = feed_config(feed, False)
        timing = feed_timing(host_cfg)
        n_windows = timing["samples"]
        train_idx, _ = next(kfold_indices(n_windows, host_cfg.train.k_fold,
                                          host_cfg.train.seed))
        n_steps = len(train_idx) // TRAIN_B
        print(f"file feed: {FEED_FRAMES} frames (wide PNG "
              f"{FEED_SRC[0]} x {3 * FEED_SRC[1]}, map tile {FEED_TILE}), "
              f"{n_windows} windows, written in {write_s:.1f} s; one "
              f"thread: cache off {timing['ms_cache_off']:.3f} ms/sample "
              f"({timing['samples_s_cache_off']:.2f} samples/s), cache cold "
              f"{timing['ms_cache_cold']:.3f}, warm "
              f"{timing['ms_cache_warm']:.3f} ms/sample "
              f"({timing['samples_s_cache_warm']:.2f} samples/s), raw uint8 "
              f"{timing['ms_raw_uint8']:.3f} ms/sample; loader "
              f"({timing['loader_workers']} threads, cache off) "
              f"{timing['loader_samples_s']:.2f} samples/s; bytes a batch "
              f"of {TRAIN_B} crosses to the device: host route "
              f"{timing['batch_bytes_host']}, raw uint8 "
              f"{timing['batch_bytes_raw_uint8']} [{card}]", flush=True)

        host = feed_train(card, "file-fed train (host route)", host_cfg,
                          n_steps, profile_last=True)
        dev_cfg = feed_config(feed, True)
        device = feed_train(card, "file-fed train (device route)", dev_cfg,
                            n_steps, profile_last=False)
        print(f"file-fed training against phase 6 (a fixed batch on the "
              f"card): {host['step_ms_median']:.3f} (host route) and "
              f"{device['step_ms_median']:.3f} (device route) ms/step "
              f"median on the host clock, device span "
              f"{host['device_span_ms_median']:.3f} / "
              f"{device['device_span_ms_median']:.3f} ms, phase 6 "
              f"{train_default['step_ms_median']:.3f} ms (events); host "
              f"CPU {host['host_cpu_ms']:.3f} / {device['host_cpu_ms']:.3f} "
              f"ms/step in the training thread, phase 6 "
              f"{train_default['host_cpu_ms']:.3f}; idle share "
              f"{host['idle_share']:.3f} (host route), phase 6 "
              f"{train_default['idle_share']:.3f} [{card}]",
              flush=True)

        # the same window through both routes
        s_host = feed_dataset(host_cfg, cache_mb=0, raw_uint8=False)[0]
        s_raw = feed_dataset(dev_cfg, cache_mb=0)[0]
        if not np.array_equal(s_host["vehicle_pose"], s_raw["vehicle_pose"]):
            fail("file feed: the two routes drew different frames")
        stage = make_preprocessor(dev_cfg.data)
        with torch.no_grad():
            dev = stage({k: torch.from_numpy(np.asarray(v)[None]).cuda()
                         for k, v in s_raw.items()})
        route_diff = float((dev["camera"][0].cpu()
                            - torch.from_numpy(s_host["camera"])).abs().max())
        map_diff = float((dev["map"][0].cpu()
                          - torch.from_numpy(s_host["map"])).abs().max())
        print(f"file feed: device-route camera tensor against the host "
              f"route's on the same window (cache off), max abs {route_diff:.3g} "
              f"(bound {ROUTE_TOL}); map max abs {map_diff:.3g}", flush=True)
        if not (route_diff <= ROUTE_TOL and map_diff <= 2.0 ** -24):
            fail(f"file feed: device route departs from the host route: "
                 f"camera {route_diff}, map {map_diff}")

        # serving from the map PNG's tiles with the trained checkpoint
        loader = MapLoader(host_cfg.data.map_path, host_cfg.data.map_month)
        tiles = list(loader.iter_tiles(FEED_TILE, stride=FEED_TILE))
        world = feed["world"].astype(np.float32) / 255.0
        n_side = (FEED_WORLD - FEED_TILE) // FEED_TILE + 1
        bad = [(y, x) for (y, x), t in tiles
               if not np.array_equal(t, world[y:y + FEED_TILE,
                                              x:x + FEED_TILE])]
        if len(tiles) != n_side ** 2 or bad:
            fail(f"file feed: {len(tiles)} tiles (want {n_side ** 2}), "
                 f"{len(bad)} differ from the world's slices")
        pipe = RegistrationPipeline.from_checkpoint(host_cfg,
                                                    host["checkpoint"],
                                                    device="cuda")
        db = pipe.build_tile_database([t for _, t in tiles])
        served = feed_dataset(host_cfg, cache_mb=0)
        window = collate([served[i] for i in range(SERVE_B)])
        kernels.reset_counts()
        render, idx, dist = pipe.register(window, top_k=5)
        torch.cuda.synchronize()
        counts = kernels.counts()
        want = expected(fused_site=FUSED_PER_FORWARD,
                        fused_site_mma=MMA_PER_FORWARD)
        ok = (tuple(idx.shape) == (SERVE_B, 5)
              and bool(((idx >= 0) & (idx < len(tiles))).all())
              and bool(torch.isfinite(dist).all())
              and bool((dist[:, 1:] >= dist[:, :-1]).all())
              and bool(torch.isfinite(render).all()) and counts == want)
        print(f"file feed serving: {len(tiles)} tiles of the map PNG "
              f"({db.shape[1]}-D), a file-fed window of {SERVE_B} registered "
              f"with the trained checkpoint: top-5 {idx.tolist()}, distances "
              f"{[[round(float(d), 5) for d in r] for r in dist]}; launches "
              f"{counts}", flush=True)
        if not ok:
            fail(f"file feed serving: top-k {idx.tolist()} {dist.tolist()}, "
                 f"launches {counts} (expected {want})")
        del pipe, db
        torch.cuda.empty_cache()
        phase_s = time.perf_counter() - t_start
        print(f"phase 28: {phase_s:.1f} s", flush=True)
        return dict(feed=timing, host=host, device=device,
                    route_diff=route_diff, tiles=len(tiles),
                    write_s=write_s, phase_s=phase_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- phase 29: grouped, graph-replayed training and site_remat ----------
GRAPH_K = 4              # steps a dispatch
GRAPH_DISPATCHES = 2
GRAPH_STEPS = GRAPH_K * GRAPH_DISPATCHES
# graphed against eager: within SPREAD_FACTOR times the spread of two eager
# runs of the same steps (float atomics in grid_sampler_2d_backward and
# #9), and never tighter than GRAPH_REL_FLOOR of the eager value
SPREAD_FACTOR = 4.0
GRAPH_REL_FLOOR = 1e-5
# site_remat "dots" recomputes the bias in the backward, as "nothing" does
REMAT_COUNTS = {"nothing": TRAIN_COUNTS[(False, "nothing")],
                "dots": TRAIN_COUNTS[(False, "nothing")],
                "none": TRAIN_COUNTS[(False, "none")]}


def release() -> None:
    """Free a dropped trainer's card memory: its captured step refers back
    to it, so the graph's pool goes with a garbage collection."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def graph_config(fused_bwd: bool, site_remat: str = "nothing", k: int = 1,
                 work_dir: str | None = None):
    """The flagship as phase 6 trains it (bf16, B=2, T=2, MSE, drop path
    0.2, AdamW at 1e-3) with ``k`` steps a dispatch, writing to
    ``work_dir`` (a new temporary directory if None)."""
    import tempfile

    from bevrender_tpu_torch.config import flagship_config

    cfg = flagship_config(dtype="bfloat16")
    tc = cfg.train
    tc.batch_size, tc.loss_type, tc.learning_rate = TRAIN_B, "MSE", 1e-3
    tc.fused_bwd, tc.site_remat, tc.steps_per_dispatch = fused_bwd, \
        site_remat, k
    tc.work_dir = work_dir or tempfile.mkdtemp(prefix="chip_smoke_")
    return cfg


def graph_batches(n: int) -> list:
    """``n`` distinct seeded flagship batches on the card."""
    import torch

    from bevrender_tpu_torch.data.prefetch import collate
    from bevrender_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(n_items=n * TRAIN_B, num_views=3,
                          window_num_imgs=1, img_height=224, img_width=224)
    return [{k: torch.as_tensor(v).cuda() for k, v in collate(
        [ds[i * TRAIN_B + j] for j in range(TRAIN_B)]).items()}
        for i in range(n)]


def within_spread(got, ref, other) -> tuple:
    """(worst ratio, name) over the tensors of the dicts of |got - ref|
    against max(SPREAD_FACTOR x the card's spread, GRAPH_REL_FLOOR) x max
    |ref|, where the spread is the largest relative difference of any
    tensor between two eager runs ``ref`` and ``other`` (their
    differences come from float atomics and grow through the steps alike
    in every tensor, so one number for the state is steadier than a
    tensor's own); a ratio above 1 fails."""
    return spread_ratio(got, ref, ref, other)


def spread_ratio(got, ref, a, b) -> tuple:
    """``within_spread`` of ``got`` against ``ref``, with the spread taken
    between two other runs ``a`` and ``b``."""
    rel = max(float((b[n].float() - r.float()).abs().max())
              / max(float(r.float().abs().max()), 1e-30)
              for n, r in a.items())
    worst, at = 0.0, ""
    for name, r in ref.items():
        r = r.float()
        tol = max(SPREAD_FACTOR * rel, GRAPH_REL_FLOOR) * max(
            float(r.abs().max()), 1e-30)
        ratio = float((got[name].float().to(r.device) - r).abs().max()) / tol
        if not ratio <= worst:
            worst, at = ratio, name
    return worst, at


def union_ms(events) -> float:
    """Milliseconds covered by the union of the CUDA events' intervals of
    a profile (``prof.events()``)."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def snapshot(state) -> list:
    """Copies of what a training step changes in place: parameters,
    buffers and AdamW's tensors, and the step count."""
    import torch

    tensors = (list(state.net.parameters()) + list(state.net.buffers())
               + [v for st in state.optimizer.state.values()
                  for v in st.values() if torch.is_tensor(v)])
    return [(t, t.detach().clone()) for t in tensors] + [state.step]


def restore(state, saved: list) -> None:
    import torch

    with torch.no_grad():
        for t, c in saved[:-1]:
            t.copy_(c)
    state.step = saved[-1]


def graph_route(card: str, fused_bwd: bool, batches: list,
                keep: dict | None = None) -> dict:
    """Two eager runs of GRAPH_STEPS steps and GRAPH_DISPATCHES dispatches
    of GRAPH_K graphed sub-steps, each from the same seeded state on the
    same batches; the graphed losses and final parameters held to the
    eager spread; times, capture, idle share, peak memory. ``keep``, when
    given, receives what phase 30 replays: the seeded state, the groups,
    the graphed losses and parameters and both eager runs' (on the
    host)."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.training import graph_step
    from bevrender_tpu_torch.training.trainer import Trainer

    tag = f"phase 29 graphed fused_bwd={fused_bwd}"
    per_step = TRAIN_COUNTS[(fused_bwd, "nothing")]
    cfg = graph_config(fused_bwd, k=GRAPH_K)
    try:
        t_start = time.perf_counter()
        trainer = Trainer(cfg, None, device="cuda")
        if not trainer.graphed:
            fail(f"{tag}: the trainer does not take graphed steps")
        eager = []
        for run in range(2):
            state = trainer.create_state(seed=0)
            losses, ev = [], []
            for i in range(GRAPH_STEPS):
                if i == 1:  # step 1 carries the first call's costs
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                state, m, _ = trainer.train_step(state, batches[i], rng=7)
                b.record()
                losses.append(m["train_batch_loss"])
                ev.append((a, b))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            eager.append(dict(
                losses=torch.stack(losses).float().cpu(),
                params={n: p.detach().clone()
                        for n, p in state.net.named_parameters()},
                ms=statistics.mean(a.elapsed_time(b) for a, b in ev[1:]),
                wall_ms=wall / (GRAPH_STEPS - 1)))
            del state
        torch.cuda.empty_cache()

        t_eager = time.perf_counter()
        state = trainer.create_state(seed=0)
        if keep is not None:
            keep["state_dict"] = {n: t.detach().cpu().clone() for n, t in
                                  state.net.state_dict().items()}
        bn_before = {n: b.clone() for n, b in state.net.named_buffers()
                     if n.endswith("running_var")}
        groups = [{k: torch.stack([b[k] for b in batches[d * GRAPH_K:
                                                         (d + 1) * GRAPH_K]])
                   for k in batches[0]} for d in range(GRAPH_DISPATCHES)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        losses = []
        state, m, _ = trainer.train_step_multi(state, groups[0], rng=7)
        torch.cuda.synchronize()
        capture_counts = kernels.counts()
        losses.append(m["train_batch_loss"])
        graph = trainer.step_graph
        ev = []
        t0 = time.perf_counter()
        for d in range(1, GRAPH_DISPATCHES):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            state, m, render = trainer.train_step_multi(state, groups[d],
                                                        rng=7)
            b.record()
            losses.append(m["train_batch_loss"])
            ev.append((a, b))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / (
            (GRAPH_DISPATCHES - 1) * GRAPH_K)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = statistics.mean(a.elapsed_time(b) for a, b in ev) / GRAPH_K
        if trainer.step_graph is not graph:
            fail(f"{tag}: the step was captured again between dispatches")
        replay_counts = kernels.counts()
        n_capture = graph_step.WARMUP_STEPS + 1
        want = expected(**{k: v * n_capture for k, v in per_step.items()})
        print(f"{tag}: launches counted while the step was warmed up "
              f"({graph_step.WARMUP_STEPS} steps) and captured: "
              f"{capture_counts} (expected {want}); counted over the "
              f"replays after it: {replay_counts}", flush=True)
        if capture_counts != want:
            fail(f"{tag}: launches of the captured step {capture_counts} "
                 f"!= {want}")
        losses = torch.cat(losses).float().cpu()
        params = {n: p.detach() for n, p in state.net.named_parameters()}
        if keep is not None:
            keep.update(
                groups=groups, losses=losses, ms=ms, counts=capture_counts,
                params={n: p.cpu().clone() for n, p in params.items()},
                eager=[{"losses": e["losses"], "params": {
                    n: p.cpu() for n, p in e["params"].items()}}
                    for e in eager])
        ratio_loss, _ = within_spread({"loss": losses},
                                      {"loss": eager[0]["losses"]},
                                      {"loss": eager[1]["losses"]})
        ratio_par, worst_par = within_spread(params, eager[0]["params"],
                                             eager[1]["params"])
        spread = float((eager[0]["losses"] - eager[1]["losses"]).abs().max())
        print(f"{tag}: losses graphed {[round(float(x), 6) for x in losses]}"
              f"; eager {[round(float(x), 6) for x in eager[0]['losses']]}; "
              f"eager spread {spread:.3g}; graphed against eager, worst "
              f"share of the tolerance: losses {ratio_loss:.3g}, parameters "
              f"{ratio_par:.3g} ({worst_par})", flush=True)
        if not (ratio_loss <= 1.0 and ratio_par <= 1.0):
            fail(f"{tag}: graphed steps part from the eager ones beyond "
                 f"the eager spread (losses {ratio_loss}, parameters "
                 f"{ratio_par} at {worst_par})")
        if not bool(torch.isfinite(losses).all()) or not all(
                bool(torch.isfinite(p).all()) for p in params.values()):
            fail(f"{tag}: a non-finite loss or parameter")
        if not losses[-1] < losses[0]:
            fail(f"{tag}: loss did not fall: {losses[0]} -> {losses[-1]}")
        moved = [n for n, b in state.net.named_buffers()
                 if n in bn_before and not torch.equal(b, bn_before[n])]
        if len(moved) != len(bn_before):
            fail(f"{tag}: {len(bn_before) - len(moved)} BatchNorm buffers "
                 f"did not move")
        if tuple(render.shape) != (TRAIN_B, 224, 224, 3):
            fail(f"{tag}: render shape {tuple(render.shape)}")

        t_graph = time.perf_counter()
        # a later step, eager and graphed from one state: the forward's
        # loss, which no float atomic reaches, must be the same bits (the
        # replay drew the eager step's masks from the reseeded generator
        # and read the copied batch)
        saved = snapshot(state)
        state, m_e, _ = trainer.train_step(state, batches[1], rng=7)
        restore(state, saved)
        state, m_g, _ = trainer.train_step_multi(
            state, {k: v[None] for k, v in batches[1].items()}, rng=7)
        same = [float(m_e["train_batch_loss"]),
                float(m_g["train_batch_loss"][0])]
        print(f"{tag}: step {state.step} eager and graphed from one state, "
              f"loss {same[0]!r} and {same[1]!r}; step 1 {float(losses[0])!r}"
              f", eager {float(eager[0]['losses'][0])!r}", flush=True)
        if same[0] != same[1] or float(losses[0]) != float(
                eager[0]["losses"][0]):
            fail(f"{tag}: a graphed step's forward differs from the eager "
                 f"one's")

        t_check = time.perf_counter()
        # one replay under the profiler: its kernels, and its busy time
        # (the union of the kernels' intervals: the profiler's per-kernel
        # sums over a replay exceed its CUDA-event time) against the same
        # replay's CUDA-event time
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            a.record()
            state, _, _ = trainer.train_step_multi(
                state, {k: v[None] for k, v in batches[0].items()}, rng=7)
            b.record()
            torch.cuda.synchronize()
        prof_ms = a.elapsed_time(b)
        avgs = prof.key_averages()
        summed = sum(e.self_device_time_total for e in avgs) / 1e3
        busy = union_ms(prof.events())
        seen = {n: seen_launches(avgs, n) for n in per_step}
        idle = max(0.0, 1 - busy / prof_ms) if busy > 0 else None
        if busy > 0:
            print(f"{tag}: a replay's kernels by name (profiler): {seen} "
                  f"(expected {per_step}); busy {busy:.3f} ms (the union "
                  f"of its kernels' intervals; their sum {summed:.3f}) of "
                  f"{prof_ms:.3f} ms by events, idle share {idle:.3f} "
                  f"[{card}]", flush=True)
            # fused_site's kernel also runs the lse instance
            want_seen = dict(per_step)
            want_seen["fused_site"] = (per_step.get("fused_site", 0)
                                       + per_step.get("fused_site_lse", 0))
            # the profiler on the card's machine drops events over some
            # windows (chip_smoke phases 6-25 time kernels by queued_ms for
            # that reason), so fewer is printed and more fails; the counters
            # at capture above are the check of the step's launches
            names = [n for n in per_step if n != "fused_site_lse"]
            over = {n: seen[n] for n in names if seen[n] > want_seen[n]}
            same = all(seen[n] == want_seen[n] for n in names)
            print(f"{tag}: the replays' kernels by name "
                  f"{'match' if same else 'differ from'} phase "
                  f"{7 if fused_bwd else 6}'s launches a step {want_seen}",
                  flush=True)
            if over:
                fail(f"{tag}: a replay launched more than a step: {over}")
        else:
            print(f"{tag}: the profiler reported no kernel of the replays",
                  flush=True)
        t_end = time.perf_counter()
        print(f"{tag}: seconds: eager runs {t_eager - t_start:.1f}, graphed "
              f"run {t_graph - t_eager:.1f}, checks {t_check - t_graph:.1f}, "
              f"profiled replay {t_end - t_check:.1f}", flush=True)
        result = dict(
            fused_bwd=fused_bwd, k=GRAPH_K, steps=GRAPH_STEPS,
            graphed_ms_events=ms, graphed_ms_host=wall,
            eager_ms_events=eager[0]["ms"], eager_ms_host=eager[0]["wall_ms"],
            eager_ms_events_run2=eager[1]["ms"],
            eager_ms_host_run2=eager[1]["wall_ms"],
            captured_per_step={k: v // n_capture
                               for k, v in capture_counts.items()},
            capture_s=graph.capture_s, peak_gib=peak_gib, busy_ms=busy,
            busy_sum_ms=summed, profiled_ms=prof_ms, idle_share=idle, launches_per_step=per_step,
            replay_launches_seen=seen, loss_ratio=ratio_loss,
            param_ratio=ratio_par, eager_loss_spread=spread,
            losses=[float(x) for x in losses])
        print(f"{tag}: graphed {ms:.3f} ms/step by CUDA events, {wall:.3f} "
              f"ms/step by the host clock (dispatches 2-{GRAPH_DISPATCHES}); "
              f"eager {eager[0]['ms']:.3f} / {eager[1]['ms']:.3f} ms/step by "
              f"events, {eager[0]['wall_ms']:.3f} / {eager[1]['wall_ms']:.3f} "
              f"by the host clock (two runs); capture {graph.capture_s:.2f} s "
              f"({graph_step.WARMUP_STEPS} warm-up steps and the capture); "
              f"peak {peak_gib:.3f} GiB [{card}]", flush=True)
        result["trainer"], result["state"], result["batch"] = \
            trainer, state, batches[0]
        return result
    finally:
        shutil.rmtree(cfg.train.work_dir, ignore_errors=True)


def graph_epoch(card: str) -> dict:
    """``Trainer.train`` with GRAPH_K steps a dispatch through the loader
    and ``device_prefetch`` (its feeder thread pins and copies batches
    while the step is captured): one epoch of one fold, whose trailing
    group is partial."""
    import shutil

    import torch

    from bevrender_tpu_torch.data.synthetic import SyntheticDataset
    from bevrender_tpu_torch.training.trainer import Trainer

    cfg = graph_config(False, k=GRAPH_K)
    tc = cfg.train
    tc.k_fold, tc.epoch_per_fold, tc.total_epochs = 2, 1, 2
    tc.num_workers, tc.log_every_steps, tc.save_ckpt = 2, 1, False
    n = 2 * TRAIN_B * (GRAPH_K + 2)  # a fold trains on GRAPH_K + 2 batches
    try:
        ds = SyntheticDataset(n_items=n, num_views=3, window_num_imgs=1,
                              img_height=224, img_width=224)
        trainer = Trainer(cfg, ds, device="cuda")
        logged = []
        log_batch = trainer.metrics.log_batch
        trainer.metrics.log_batch = lambda idx, *a: (logged.append(
            (idx, a[1])), log_batch(idx, *a))
        t0 = time.perf_counter()
        state = trainer.train(trainer.create_state(seed=0),
                              apply_validation=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        capture_s = trainer.step_graph.capture_s
        print(f"phase 29 Trainer.train, {GRAPH_K} steps a dispatch: "
              f"{state.step} steps in {seconds:.2f} s (capture "
              f"{capture_s:.2f} s), logged (dispatch, loss) {logged} "
              f"[{card}]", flush=True)
        if state.step != GRAPH_K + 2 or [i for i, _ in logged] != [0, 1]:
            fail(f"phase 29: the epoch took {state.step} steps and logged "
                 f"{logged}")
        if not all(math.isfinite(x) for _, x in logged):
            fail(f"phase 29: a non-finite loss in the epoch: {logged}")
        del trainer, state
        release()
        return dict(steps=GRAPH_K + 2, seconds=seconds, capture_s=capture_s,
                    logged=logged)
    finally:
        shutil.rmtree(tc.work_dir, ignore_errors=True)


def remat_phase(card: str, batch: dict) -> dict:
    """Two flagship steps under each ``site_remat``: the first step's
    gradients of "dots" and "none" within the spread of two "nothing"
    runs; the second step's launches and peak memory."""
    import shutil

    import torch

    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.training.trainer import Trainer

    grads, peaks, counts = {}, {}, {}
    for run, mode in (("nothing", "nothing"), ("nothing2", "nothing"),
                      ("dots", "dots"), ("none", "none")):
        cfg = graph_config(False, site_remat=mode)
        try:
            trainer = Trainer(cfg, None, device="cuda")
            state = trainer.create_state(seed=0)
            state, _, _ = trainer.train_step(state, batch, rng=7)
            # the first step's gradients, from the one seeded state: they
            # differ between runs by the float atomics alone
            grads[run] = {n: p.grad.detach().clone()
                          for n, p in state.net.named_parameters()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_counts()
            state, _, _ = trainer.train_step(state, batch, rng=7)
            torch.cuda.synchronize()
            counts[run] = kernels.counts()
            peaks[run] = torch.cuda.max_memory_allocated() / 2 ** 30
            del trainer, state
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(cfg.train.work_dir, ignore_errors=True)
        want = expected(**REMAT_COUNTS[mode])
        if counts[run] != want:
            fail(f"phase 29 site_remat={mode}: launches {counts[run]} != "
                 f"{want}")
    ratios = {m: within_spread(grads[m], grads["nothing"], grads["nothing2"])
              for m in ("dots", "none")}
    print(f"phase 29 site_remat, flagship bf16 B={TRAIN_B} T=2, one step: "
          f"launches as expected ({ {m: REMAT_COUNTS[m] for m in REMAT_COUNTS} }"
          f"); peak nothing {peaks['nothing']:.3f} GiB, dots "
          f"{peaks['dots']:.3f}, none {peaks['none']:.3f}; gradients "
          f"against \"nothing\", worst share of the spread tolerance: "
          f"{ {m: (round(r, 4), n) for m, (r, n) in ratios.items()} } "
          f"[{card}]", flush=True)
    for m, (r, n) in ratios.items():
        if not r <= 1.0:
            fail(f"phase 29 site_remat={m}: gradient {n} off \"nothing\"'s "
                 f"by {r} of the tolerance")
    if not peaks["nothing"] < peaks["dots"] < peaks["none"]:
        fail(f"phase 29 site_remat peaks out of order: {peaks}")
    return dict(peak_gib=peaks, counts={m: counts[m] for m in
                                        ("nothing", "dots", "none")},
                grad_ratio={m: r for m, (r, _) in ratios.items()})


def utilities_phase(card: str, routed: dict) -> dict:
    """``device_bench`` of one graphed sub-step beside the events' time,
    ``trace`` with an ``annotation`` around eager work on the card,
    ``device_memory_stats`` against ``torch.cuda.max_memory_allocated``."""
    import shutil
    import tempfile

    import torch

    from bevrender_tpu_torch.training.trainer import _mix
    from bevrender_tpu_torch.utils.profiling import (
        annotation,
        device_memory_stats,
        trace,
    )
    from bevrender_tpu_torch.utils.timing import device_bench

    trainer, state, batch = (routed.pop(k) for k in ("trainer", "state",
                                                       "batch"))
    graph = trainer.step_graph
    bench = device_bench(graph, state, batch, _mix(7, 0), target_s=0.5,
                         reps=2)
    print(f"phase 29 device_bench of one graphed sub-step "
          f"(fused_bwd={routed['fused_bwd']}): {bench:.3f} ms; CUDA events "
          f"over a dispatch {routed['graphed_ms_events']:.3f} ms/step "
          f"[{card}]", flush=True)
    out = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        # eager work on the card: a profiler with CPU and CUDA activities
        # around a graph replay ended the process with a segmentation fault
        # once (chip_smoke, after device_bench), though the same trace had
        # passed in a shorter process
        x = torch.randn(1024, 1024, device="cuda")
        with trace(out):
            with annotation("chip_smoke_annotation"):
                torch.relu(x @ x).sum()
            torch.cuda.synchronize()
        files = sorted(Path(out).glob("*.json"))
        found = bool(files) and "chip_smoke_annotation" in \
            files[0].read_text()
        size = files[0].stat().st_size if files else 0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(f"phase 29 trace: {len(files)} file(s), {size} bytes, the "
          f"annotation {'found' if found else 'MISSING'}", flush=True)
    if not found:
        fail("phase 29: the trace lacks the annotation")
    stats = device_memory_stats("cuda")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 29 device_memory_stats: {stats}; "
          f"torch.cuda.max_memory_allocated {peak}", flush=True)
    if stats["peak_bytes_in_use"] != peak:
        fail(f"phase 29: device_memory_stats peak {stats} != {peak}")
    del graph, trainer, state
    release()
    return dict(device_bench_ms=bench, trace_bytes=size,
                memory_stats=stats)


def graph_phase(card: str, keep: dict | None = None) -> dict:
    """Phase 29: graphed against eager training on both routes, the three
    ``site_remat`` modes, the utilities on the card. ``keep``: see
    ``graph_route`` (the default route's)."""
    t0 = time.perf_counter()
    batches = graph_batches(GRAPH_STEPS)
    default = graph_route(card, False, batches, keep)
    default.pop("trainer"), default.pop("state"), default.pop("batch")
    release()
    t1 = time.perf_counter()
    fused = graph_route(card, True, batches)
    t2 = time.perf_counter()
    epoch = graph_epoch(card)
    remat = remat_phase(card, batches[0])
    t3 = time.perf_counter()
    utils = utilities_phase(card, fused)
    seconds = time.perf_counter() - t0
    print(f"phase 29: {seconds:.1f} s (default route {t1 - t0:.1f}, "
          f"fused_bwd {t2 - t1:.1f}, epoch and site_remat {t3 - t2:.1f}, "
          f"utilities {seconds - (t3 - t0):.1f})", flush=True)
    return dict(default=default, fused_bwd=fused, epoch=epoch, remat=remat,
                utilities=utils, seconds=seconds)


# ---- phase 30: data parallelism -----------------------------------------
# (a) a one-rank NCCL group replays phase 29's graphed default-route steps;
# (b) DP_WORLD spawned ranks share the card over gloo (NCCL refuses two
# ranks on one device), DP_B rows each, against one process on the global
# batch; (c) the sharded matcher on those ranks against phase 26's
# database. It runs on one card: nothing here measures more
# than one.
DP_WORLD = 2
DP_B = TRAIN_B            # rows a rank: the global batch is DP_WORLD x DP_B
DP_STEPS = 3
DP_TIMEOUT_S = 420        # the spawned ranks, imports and build cache included
MATCH_TOP_K = 10
MATCH_DIST_TOL = 1e-5     # 256-term float32 dot products, two GEMM shapes
# the flagship at random weights is chaotic (phase 5): a rank's forward
# rounds otherwise than one process's (its convolutions see B=2, not 4),
# and that moves the flagship's loss by ~1% from step 1 on, where the
# step-1 losses of two unperturbed one-process runs agree bit for bit
# (the float atomics of the backward part them later). So the second
# one-process run, whose spread to the first holds the ranks, starts from
# weights scaled by 1 + DP_PERTURB x a seeded normal draw: a change of
# rounding size, as the trainer's CPU tests size the tiny model's
# conditioning (tests/test_torch_trainer.py, LATER_* limits)
DP_PERTURB = 1e-6
# phase 5's small model is not chaotic: its one step on the ranks is held
# to one process's to this
SMALL_DP_REL = 1e-5


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_one_rank(card: str, keep: dict) -> dict:
    """Phase 30a: phase 29's graphed default-route dispatches, from its
    seeded state on its groups, in a process group of one NCCL rank: the
    step's all-reduce of gradients and losses is captured in the graph.
    Launches as phase 29's; losses and parameters phase 29's bits, or
    within its spread rule."""
    import shutil

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.parallel import dist as pdist
    from bevrender_tpu_torch.training.trainer import Trainer

    tag = "phase 30a one NCCL rank"
    pdist.initialize_distributed(
        "cuda:0", init_method=f"tcp://localhost:{free_port()}", rank=0,
        world_size=1)
    cfg = graph_config(False, k=GRAPH_K)
    try:
        if dist.get_backend() != "nccl" or pdist.world_size() != 1:
            fail(f"{tag}: group {dist.get_backend()} of {pdist.world_size()}")
        trainer = Trainer(cfg, None, device="cuda")
        state = trainer.create_state(state_dict=keep["state_dict"])
        groups = keep["groups"]
        kernels.reset_counts()
        state, m, _ = trainer.train_step_multi(state, groups[0], rng=7)
        torch.cuda.synchronize()
        counts = kernels.counts()
        losses, ev = [m["train_batch_loss"]], []
        for d in range(1, GRAPH_DISPATCHES):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            state, m, _ = trainer.train_step_multi(state, groups[d], rng=7)
            b.record()
            losses.append(m["train_batch_loss"])
            ev.append((a, b))
        torch.cuda.synchronize()
        ms = statistics.mean(a.elapsed_time(b) for a, b in ev) / GRAPH_K
        losses = torch.cat(losses).float().cpu()
        params = {n: p.detach().cpu() for n, p in
                  state.net.named_parameters()}
        if counts != keep["counts"]:
            fail(f"{tag}: launches while warmed up and captured {counts} != "
                 f"phase 29's {keep['counts']}")
        bits = torch.equal(losses, keep["losses"]) and all(
            torch.equal(p, keep["params"][n]) for n, p in params.items())
        e0, e1 = keep["eager"]
        r_loss, _ = spread_ratio({"loss": losses}, {"loss": keep["losses"]},
                                 {"loss": e0["losses"]},
                                 {"loss": e1["losses"]})
        r_par, at = spread_ratio(params, keep["params"], e0["params"],
                                 e1["params"])
        print(f"{tag}: launches while warmed up and captured equal phase "
              f"29's {counts}; losses {[round(float(x), 6) for x in losses]}"
              f", phase 29 {[round(float(x), 6) for x in keep['losses']]}; "
              f"{'the same bits' if bits else 'not the same bits'} as phase "
              f"29's replay", flush=True)
        if not bits:
            # the float atomics of grid_sampler_2d_backward and #9 order
            # their sums anew in every run, as two eager runs of phase 29
            # differ: the phase-29 rule holds the two replays
            print(f"{tag}: why not bitwise: float atomics in the backward "
                  f"sum in another order each run (phase 29's two eager "
                  f"runs differ too); against phase 29's replay, worst share "
                  f"of its spread tolerance: losses {r_loss:.3g}, parameters "
                  f"{r_par:.3g} ({at})", flush=True)
            if not (r_loss <= 1.0 and r_par <= 1.0):
                fail(f"{tag}: the replays part beyond phase 29's spread "
                     f"(losses {r_loss}, parameters {r_par} at {at})")
        one = {k: v[:1] for k, v in groups[0].items()}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.train_step_multi(state, one, rng=7)
            torch.cuda.synchronize()
        nccl = {e.key: e.count for e in prof.key_averages()
                if "nccl" in e.key.lower()}
        print(f"{tag}: NCCL kernels in one profiled replay: "
              f"{nccl or 'none reported'}; graphed {ms:.3f} ms/step by CUDA "
              f"events (phase 29: {keep['ms']:.3f}) [{card}]", flush=True)
        del trainer, state
        return dict(bitwise=bits, loss_ratio=r_loss, param_ratio=r_par,
                    graphed_ms_events=ms, phase29_ms_events=keep["ms"],
                    nccl_kernels=nccl, captured=counts)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(cfg.train.work_dir, ignore_errors=True)
        release()


def dp_config(work_dir: str):
    """Phase 6's flagship step (``graph_config``) at the global batch of
    DP_WORLD ranks."""
    cfg = graph_config(False, work_dir=work_dir)
    cfg.train.batch_size = DP_WORLD * DP_B
    return cfg


def small_dp(work_dir: str):
    """Phase 5's small model (2 stages, f32) trained as phase 6 trains the
    flagship (MSE, drop path 0.2) at the global batch, and that seeded
    batch on the host."""
    import torch

    from bevrender_tpu_torch.config import Config, tiny_model_config
    from bevrender_tpu_torch.data.synthetic import SyntheticDataset

    cfg = Config()
    cfg.model = tiny_model_config(embed_dims=(32, 32, 32), n_heads=(2, 8),
                                  n_groups=(1, 4), drop_path_rate=0.2)
    tc = cfg.train
    tc.batch_size, tc.loss_type, tc.work_dir = DP_WORLD * DP_B, "MSE", work_dir
    batch = SyntheticDataset(n_items=DP_WORLD * DP_B, num_views=2,
                             window_num_imgs=1, img_height=32, img_width=32,
                             map_tile=32, seed=3).batch(DP_WORLD * DP_B)
    return cfg, {k: torch.as_tensor(v) for k, v in batch.items()}


def perturb_(net, rel: float, seed: int = 0) -> None:
    """Scale every parameter of ``net`` by 1 + ``rel`` x a normal draw from
    ``seed``, in place."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(1 + rel * torch.randn(p.shape, generator=gen,
                                         device=p.device))


def dp_batches() -> list:
    """DP_STEPS seeded global batches (DP_WORLD x DP_B rows), on the host."""
    import torch

    from bevrender_tpu_torch.data.prefetch import collate
    from bevrender_tpu_torch.data.synthetic import SyntheticDataset

    n = DP_WORLD * DP_B
    ds = SyntheticDataset(n_items=DP_STEPS * n, num_views=3,
                          window_num_imgs=1, img_height=224, img_width=224,
                          seed=5)
    return [{k: torch.as_tensor(v) for k, v in collate(
        [ds[i * n + j] for j in range(n)]).items()} for i in range(DP_STEPS)]


def flat_params(net):
    import torch

    return torch.cat([t.detach().reshape(-1).float() for t in
                      list(net.parameters()) + list(net.buffers())])


def ranks_equal(flat) -> bool:
    """Whether every rank of the world holds ``flat``'s bits."""
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def dp_rank(rank: int, port: int, tmp: str) -> None:
    """Phase 30b-c, one spawned rank on the shared card: DP_STEPS steps on
    its rows of the global batches, the ranks' parameters compared after
    each, then its shard of the matcher. Writes ``rank<r>.pt`` to
    ``tmp``."""
    sys.path.insert(0, str(HERE))
    import traceback

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bevrender_tpu_torch.inference.register import RegistrationPipeline
    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.parallel import dist as pdist
    from bevrender_tpu_torch.training.trainer import Trainer

    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=DP_WORLD)
        trainer = Trainer(dp_config(tmp), None, device="cuda")
        state = trainer.create_state(
            state_dict=torch.load(f"{tmp}/state.pt", weights_only=True))
        rows = pdist.rank_rows(DP_WORLD * DP_B, DP_WORLD, rank)
        losses, equal, ms = [], [], []
        kernels.reset_counts()
        for batch in dp_batches():
            local = {k: v[rows].cuda() for k, v in batch.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m, _ = trainer.train_step(state, local, rng=7)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["train_batch_loss"]))
            equal.append(ranks_equal(flat_params(state.net)))
        counts = kernels.counts()
        small_cfg, small_batch = small_dp(tmp)
        small = Trainer(small_cfg, None, device="cuda")
        _, m, _ = small.train_step(small.create_state(seed=0), {
            k: v[rows].cuda() for k, v in small_batch.items()}, rng=7)
        small_loss = float(m["train_batch_loss"])
        match = torch.load(f"{tmp}/match.pt", weights_only=True)
        padded, n = RegistrationPipeline.pad_tile_db(match["db"].cuda(),
                                                     DP_WORLD)
        nl = padded.shape[0] // DP_WORLD
        matcher = RegistrationPipeline.make_sharded_matcher(MATCH_TOP_K)
        q, shard = match["q"].cuda(), padded[rank * nl:(rank + 1) * nl]
        first = matcher(q, shard, n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, dist_ = matcher(q, shard, n)
        torch.cuda.synchronize()
        match_ms = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(first[0], idx) and torch.equal(first[1], dist_)):
            raise RuntimeError("two calls of the matcher differ")
        out = dict(losses=losses, equal=equal, ms=ms, counts=counts,
                   idx=idx.cpu(), dist=dist_.cpu(), match_ms=match_ms,
                   shard_rows=nl, small_loss=small_loss)
        if rank == 0:
            out["params"] = {k: p.detach().cpu() for k, p in
                             state.net.named_parameters()}
        torch.save(out, f"{tmp}/rank{rank}.pt")
    except BaseException:
        Path(f"{tmp}/rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_dp_ranks(tmp: str, target=dp_rank, world: int = DP_WORLD,
                 tag: str = "phase 30b") -> list:
    """Spawn ``world`` ranks running ``target(rank, port, tmp)``, wait for
    them within DP_TIMEOUT_S, stop any left; their results
    (``<tmp>/rank<r>.pt``) in rank order. Any rank's error fails."""
    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")  # CUDA is initialised in this process
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, port, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    errors = {r: Path(f"{tmp}/rank{r}.err").read_text()
              for r in range(world) if Path(f"{tmp}/rank{r}.err").exists()}
    codes = [p.exitcode for p in procs]
    if errors or codes != [0] * world:
        fail(f"{tag}: ranks exited {codes}: {errors}")
    return [torch.load(f"{tmp}/rank{r}.pt", weights_only=True)
            for r in range(world)]


def dp_phase(card: str, match_in: dict) -> dict:
    """Phase 30b-c: one process on the global batch twice, the second
    from weights perturbed by DP_PERTURB (the spread), then DP_WORLD
    spawned gloo ranks from the unperturbed state; the sharded matcher on
    the ranks against the one-process ``register``."""
    import shutil
    import tempfile

    import torch

    from bevrender_tpu_torch.training.trainer import Trainer

    tag = "phase 30b gloo ranks"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        t0 = time.perf_counter()
        trainer = Trainer(dp_config(tmp), None, device="cuda")
        state = trainer.create_state(seed=0)
        torch.save({k: v.detach().cpu() for k, v in
                    state.net.state_dict().items()}, f"{tmp}/state.pt")
        torch.save({k: match_in[k].cpu() for k in ("q", "db")},
                   f"{tmp}/match.pt")
        batches = [{k: v.cuda() for k, v in b.items()} for b in dp_batches()]
        one = []
        for run in range(2):
            state = trainer.create_state(
                state_dict=torch.load(f"{tmp}/state.pt", weights_only=True))
            if run == 1:
                perturb_(state.net, DP_PERTURB)
            losses, ms = [], []
            for batch in batches:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, m, _ = trainer.train_step(state, batch, rng=7)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
                losses.append(float(m["train_batch_loss"]))
            one.append(dict(losses=torch.tensor(losses), ms=ms, params={
                n: p.detach().cpu() for n, p in
                state.net.named_parameters()}))
        small_cfg, small_batch = small_dp(tmp)
        small = Trainer(small_cfg, None, device="cuda")
        _, m, _ = small.train_step(small.create_state(seed=0), {
            k: v.cuda() for k, v in small_batch.items()}, rng=7)
        small_loss = float(m["train_batch_loss"])
        del trainer, state, batches, small
        release()
        t_one = time.perf_counter()
        ranks = run_dp_ranks(tmp)
        t_ranks = time.perf_counter()
        per_step = TRAIN_COUNTS[(False, "nothing")]
        want = expected(**{k: v * DP_STEPS for k, v in per_step.items()})
        for r, res in enumerate(ranks):
            if res["counts"] != want:
                fail(f"{tag}: rank {r} launches {res['counts']} != {want}")
        if not all(all(res["equal"]) for res in ranks) or \
                ranks[0]["losses"] != ranks[1]["losses"]:
            fail(f"{tag}: the ranks' parameters or losses differ: "
                 f"{[res['equal'] for res in ranks]}")
        got = torch.tensor(ranks[0]["losses"])
        r_loss, _ = within_spread({"loss": got}, {"loss": one[0]["losses"]},
                                  {"loss": one[1]["losses"]})
        r_par, at = within_spread(ranks[0]["params"], one[0]["params"],
                                  one[1]["params"])
        if not bool(torch.isfinite(got).all()):
            fail(f"{tag}: a non-finite loss {got}")
        rank_ms = statistics.mean(ranks[0]["ms"][1:])
        one_ms = statistics.mean(one[0]["ms"][1:])
        print(f"{tag}: {DP_WORLD} ranks x B={DP_B} (flagship bf16, T=2, drop "
              f"path 0.2), {DP_STEPS} steps: parameters equal bit for bit "
              f"after every step; launches a rank a step {per_step} (phase "
              f"6's); losses {[round(x, 6) for x in ranks[0]['losses']]}, "
              f"one process at B={DP_WORLD * DP_B} "
              f"{[round(float(x), 6) for x in one[0]['losses']]} / from "
              f"weights perturbed by {DP_PERTURB} "
              f"{[round(float(x), 6) for x in one[1]['losses']]}; worst share "
              f"of the spread tolerance: losses {r_loss:.3g}, parameters "
              f"{r_par:.3g} ({at})", flush=True)
        print(f"{tag}: {rank_ms:.3f} ms/step a rank (steps 2-{DP_STEPS}, "
              f"host clock), gloo over the host, two ranks time-sharing one "
              f"card; one process at B={DP_WORLD * DP_B} {one_ms:.3f} "
              f"ms/step [{card}]", flush=True)
        if not (r_loss <= 1.0 and r_par <= 1.0):
            fail(f"{tag}: the ranks part from one process beyond its spread "
                 f"(losses {r_loss}, parameters {r_par} at {at})")
        small_rel = abs(ranks[0]["small_loss"] - small_loss) / abs(small_loss)
        print(f"{tag}: phase 5's small model, one step (MSE, drop path 0.2) "
              f"on the ranks {ranks[0]['small_loss']!r}, one process "
              f"{small_loss!r}: relative {small_rel:.3g} (limit "
              f"{SMALL_DP_REL})", flush=True)
        if not (ranks[0]["small_loss"] == ranks[1]["small_loss"]
                and small_rel <= SMALL_DP_REL):
            fail(f"{tag}: the small model's step on the ranks "
                 f"{[r['small_loss'] for r in ranks]} against {small_loss}")

        # (c) the matcher: every rank returns the global top-k
        ref_i, ref_d = match_in["idx"].cpu(), match_in["dist"].cpu()
        worst = 0.0
        for r, res in enumerate(ranks):
            if not torch.equal(res["idx"], ref_i):
                fail(f"phase 30c: rank {r}'s sharded top-{MATCH_TOP_K} "
                     f"{res['idx'].tolist()} != register's {ref_i.tolist()}")
            worst = max(worst, float((res["dist"] - ref_d).abs().max()))
        print(f"phase 30c sharded matcher: {match_in['db'].shape[0]} tiles "
              f"of {match_in['db'].shape[1]}-D over {DP_WORLD} ranks "
              f"({ranks[0]['shard_rows']} rows each), top-{MATCH_TOP_K} of "
              f"{ref_i.shape[0]} queries equal to the one-process register's "
              f"on every rank, distances within {worst:.3g} (tolerance "
              f"{MATCH_DIST_TOL}); a second call {ranks[0]['match_ms']:.3f} "
              f"ms on rank 0 (host clock, gloo over the host) [{card}]",
              flush=True)
        if not worst <= MATCH_DIST_TOL:
            fail(f"phase 30c: distances {worst} off register's")
        return dict(world=DP_WORLD, rows_a_rank=DP_B, steps=DP_STEPS,
                    launches_a_rank=ranks[0]["counts"],
                    losses=ranks[0]["losses"],
                    one_process_losses=[one[0]["losses"].tolist(),
                                        one[1]["losses"].tolist()],
                    loss_ratio=r_loss, param_ratio=r_par,
                    small_model_loss_rel=small_rel,
                    rank_ms_per_step_gloo=rank_ms,
                    one_process_ms_per_step=one_ms,
                    one_process_s=t_one - t0, ranks_s=t_ranks - t_one,
                    match_max_dist_err=worst,
                    match_ms=ranks[0]["match_ms"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def parallel_phase(card: str, keep: dict, match_in: dict) -> dict:
    """Phase 30: (a) ``nccl_one_rank``, (b)-(c) ``dp_phase``."""
    t0 = time.perf_counter()
    one_rank = nccl_one_rank(card, keep)
    keep.clear()
    release()
    t1 = time.perf_counter()
    ranks = dp_phase(card, match_in)
    seconds = time.perf_counter() - t0
    print(f"phase 30: {seconds:.1f} s (one NCCL rank {t1 - t0:.1f}, gloo "
          f"ranks and matcher {seconds - (t1 - t0):.1f})", flush=True)
    return dict(nccl_one_rank=one_rank, gloo_ranks=ranks, seconds=seconds)


# Phase 31, the model axis. (a): MP_WORLD model ranks of one data rank on
# the one card over gloo, the flagship at the phase-30 batch of one rank
MP_WORLD = 2
MP_B = TRAIN_B
MP_REQUESTS = 3
MP_STEPS = 3
# every flagship site at Hpg = 1 takes the kernels it takes at Hpg = 2, a
# launch a site: tests/test_torch_model_parallel.py sums site_kernels over
# every site at Hpg / 2 on every route against these
MP_SERVE_COUNTS = dict(fused_site=FUSED_PER_FORWARD,
                       fused_site_mma=MMA_PER_FORWARD)
MP_TRAIN_COUNTS = TRAIN_COUNTS[(False, "nothing")]
# one request on each folded site at one head a group, a rank: its render
# equals its route's bit for bit (each folded kernel equals its per-head
# sibling, #4 equals #1): the rows fold the default route's, the heads fold
# (on "wide") a render on the "wide" route, whose wide heads take the bias
# where the default route takes fused_site_mma
MP_FOLD_ROUTES = {
    "fold_rows": (dict(site_fold_rows=True), FOLD_ROWS_PER_FORWARD, None),
    "fold_heads": (dict(lattice_route="wide", site_prefetch=True,
                        site_fold_heads=True), FOLD_HEADS_PER_FORWARD,
                   dict(lattice_route="wide"))}
# one fused_bwd step a route at one head a group: #8 and #9, and #12
MP_FUSED_ROUTES = {
    "fused_bwd": (dict(), TRAIN_COUNTS[(True, "nothing")]),
    "fused_bwd_fold": (dict(site_prefetch=True, site_fold_heads=True),
                       FOLD_TRAIN_COUNTS)}
# (b): 2 data x 2 model ranks, phase 5's small model. Its sites round K,
# Q, p and V to bf16, and the split reorders float32 sums (ConvMLP's
# partial outputs, the heads' batched products), so that some of those
# roundings fall otherwise than in one process: on the CPU the split moves
# its one-step loss by 5.8e-5 of itself, with float32 sites by 2.1e-7,
# and one process from weights perturbed by DP_PERTURB by 1.7e-4. So (b) is
# held to phase 30's spread rule with SMALL_DP_REL as its floor, where
# data ranks alone (phase 30b) hold SMALL_DP_REL itself
MP_SMALL_DATA = 2


def mp_config(work_dir: str, fused_bwd: bool = False, **route):
    """Phase 6's flagship step (``graph_config``) at B = MP_B, on a route."""
    cfg = graph_config(fused_bwd, work_dir=work_dir)
    for k, v in route.items():
        setattr(cfg.model, k, v)
    cfg.train.batch_size = MP_B
    return cfg


def mp_rank(rank: int, port: int, tmp: str) -> None:
    """Phase 31, one of MP_SMALL_DATA x MP_WORLD spawned ranks on the shared
    card: ranks below MP_WORLD first run (a) in a group of their own
    (``mp_flagship``) while the others start up, then every rank joins
    (b) (``mp_small``). Writes ``rank<r>.pt``."""
    sys.path.insert(0, str(HERE))
    import traceback

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        if rank < MP_WORLD:
            dist.init_process_group(
                "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                world_size=MP_WORLD)
            out = mp_flagship(rank, tmp)
            dist.destroy_process_group()
        port_b = int(Path(f"{tmp}/port_b").read_text())
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port_b}", rank=rank,
            world_size=MP_SMALL_DATA * MP_WORLD)
        out["small"] = mp_small(tmp)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    except BaseException:
        Path(f"{tmp}/rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def mp_flagship(rank: int, tmp: str) -> dict:
    """Phase 31a on one of MP_WORLD model ranks of one data rank: serving,
    the folded sites, MP_STEPS default-route steps and a ``fused_bwd`` step
    a route, with the split heads and channels."""
    import torch

    from bevrender_tpu_torch.inference.register import RegistrationPipeline
    from bevrender_tpu_torch.models.attention import set_site_options
    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.parallel import dist as pdist
    from bevrender_tpu_torch.training.trainer import Trainer

    pdist.init_model_parallel(MP_WORLD)
    inputs = torch.load(f"{tmp}/inputs.pt", weights_only=True)
    weights = torch.load(f"{tmp}/state.pt", weights_only=True)
    out = {}
    pipe = RegistrationPipeline(mp_config(tmp), weights, device="cuda")
    batch = {k: v.cuda() for k, v in inputs["serve"].items()}
    pipe.build_tile_database(list(inputs["tiles"].numpy()), batch_size=32)
    pipe.register(batch, top_k=10)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_counts()
    ms = []
    for _ in range(MP_REQUESTS):
        t0 = time.perf_counter()
        render, idx, dist_ = pipe.register(batch, top_k=10)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["serve"] = dict(counts=kernels.counts(), ms=ms,
                        render=render.float().cpu(), idx=idx.cpu(),
                        dist=dist_.cpu(),
                        equal=ranks_equal(render.float().reshape(-1)))
    out["fold"] = {}
    for name, (route, _, ref_route) in MP_FOLD_ROUTES.items():
        ref = out["serve"]["render"]
        if ref_route is not None:
            set_site_options(pipe.net,
                             **mp_config(tmp, **ref_route).model.site_options())
            ref = pipe.render(batch).float().cpu()
        set_site_options(pipe.net,
                         **mp_config(tmp, **route).model.site_options())
        kernels.reset_counts()
        fold_render = pipe.render(batch)
        torch.cuda.synchronize()
        out["fold"][name] = dict(
            counts=kernels.counts(),
            diff=float((fold_render.float().cpu() - ref).abs().max()))
    del pipe, render, fold_render
    torch.cuda.empty_cache()

    trainer = Trainer(mp_config(tmp), None, device="cuda")
    state = trainer.create_state(state_dict=weights)
    losses, equal, ms = [], [], []
    kernels.reset_counts()
    for b in inputs["train"]:
        b = {k: v.cuda() for k, v in b.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m, _ = trainer.train_step(state, b, rng=7)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["train_batch_loss"]))
        equal.append(ranks_equal(flat_params(state.net)))
    out["train"] = dict(counts=kernels.counts(), losses=losses,
                        equal=equal, ms=ms)
    if rank == 0:
        out["train"]["params"] = {n: p.detach().cpu() for n, p in
                                  state.net.named_parameters()}
    del trainer, state
    out["fused"] = {}
    for name, (route, _) in MP_FUSED_ROUTES.items():
        trainer = Trainer(mp_config(tmp, True, **route), None,
                          device="cuda")
        state = trainer.create_state(state_dict=weights)
        b = {k: v.cuda() for k, v in inputs["train"][0].items()}
        kernels.reset_counts()
        state, m, _ = trainer.train_step(state, b, rng=7)
        torch.cuda.synchronize()
        out["fused"][name] = dict(
            counts=kernels.counts(), loss=float(m["train_batch_loss"]),
            equal=ranks_equal(flat_params(state.net)))
        del trainer, state
    torch.cuda.empty_cache()
    return out


def mp_small(tmp: str) -> dict:
    """Phase 31b on one of MP_SMALL_DATA x MP_WORLD ranks: phase 5's small
    model, one step on its data rank's rows (``small_dp``)."""
    from bevrender_tpu_torch.parallel import dist as pdist
    from bevrender_tpu_torch.training.trainer import Trainer

    pdist.init_model_parallel(MP_WORLD)
    cfg, batch = small_dp(tmp)
    rows = pdist.rank_rows(batch["camera"].shape[0], MP_SMALL_DATA,
                           pdist.data_rank())
    small = Trainer(cfg, None, device="cuda")
    state, m, _ = small.train_step(small.create_state(seed=0), {
        k: v[rows].cuda() for k, v in batch.items()}, rng=7)
    return dict(loss=float(m["train_batch_loss"]),
                equal=ranks_equal(flat_params(state.net)),
                layout=(pdist.data_rank(), pdist.model_rank()))


def mp_one_process(tmp: str) -> dict:
    """Phase 31a's references in this process: the serving render and the
    MP_STEPS steps from the seeded state, and again from weights perturbed
    by DP_PERTURB (the spread); ms/request and ms/step on the host clock."""
    import torch

    from bevrender_tpu_torch.inference.register import RegistrationPipeline
    from bevrender_tpu_torch.training.trainer import Trainer

    inputs = torch.load(f"{tmp}/inputs.pt", weights_only=True)
    weights = torch.load(f"{tmp}/state.pt", weights_only=True)
    batch = {k: v.cuda() for k, v in inputs["serve"].items()}
    serve = []
    for run in range(2):
        pipe = RegistrationPipeline(mp_config(tmp), weights, device="cuda")
        if run == 1:
            perturb_(pipe.net, DP_PERTURB)
        pipe.build_tile_database(list(inputs["tiles"].numpy()), batch_size=32)
        pipe.register(batch, top_k=10)
        ms = []
        for _ in range(MP_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render, _, _ = pipe.register(batch, top_k=10)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        serve.append(dict(render=render.float().cpu(), ms=ms))
        del pipe, render
    trainer = Trainer(mp_config(tmp), None, device="cuda")
    train = []
    for run in range(2):
        state = trainer.create_state(state_dict=weights)
        if run == 1:
            perturb_(state.net, DP_PERTURB)
        losses, ms = [], []
        for b in inputs["train"]:
            b = {k: v.cuda() for k, v in b.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m, _ = trainer.train_step(state, b, rng=7)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["train_batch_loss"]))
        train.append(dict(losses=torch.tensor(losses), ms=ms, params={
            n: p.detach().cpu() for n, p in state.net.named_parameters()}))
    small_cfg, small_batch = small_dp(tmp)
    small = Trainer(small_cfg, None, device="cuda")
    small_loss = []
    for run in range(2):
        small_state = small.create_state(seed=0)
        if run == 1:
            perturb_(small_state.net, DP_PERTURB)
        _, m, _ = small.train_step(small_state, {
            k: v.cuda() for k, v in small_batch.items()}, rng=7)
        small_loss.append(float(m["train_batch_loss"]))
    del trainer, state, small, small_state
    release()
    return dict(serve=serve, train=train, small_loss=small_loss)


def model_parallel_phase(card: str) -> dict:
    """Phase 31: (a) MP_WORLD model ranks of the flagship against one
    process; (b) MP_SMALL_DATA x MP_WORLD ranks of phase 5's small
    model."""
    import shutil
    import tempfile

    import torch

    from bevrender_tpu_torch.data.prefetch import collate
    from bevrender_tpu_torch.data.synthetic import SyntheticDataset
    from bevrender_tpu_torch.models.bevrender import BEVRenderNet
    from bevrender_tpu_torch.models.layers import init_params

    tag = "phase 31a model ranks"
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        cfg = mp_config(tmp)
        torch.save({k: v.detach().clone() for k, v in init_params(
            BEVRenderNet(cfg.model), 0).state_dict().items()},
            f"{tmp}/state.pt")
        ds = SyntheticDataset(n_items=(MP_STEPS + 1) * MP_B, num_views=3,
                              window_num_imgs=1, img_height=224,
                              img_width=224, seed=6)
        items = [ds[i] for i in range(len(ds))]
        rng = torch.Generator().manual_seed(1)
        torch.save(dict(
            serve={k: torch.as_tensor(v) for k, v in
                   collate(items[:MP_B]).items()},
            train=[{k: torch.as_tensor(v) for k, v in collate(
                items[(i + 1) * MP_B:(i + 2) * MP_B]).items()}
                for i in range(MP_STEPS)],
            tiles=torch.rand(64, 224, 224, 3, generator=rng)),
            f"{tmp}/inputs.pt")
        one = mp_one_process(tmp)
        t_one = time.perf_counter()
        Path(f"{tmp}/port_b").write_text(str(free_port()))
        everyone = run_dp_ranks(tmp, mp_rank, MP_SMALL_DATA * MP_WORLD,
                                "phase 31")
        t_ranks = time.perf_counter()
        ranks, small = everyone[:MP_WORLD], [r["small"] for r in everyone]

        # serving: the ranks agree, each launches a rank's kernels
        want = expected(**{k: v * MP_REQUESTS
                           for k, v in MP_SERVE_COUNTS.items()})
        for r, res in enumerate(ranks):
            sv = res["serve"]
            if sv["counts"] != want:
                fail(f"{tag}: rank {r} serving launches {sv['counts']} != "
                     f"{want}")
            if not (sv["equal"] and torch.equal(sv["render"],
                                                ranks[0]["serve"]["render"])
                    and torch.equal(sv["idx"], ranks[0]["serve"]["idx"])
                    and torch.equal(sv["dist"], ranks[0]["serve"]["dist"])):
                fail(f"{tag}: rank {r}'s render or top-k differ from rank 0's")
        sv = ranks[0]["serve"]
        if tuple(sv["render"].shape) != (MP_B, 224, 224, 3) or not bool(
                torch.isfinite(sv["render"]).all()):
            fail(f"{tag}: render shape {tuple(sv['render'].shape)} or "
                 f"non-finite values")
        if not bool(((sv["idx"] >= 0) & (sv["idx"] < 64)).all()) or not bool(
                (sv["dist"][:, 1:] >= sv["dist"][:, :-1]).all()):
            fail(f"{tag}: top-k indices out of range or not ascending")
        r_render, _ = spread_ratio(
            {"render": sv["render"]}, {"render": one["serve"][0]["render"]},
            {"render": one["serve"][0]["render"]},
            {"render": one["serve"][1]["render"]})
        rank_req = statistics.median(sv["ms"])
        one_req = statistics.median(one["serve"][0]["ms"])
        print(f"{tag}: {MP_WORLD} model ranks, one head a group each "
              f"(flagship bf16, B={MP_B}, T=2, V=3, 224x224): launches a "
              f"rank a request {MP_SERVE_COUNTS}; renders and top-10 equal "
              f"bit for bit on the ranks; render against one process, worst "
              f"share of the spread tolerance (one process from weights "
              f"perturbed by {DP_PERTURB}) {r_render:.3g}; {rank_req:.3f} "
              f"ms/request a rank (median of {MP_REQUESTS}, host clock, gloo "
              f"over the host, two ranks time-sharing one card), one "
              f"process {one_req:.3f} [{card}]", flush=True)
        if not r_render <= 1.0:
            fail(f"{tag}: the ranks' render parts from one process beyond "
                 f"its spread ({r_render})")
        for name, (_, per, _) in MP_FOLD_ROUTES.items():
            for r, res in enumerate(ranks):
                got = res["fold"][name]
                if got["counts"] != expected(**per):
                    fail(f"{tag}: rank {r} {name} launches {got['counts']}"
                         f" != {expected(**per)}")
                if got["diff"] != 0.0:
                    fail(f"{tag}: rank {r} {name} render differs from its "
                         f"route's by {got['diff']}")
        print(f"{tag}: a request on each folded site at one head a group "
              f"({ {n: per for n, (_, per, _) in MP_FOLD_ROUTES.items()} }): "
              f"render equal to its route's on every rank",
              flush=True)

        # training: the ranks agree after every step, within the spread
        want = expected(**{k: v * MP_STEPS
                           for k, v in MP_TRAIN_COUNTS.items()})
        for r, res in enumerate(ranks):
            if res["train"]["counts"] != want:
                fail(f"{tag}: rank {r} training launches "
                     f"{res['train']['counts']} != {want}")
        tr = ranks[0]["train"]
        if not all(all(res["train"]["equal"]) for res in ranks) or any(
                res["train"]["losses"] != tr["losses"] for res in ranks):
            fail(f"{tag}: the ranks' parameters or losses differ: "
                 f"{[res['train']['equal'] for res in ranks]}")
        got = torch.tensor(tr["losses"])
        if not bool(torch.isfinite(got).all()):
            fail(f"{tag}: a non-finite loss {got}")
        r_loss, _ = within_spread(
            {"loss": got}, {"loss": one["train"][0]["losses"]},
            {"loss": one["train"][1]["losses"]})
        r_par, at = within_spread(tr["params"], one["train"][0]["params"],
                                  one["train"][1]["params"])
        rank_ms = statistics.mean(tr["ms"][1:])
        one_ms = statistics.mean(one["train"][0]["ms"][1:])
        print(f"{tag}: {MP_STEPS} steps (MSE, drop path 0.2): parameters "
              f"equal bit for bit on the ranks after every step; launches a "
              f"rank a step {MP_TRAIN_COUNTS}; losses "
              f"{[round(x, 6) for x in tr['losses']]}, one process "
              f"{[round(float(x), 6) for x in one['train'][0]['losses']]} / "
              f"perturbed {[round(float(x), 6) for x in one['train'][1]['losses']]}"
              f"; worst share of the spread tolerance: losses {r_loss:.3g}, "
              f"parameters {r_par:.3g} ({at}); {rank_ms:.3f} ms/step a rank "
              f"(steps 2-{MP_STEPS}, host clock), one process {one_ms:.3f} "
              f"[{card}]", flush=True)
        if not (r_loss <= 1.0 and r_par <= 1.0):
            fail(f"{tag}: the ranks' steps part from one process beyond its "
                 f"spread (losses {r_loss}, parameters {r_par} at {at})")
        for name, (_, per) in MP_FUSED_ROUTES.items():
            res = [rk["fused"][name] for rk in ranks]
            for r, got in enumerate(res):
                if got["counts"] != expected(**per):
                    fail(f"{tag}: rank {r} {name} step launches "
                         f"{got['counts']} != {expected(**per)}")
            if not (all(g["equal"] for g in res)
                    and len({g["loss"] for g in res}) == 1
                    and math.isfinite(res[0]["loss"])):
                fail(f"{tag}: {name} step: ranks differ or loss "
                     f"{[g['loss'] for g in res]}")
        print(f"{tag}: a fused_bwd step a route at one head a group, "
              f"launches a rank "
              f"{ {n: per for n, (_, per) in MP_FUSED_ROUTES.items()} }, "
              f"losses "
              f"{ {n: round(ranks[0]['fused'][n]['loss'], 6) for n in MP_FUSED_ROUTES} }"
              f", parameters equal on the ranks", flush=True)

        # (b) data and model ranks together on the small model
        layouts = [res["layout"] for res in small]
        if layouts != [(d, m) for d in range(MP_SMALL_DATA)
                       for m in range(MP_WORLD)]:
            fail(f"phase 31b: rank layout {layouts}")
        one_small, pert_small = one["small_loss"]
        small_rel = abs(small[0]["loss"] - one_small) / abs(one_small)
        pert_rel = abs(pert_small - one_small) / abs(one_small)
        r_small, _ = spread_ratio(
            {"loss": torch.tensor([small[0]["loss"]])},
            {"loss": torch.tensor([one_small])},
            {"loss": torch.tensor([one_small])},
            {"loss": torch.tensor([pert_small])})
        print(f"phase 31b data x model ranks: {MP_SMALL_DATA} x {MP_WORLD} "
              f"(rank d * {MP_WORLD} + m), phase 5's small model one step "
              f"(MSE, drop path 0.2): loss {small[0]['loss']!r}, one process "
              f"{one_small!r}, relative {small_rel:.3g}; one process from "
              f"weights perturbed by {DP_PERTURB} {pert_rel:.3g}; worst share "
              f"of the spread tolerance (floor {SMALL_DP_REL}) "
              f"{r_small:.3g}; parameters equal on all ranks", flush=True)
        if not (all(res["equal"] for res in small)
                and len({res["loss"] for res in small}) == 1
                and r_small <= 1.0):
            fail(f"phase 31b: the ranks' step {[r['loss'] for r in small]} "
                 f"against {one_small} (perturbed {pert_small})")
        seconds = time.perf_counter() - t0
        print(f"phase 31: {seconds:.1f} s (one process {t_one - t0:.1f}, "
              f"the ranks of (a) and (b) {t_ranks - t_one:.1f}, the rest "
              f"{seconds - (t_ranks - t0):.1f})", flush=True)
        return dict(
            world=MP_WORLD, rows=MP_B, requests=MP_REQUESTS, steps=MP_STEPS,
            launches_rank_request=MP_SERVE_COUNTS,
            launches_rank_step=MP_TRAIN_COUNTS,
            launches_rank_fold={n: ranks[0]["fold"][n]["counts"]
                                for n in MP_FOLD_ROUTES},
            launches_rank_fused_step={n: ranks[0]["fused"][n]["counts"]
                                      for n in MP_FUSED_ROUTES},
            render_ratio=r_render, loss_ratio=r_loss, param_ratio=r_par,
            losses=tr["losses"],
            one_process_losses=[one["train"][0]["losses"].tolist(),
                                one["train"][1]["losses"].tolist()],
            rank_ms_per_request=rank_req, one_process_ms_per_request=one_req,
            rank_ms_per_step=rank_ms, one_process_ms_per_step=one_ms,
            small_model_loss_rel=small_rel,
            small_model_perturbed_rel=pert_rel,
            small_model_spread_ratio=r_small, seconds=seconds)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        release()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(HERE))
    import bevrender_tpu_torch

    if Path(bevrender_tpu_torch.__file__).resolve().parent.parent != HERE:
        fail("bevrender_tpu_torch is not beside chip_smoke.py")
    from bevrender_tpu_torch.config import Config, flagship_config, tiny_model_config
    from bevrender_tpu_torch.data.synthetic import SyntheticDataset
    from bevrender_tpu_torch.inference.register import RegistrationPipeline
    from bevrender_tpu_torch.ops import deform_attn as da
    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()

    def stamp(phases: str) -> None:
        print(f"[{time.perf_counter() - t0:.1f} s] {phases}", flush=True)

    logs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {regs[0] if regs else 'cached'}", flush=True)

    stamp("phases 3-4")
    # ---- main path: flagship bf16 render+register, B=4, T=2 ----
    serve = serving_phase(card, "flagship", flagship_config(dtype="bfloat16"),
                          SERVE_B, N_REQUESTS,
                          dict(fused_site=FUSED_PER_FORWARD,
                               fused_site_mma=MMA_PER_FORWARD))
    counts = serve["counts"]

    with torch.no_grad():
        bias = check_bias(da, kernels.lattice_bias)
        site = check_site(da, kernels.fused_site)
        mma = check_mma_site(da, kernels)
    print(f"lattice_bias over a flagship serving forward: "
          f"{sum_text(bias['rows'], 'per_forward')} [{card}]", flush=True)

    stamp("phase 5")
    # ---- reference: a small model through the kernels and through plain
    # PyTorch on the card. The flagship at random weights is chaotic over
    # two frames (its render moves O(1e-1) under a 1e-6 input change), a
    # 2-stage model is not. Stage 0 has head width 16 (fused_site_mma,
    # views one by one), stage 1 head width 4 with G=4 (fused site, views
    # folded).
    small = Config()
    small.model = tiny_model_config(embed_dims=(32, 32, 32), n_heads=(2, 8),
                                    n_groups=(1, 4))
    ref_pipe = RegistrationPipeline(small, device="cuda", seed=2)
    sb = {k: torch.as_tensor(v) for k, v in SyntheticDataset(
        n_items=2, num_views=2, window_num_imgs=1, img_height=32,
        img_width=32, seed=3).batch(2).items()}
    kernels.reset_counts()
    with mma_sites_checked(da) as mma_calls:
        out_k = ref_pipe.render(sb)
    used = kernels.counts()
    with plain_sites(da, online=True, keep_mma=True):
        out_o = ref_pipe.render(sb)
    with plain_sites(da):
        out_p = ref_pipe.render(sb)
    # the kernels against plain PyTorch that rounds as they do, the head
    # width 16 stage's fused_site_mma in both and held to its mirror call by
    # call; the distance to the plain versions (p rounded after
    # normalising) is printed beside it: it shows how far that one rounding
    # moves this render
    d_kernel = float((out_k - out_o).abs().max())
    d_round = float((out_k - out_p).abs().max())
    print(f"small model (2 stages, f32, B=2, T=2) render, kernels {used}: max "
          f"abs diff to plain PyTorch with the kernels' roundings {d_kernel:.3g} "
          f"(tolerance {RENDER_TOL}); to the plain versions (p rounded after "
          f"normalising) {d_round:.3g}; fused_site_mma against its mirror at "
          f"its {len(mma_calls)} calls: at most "
          f"{max(c['online_over_wabs'] for c in mma_calls):.3g} of the "
          f"p-weighted |v|, flip share "
          f"{max(c['flip_share'] for c in mma_calls):.3g}", flush=True)
    if not (used["fused_site_mma"] > 0 and used["fused_site"] > 0):
        fail(f"small reference model missed a kernel: {used}")
    if not all(c["ok"] for c in mma_calls):
        fail(f"fused_site_mma beyond its mirror's tolerance in the small "
             f"model: {mma_calls}")
    if not (d_kernel <= RENDER_TOL and bool(torch.isfinite(out_k).all())):
        fail(f"render through kernels differs from plain path by {d_kernel}")

    stamp("phases 6-9")
    # ---- training: default route (with the peak memory of site_remat
    # "none" beside it), then fused_bwd, in one process on one card ----
    def flagship_train(fused_bwd, site_remat, steps, profile_step):
        return train_phase(card, "flagship", flagship_config(dtype="bfloat16"),
                           fused_bwd, site_remat, steps, profile_step,
                           TRAIN_COUNTS[(fused_bwd, site_remat)])

    train_default = flagship_train(False, "nothing", TRAIN_STEPS, True)
    train_none = flagship_train(False, "none", 3, False)
    train_fused = flagship_train(True, "nothing", TRAIN_STEPS, True)
    print(f"training step, flagship bf16 B={TRAIN_B} T=2: default route "
          f"{train_default['step_ms']:.3f} ms/step (peak "
          f"{train_default['peak_gib']:.3f} GiB; site_remat none "
          f"{train_none['step_ms']:.3f} ms/step, peak "
          f"{train_none['peak_gib']:.3f} GiB); fused_bwd "
          f"{train_fused['step_ms']:.3f} ms/step (peak "
          f"{train_fused['peak_gib']:.3f} GiB) [{card}]", flush=True)

    bias_bwd = check_bias_bwd(da, kernels.lattice_bias_bwd)
    bias["worst"] = max(bias["worst"], bias_bwd["worst_fwd"])
    bias_bwd["per_step_ms"] = sum(r["ms"] * r["per_step"]
                                  for r in bias_bwd["rows"])
    print(f"lattice_bias over a default-route flagship step: "
          f"{sum_text(bias_bwd['fwd_rows'], 'per_step')} [{card}]",
          flush=True)
    print(f"lattice_bias_bwd over a default-route flagship step: "
          f"{bias_bwd['per_step_ms']:.4f} ms (each shape's time x its "
          f"launches, {sum(r['per_step'] for r in bias_bwd['rows'])} "
          f"launches) [{card}]", flush=True)
    site_lse, site_bwd = check_site_train(da, kernels)
    grads_default = small_model_grads(da, kernels, fused_bwd=False)
    grads_fused = small_model_grads(da, kernels, fused_bwd=True)
    small_model_epoch(kernels)

    stamp("phases 10-13")
    # ---- the pyramid, Config() (the reference default) in bf16: serving,
    # training, its bias kernels at every shape, and a small model whose
    # wide site runs through the normal dispatch ----
    def pyramid_config():
        cfg = Config()
        cfg.model.dtype = "bfloat16"
        return cfg

    pyr_serve = serving_phase(card, "pyramid", pyramid_config(), PYR_B,
                              PYR_REQUESTS, PYR_PER_FORWARD)
    pyr_train = train_phase(card, "pyramid", pyramid_config(), False,
                            "nothing", TRAIN_STEPS, True,
                            PYR_TRAIN_COUNTS["nothing"])
    pyr_none = train_phase(card, "pyramid", pyramid_config(), False, "none",
                           3, False, PYR_TRAIN_COUNTS["none"])
    print(f"training step, pyramid bf16 B={TRAIN_B} T=2: "
          f"{pyr_train['step_ms']:.3f} ms/step (peak "
          f"{pyr_train['peak_gib']:.3f} GiB); site_remat none "
          f"{pyr_none['step_ms']:.3f} ms/step (peak "
          f"{pyr_none['peak_gib']:.3f} GiB) [{card}]", flush=True)
    pyr_bias = check_pyramid_bias(da, kernels)
    pyr_fwd = [r for r in pyr_bias["lattice_bias"]["rows"] if r["per_forward"]]
    print(f"lattice_bias over a pyramid serving forward: "
          f"{sum_text(pyr_fwd, 'per_forward')}; over a pyramid step: "
          f"{sum_text(pyr_fwd, 'per_step')} [{card}]", flush=True)
    for k in ("lattice_bias_bwd", "lattice_bias_wide_bwd"):
        pyr_bias[k]["per_step_ms"] = sum(r["ms"] * r["per_step"]
                                         for r in pyr_bias[k]["rows"])
        print(f"{k} over a pyramid step: {pyr_bias[k]['per_step_ms']:.4f} "
              f"ms (each shape's time x its launches) [{card}]", flush=True)
    grads_wide = small_model_grads(da, kernels, fused_bwd=False, wide=True)

    stamp("phases 14-18")
    # ---- the wide-table route (ModelConfig.lattice_route="wide"): the
    # flagship's sites on the kernels that read the table through L1, then
    # on their window-prefetch variants, its training step on the wide
    # kernels, the pyramid with the prefetch bias, and each new kernel
    # alone. Every site kernel of these routes equals its sibling bit for
    # bit and the convolutions pick the same cuDNN algorithms for the same
    # shapes, so the prefetch render equals the "wide" route's exactly, and
    # the pyramid's prefetch render (fused_site_mma at every eval site on
    # both) phase 10's. The "auto" route takes fused_site_mma at the wide
    # heads where "wide" takes the bias and the plain consumer, which sum
    # in another order: the distance is printed ----
    auto_render, pyr_render = serve.pop("render"), pyr_serve.pop("render")

    def flagship_route(**route):
        return flagship_config(dtype="bfloat16", **route)

    wide_serve = serving_phase(card, "flagship wide",
                               flagship_route(lattice_route="wide"), SERVE_B,
                               WIDE_REQUESTS, WIDE_PER_FORWARD)
    prefetch_serve = serving_phase(
        card, "flagship wide prefetch",
        flagship_route(lattice_route="wide", site_prefetch=True,
                       bias_forward="prefetch"),
        SERVE_B, WIDE_REQUESTS, WIDE_PREFETCH_PER_FORWARD)
    wide_train = train_phase(card, "flagship wide",
                             flagship_route(lattice_route="wide"), True,
                             "nothing", TRAIN_STEPS, True, WIDE_TRAIN_COUNTS)
    pyr_prefetch_cfg = pyramid_config()
    pyr_prefetch_cfg.model.bias_forward = "prefetch"
    pyr_prefetch = serving_phase(card, "pyramid prefetch", pyr_prefetch_cfg,
                                 PYR_B, PYR_REQUESTS, PYR_PREFETCH_PER_FORWARD)
    wide_render = wide_serve.pop("render")
    render_diff = {
        "flagship_wide_prefetch": float((prefetch_serve.pop("render")
                                         - wide_render).abs().max()),
        "pyramid_prefetch": float((pyr_prefetch.pop("render")
                                   - pyr_render).abs().max())}
    wide_to_auto = float((wide_render - auto_render).abs().max())
    print(f"renders against the \"wide\" route's (flagship) and phase 10's "
          f"(pyramid), same weights and batch (max abs difference): "
          f"{render_diff}; the \"wide\" render against the \"auto\" "
          f"route's {wide_to_auto:.3g}", flush=True)
    if any(d != 0.0 for d in render_diff.values()):
        fail(f"a prefetch render differs from its route's: {render_diff}")
    with torch.no_grad():
        site_wide, site_prefetch = check_wide_site(da, kernels)
        site_wide_lse = check_wide_site_lse(da, kernels)
        bias_prefetch, bias_wide_flagship = check_prefetch_bias(da, kernels)
    bias_wide_bwd_flagship = check_bias_bwd(da, kernels.lattice_bias_bwd,
                                            wide=True)

    stamp("phases 19-22")
    # ---- the folded fused sites (ModelConfig.site_fold_heads and
    # site_fold_rows; TrainConfig.fused_fwd_fold follows site_fold_heads):
    # the flagship serving on each, its fused_bwd step with the folded
    # forward, and each folded kernel alone. Each equals its per-head
    # sibling bit for bit, so the rows-folded render equals the "auto"
    # route's and the heads-folded one (on "wide") the "wide" route's ----
    fold_heads_serve = serving_phase(
        card, "flagship fold heads",
        flagship_route(lattice_route="wide", site_prefetch=True,
                       site_fold_heads=True),
        SERVE_B, WIDE_REQUESTS, FOLD_HEADS_PER_FORWARD)
    fold_rows_serve = serving_phase(
        card, "flagship fold rows", flagship_route(site_fold_rows=True),
        SERVE_B, WIDE_REQUESTS, FOLD_ROWS_PER_FORWARD)
    fold_train = train_phase(
        card, "flagship fold", flagship_route(site_prefetch=True,
                                              site_fold_heads=True),
        True, "nothing", TRAIN_STEPS, True, FOLD_TRAIN_COUNTS)
    print(f"fused_bwd training, loss of step 1: folded forward "
          f"{fold_train['loss_first']:.6f}, per-head forward (phase 7) "
          f"{train_fused['loss_first']:.6f}", flush=True)
    fold_diff = {
        "flagship_fold_heads": float((fold_heads_serve.pop("render")
                                      - wide_render).abs().max()),
        "flagship_fold_rows": float((fold_rows_serve.pop("render")
                                     - auto_render).abs().max())}
    print(f"folded renders against their route's (rows \"auto\", heads "
          f"\"wide\"), same weights and batch (max abs difference): "
          f"{fold_diff}", flush=True)
    if any(d != 0.0 for d in fold_diff.values()):
        fail(f"a folded render differs from its route's: {fold_diff}")
    with torch.no_grad():
        site_rows, site_heads, site_heads_lse = check_fold_sites(da, kernels)

    stamp("phases 23-25")
    # ---- the windowed bias (ModelConfig.bias_forward="windows"): the
    # flagship serving and training with every bias site on the window
    # kernels, each window kernel alone, and the pyramid serving ----
    windows_serve = serving_phase(
        card, "flagship windows", flagship_route(bias_forward="windows"),
        SERVE_B, WINDOWS_REQUESTS, WINDOWS_PER_FORWARD,
        compare=windows_render_check(da, "flagship windows"))
    windows_train = train_phase(
        card, "flagship windows", flagship_route(bias_forward="windows"),
        False, "nothing", TRAIN_STEPS, True, WINDOWS_TRAIN_COUNTS)
    win_fwd, win_bwd, win_bias = check_windows(da, kernels)
    pyr_windows_cfg = pyramid_config()
    pyr_windows_cfg.model.bias_forward = "windows"
    pyr_windows = serving_phase(
        card, "pyramid windows", pyr_windows_cfg, PYR_B, PYR_WINDOWS_REQUESTS,
        PYR_WINDOWS_PER_FORWARD,
        compare=windows_render_check(da, "pyramid windows"))
    for r in (windows_serve, pyr_windows):
        r.pop("render")
    print(f"windowed bias against the bias kernels: flagship serving "
          f"{windows_serve['request_ms']:.3f} ms/request, busy "
          f"{windows_serve['busy_ms']:.3f} ms (phase 3: "
          f"{serve['request_ms']:.3f}, busy {serve['busy_ms']:.3f}); training "
          f"{windows_train['step_ms']:.3f} ms/step, busy "
          f"{windows_train['busy_ms']:.3f} ms, peak "
          f"{windows_train['peak_gib']:.3f} GiB (phase 6: "
          f"{train_default['step_ms']:.3f}, busy {train_default['busy_ms']:.3f}"
          f", peak {train_default['peak_gib']:.3f}); pyramid serving "
          f"{pyr_windows['request_ms']:.3f} ms/request, busy "
          f"{pyr_windows['busy_ms']:.3f} ms (phase 10: "
          f"{pyr_serve['request_ms']:.3f}, busy {pyr_serve['busy_ms']:.3f}) "
          f"[{card}]", flush=True)

    stamp("phases 26-27")
    # ---- the retrieval head (ModelConfig.retrieval_embed_dim) on the
    # flagship, then streaming and replay on the same pipeline ----
    head, head_pipe, head_db = head_phase(card, auto_render)
    stream = streaming_phase(card, head_pipe, head_db, auto_render, serve)
    # phase 30's matcher: the one-process register against this database
    match_batch = SyntheticDataset(
        n_items=SERVE_B, num_views=3, window_num_imgs=1, img_height=224,
        img_width=224).batch(SERVE_B)
    with torch.no_grad():
        match_q = head_pipe.embed(head_pipe.render(match_batch))
    _, match_idx, match_dist = head_pipe.register(match_batch,
                                                  top_k=MATCH_TOP_K)
    match_in = dict(q=match_q.cpu(), db=head_db.cpu(), idx=match_idx.cpu(),
                    dist=match_dist.cpu())
    del head_pipe, head_db, match_q
    torch.cuda.empty_cache()

    stamp("phase 28")
    # ---- the host data feed and the training CLI: the flagship trained by
    # train.main from a GPS trace and PNG frames, host and device routes,
    # and served from the map PNG's tiles ----
    feed = file_feed_phase(card, train_default)

    stamp("phase 29")
    # ---- grouped training: k steps a dispatch, each a CUDA graph replay,
    # against eager steps on both routes; site_remat "dots"; the
    # utilities ----
    keep = {}
    graphed = graph_phase(card, keep)

    stamp("phase 30")
    # ---- data parallelism: phase 29's graphed step in a one-rank NCCL
    # group, two gloo ranks sharing the card against one process, and
    # the sharded matcher on them ----
    parallel = parallel_phase(card, keep, match_in)

    stamp("phase 31")
    # ---- the model axis: two model ranks of the flagship on the card,
    # and data x model ranks of the small model ----
    model_parallel = model_parallel_phase(card)

    def entry(name, route, src, replaces, data, launches, **more):
        per = "per_forward" if "per_forward" in data["rows"][0] else "per_step"
        top = max(data["rows"], key=lambda r: r[per] * r["ms"])
        return {
            **more,
            "name": name, "route": route, "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": data["worst"],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top.get("library_ms"), "shape": top["site"],
            **({"plan": top["plan"]} if "plan" in top else {}),
            "per_shape": data["rows"],
            **({"max_abs_err_online": data["worst_online"]}
               if "worst_online" in data else {}),
        }

    # the streamed frames' measured launches, a frame; a gloo rank's, a step
    stream_frame = {k: n // stream["frames"] for k, n in stream["counts"].items()}
    dp_step = {k: n // DP_STEPS for k, n in
               parallel["gloo_ranks"]["launches_a_rank"].items()}

    def mp_launch(name, what):
        """A model rank's launches of ``name`` in phase 31a: a request, a
        default-route step, or the one request or step of a folded or
        fused_bwd route."""
        per = {"request": model_parallel["launches_rank_request"],
               "step": model_parallel["launches_rank_step"],
               **model_parallel["launches_rank_fold"],
               **model_parallel["launches_rank_fused_step"]}[what]
        return per.get(name, 0)
    record = {"kernels": [
        entry("lattice_bias", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/lattice_bias.cu",
              "bevrender_tpu/ops/pallas/lattice_bias.py:700", bias,
              counts["lattice_bias"],
              launches_train=train_default["counts"]["lattice_bias"],
              launches_train_fused_bwd=train_fused["counts"]["lattice_bias"],
              launches_pyramid_serving=pyr_serve["counts"]["lattice_bias"],
              launches_pyramid_train=pyr_train["counts"]["lattice_bias"],
              launches_head_serving=head["counts"]["lattice_bias"],
              launches_streaming_frame=stream_frame["lattice_bias"],
              launches_file_fed_step=feed["host"]["counts_per_step"][
                  "lattice_bias"],
              launches_graphed_step=graphed["default"]["captured_per_step"][
                  "lattice_bias"],
              launches_graphed_step_fused_bwd=graphed["fused_bwd"][
                  "captured_per_step"]["lattice_bias"],
              launches_dp_rank_step=dp_step["lattice_bias"],
              launches_mp_rank_request=mp_launch("lattice_bias", "request"),
              launches_mp_rank_step=mp_launch("lattice_bias", "step"),
              per_shape_train=bias_bwd["fwd_rows"],
              per_shape_pyramid=pyr_bias["lattice_bias"]["rows"]),
        entry("fused_site", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site.cu",
              "bevrender_tpu/ops/pallas/fused_attn.py:637", site,
              counts["fused_site"],
              launches_train=train_default["counts"]["fused_site"],
              launches_train_fused_bwd=train_fused["counts"]["fused_site"],
              launches_head_serving=head["counts"]["fused_site"],
              launches_streaming_frame=stream_frame["fused_site"],
              launches_file_fed_step=feed["host"]["counts_per_step"][
                  "fused_site"],
              launches_graphed_step=graphed["default"]["captured_per_step"][
                  "fused_site"],
              launches_dp_rank_step=dp_step["fused_site"],
              launches_mp_rank_request=mp_launch("fused_site", "request"),
              launches_mp_rank_step=mp_launch("fused_site", "step")),
        entry("lattice_bias_bwd", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/lattice_bias_bwd.cu",
              "bevrender_tpu/ops/pallas/lattice_bias.py:829", bias_bwd,
              train_default["counts"]["lattice_bias_bwd"],
              launches_train_fused_bwd=train_fused["counts"]["lattice_bias_bwd"],
              launches_pyramid_train=pyr_train["counts"]["lattice_bias_bwd"],
              launches_file_fed_step=feed["host"]["counts_per_step"][
                  "lattice_bias_bwd"],
              launches_graphed_step=graphed["default"]["captured_per_step"][
                  "lattice_bias_bwd"],
              launches_dp_rank_step=dp_step["lattice_bias_bwd"],
              launches_mp_rank_step=mp_launch("lattice_bias_bwd", "step"),
              per_step_ms=bias_bwd["per_step_ms"],
              per_step_ms_pyramid=pyr_bias["lattice_bias_bwd"]["per_step_ms"],
              per_shape_pyramid=pyr_bias["lattice_bias_bwd"]["rows"]),
        entry("fused_site_lse", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site.cu",
              "bevrender_tpu/ops/pallas/fused_attn.py:278", site_lse,
              train_fused["counts"]["fused_site_lse"],
              launches_graphed_step_fused_bwd=graphed["fused_bwd"][
                  "captured_per_step"]["fused_site_lse"],
              launches_mp_rank_step_fused_bwd=mp_launch(
                  "fused_site_lse", "fused_bwd")),
        entry("fused_site_bwd", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site_bwd.cu",
              "bevrender_tpu/ops/pallas/fused_attn.py:429", site_bwd,
              train_fused["counts"]["fused_site_bwd"],
              launches_graphed_step_fused_bwd=graphed["fused_bwd"][
                  "captured_per_step"]["fused_site_bwd"],
              launches_mp_rank_step_fused_bwd=mp_launch(
                  "fused_site_bwd", "fused_bwd")),
        entry("lattice_bias_wide", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/lattice_bias_wide.cu",
              "bevrender_tpu/ops/pallas/lattice_bias.py:422",
              pyr_bias["lattice_bias_wide"],
              pyr_serve["counts"]["lattice_bias_wide"],
              launches_pyramid_train=pyr_train["counts"]["lattice_bias_wide"],
              launches_flagship_wide=wide_serve["counts"]["lattice_bias_wide"],
              launches_flagship_wide_train=wide_train["counts"][
                  "lattice_bias_wide"],
              per_shape_flagship=bias_wide_flagship["rows"]),
        entry("lattice_bias_wide_bwd", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/lattice_bias_wide_bwd.cu",
              "bevrender_tpu/ops/pallas/lattice_bias.py:549",
              pyr_bias["lattice_bias_wide_bwd"],
              pyr_train["counts"]["lattice_bias_wide_bwd"],
              launches_flagship_wide_train=wide_train["counts"][
                  "lattice_bias_wide_bwd"],
              per_step_ms_pyramid=pyr_bias["lattice_bias_wide_bwd"][
                  "per_step_ms"],
              per_shape_flagship=bias_wide_bwd_flagship["rows"]),
        entry("fused_site_wide", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site_wide.cu",
              "bevrender_tpu/ops/pallas/fused_attn.py:193", site_wide,
              wide_serve["counts"]["fused_site_wide"],
              launches_flagship_wide_train=wide_train["counts"][
                  "fused_site_wide"]),
        entry("fused_site_wide_lse", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site_wide.cu",
              "bevrender_tpu/ops/pallas/fused_attn.py:278", site_wide_lse,
              wide_train["counts"]["fused_site_wide_lse"]),
        entry("fused_site_wide_prefetch", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/"
              "fused_site_wide_prefetch.cu",
              "bevrender_tpu/ops/pallas/experimental.py:184", site_prefetch,
              prefetch_serve["counts"]["fused_site_wide_prefetch"]),
        entry("lattice_bias_wide_prefetch", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/"
              "lattice_bias_wide_prefetch.cu",
              "bevrender_tpu/ops/pallas/lattice_bias.py:422", bias_prefetch,
              prefetch_serve["counts"]["lattice_bias_wide_prefetch"],
              launches_pyramid_serving=pyr_prefetch["counts"][
                  "lattice_bias_wide_prefetch"]),
        entry("fused_site_fold_heads", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site_fold_heads.cu",
              "bevrender_tpu/ops/pallas/experimental.py:439", site_heads,
              fold_heads_serve["counts"]["fused_site_fold_heads"],
              launches_mp_rank_request=mp_launch("fused_site_fold_heads",
                                                 "fold_heads")),
        entry("fused_site_fold_heads_lse", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site_fold_heads.cu",
              "bevrender_tpu/ops/pallas/experimental.py:560", site_heads_lse,
              fold_train["counts"]["fused_site_fold_heads_lse"],
              launches_mp_rank_step_fused_bwd=mp_launch(
                  "fused_site_fold_heads_lse", "fused_bwd_fold")),
        entry("fused_site_fold_rows", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site_fold_rows.cu",
              "bevrender_tpu/ops/pallas/experimental.py:659", site_rows,
              fold_rows_serve["counts"]["fused_site_fold_rows"],
              launches_mp_rank_request=mp_launch("fused_site_fold_rows",
                                                 "fold_rows")),
        entry("lattice_windows", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/lattice_windows.cu",
              "bevrender_tpu/ops/pallas/lattice_win.py:169", win_fwd,
              windows_serve["counts"]["lattice_windows"],
              launches_train=windows_train["counts"]["lattice_windows"],
              launches_pyramid_serving=pyr_windows["counts"][
                  "lattice_windows"]),
        entry("lattice_windows_bwd", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/lattice_windows.cu",
              "bevrender_tpu/ops/pallas/lattice_win.py:113", win_bwd,
              windows_train["counts"]["lattice_windows_bwd"]),
    ], "card": card, "train": [train_default, train_none, train_fused],
        "pyramid": {"serving": pyr_serve, "train": [pyr_train, pyr_none],
                    "small_model_grad_err": grads_wide["worst"]},
        "wide": {"serving": wide_serve, "prefetch_serving": prefetch_serve,
                 "train": wide_train, "pyramid_prefetch_serving": pyr_prefetch,
                 "render_diff": render_diff},
        "fold": {"heads_serving": fold_heads_serve,
                 "rows_serving": fold_rows_serve, "train": fold_train,
                 "render_diff": fold_diff},
        "windows": {"serving": windows_serve, "train": windows_train,
                    "pyramid_serving": pyr_windows, "bias": win_bias},
        "retrieval_head": head, "streaming": stream, "file_feed": feed,
        "graphed": graphed, "parallel": parallel,
        "model_parallel": model_parallel,
        "small_model_grad_err": [grads_default["worst"], grads_fused["worst"]],
        "fused_site_mma": dict(
            mma, source="bevrender_tpu_torch/ops/kernels/csrc/"
            "fused_site_mma.cu", replaces=None, launches=counts[
                "fused_site_mma"],
            launches_train=train_default["counts"]["fused_site_mma"],
            launches_pyramid_serving=pyr_serve["counts"]["fused_site_mma"]),
        "build_s": build_s, "serving": serve,
        "render_diff_online": d_kernel, "render_diff_plain": d_round}
    stamp("record")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    os.chdir(HERE)
    main()
