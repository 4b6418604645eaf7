"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from the sources in this checkout (one nvcc per
   source, all at once);
3. the flagship render+register path (bf16, B=4, T=2, V=3, 224x224,
   64-tile database, seeded weights): the launch counters must show 24
   fused-site and 64 bias launches per forward; time of a window of
   requests, its spread, the host's CPU time, peak memory and the
   device's idle share;
4. each kernel against its plain PyTorch version at every shape the main
   path gives it, with seeded inputs; the fused site also against
   ``site_consumer_online`` (its own roundings, written in PyTorch), and
   with a second rpe table whose bias dominates the scores; times of
   kernel, plain version and a library yardstick (profiler device time),
   and the least time the card could take (bytes or operations over the
   H100's published peaks);
5. a small 2-stage model at float32 through the kernels and through
   plain PyTorch that rounds as the kernels do: the renders must agree to
   RENDER_TOL;
6. training, default route: ``Trainer`` on the flagship bf16 model, B=2,
   T=2, MSE loss, drop path 0.2 from a seeded generator, one warm-up step
   and TRAIN_STEPS steps on a fixed batch: exact launch counts per step,
   finite falling loss, finite non-zero gradients on every parameter,
   BatchNorm buffers moved; ms per step, host CPU ms per step, peak memory
   under ``site_remat`` "nothing" and "none", device busy and idle share,
   the top device operations;
7. the same steps with ``fused_bwd=True`` (the fused site's own backward
   kernel at head widths 4 and 8);
8. the backward kernels (bias backward, fused site with logsumexp, fused
   site backward) against their plain versions, and the site backward also
   against ``site_bwd_online`` (its own roundings in PyTorch), at every
   shape a training step gives them and at two table scales; the bias
   forward kernel against its plain version at those training shapes too;
9. the small model's parameter gradients through the kernels against
   plain PyTorch that rounds as the kernels do, under both routes; then
   one K-fold epoch of ``Trainer.train`` on that model on the card, with
   the pinned-memory prefetch, validation, recall and checkpoints;
10. the pyramid (``Config()``, the reference default: BEV 56-28-14-7-14-28-
    56, widths 64-512, ResNet-18, 3 views of 224 x 224) in bf16, serving:
    render+register at B=2, T=2 against 64 tiles, one warm-up and
    PYR_REQUESTS requests with exact launch counts (no fused site; SCA at
    BEV 56 on the wide bias kernel, every other site on the whole-table
    one), the same measurements as phase 3;
11. the pyramid training: ``Trainer`` at B=2, T=2 as in phase 6, exact
    launch counts of the four bias kernels per step, every parameter
    (transitions, width fixes and rpe tables among them) with a finite
    non-zero gradient, peak memory under ``site_remat`` "nothing" and
    "none";
12. the bias kernels at every pyramid shape against their plain versions
    (forward, and backward through autograd) at two table scales: the
    whole-table kernels at all eight shapes (M = 196 and 49 at BEV 14 and
    7), the wide ones at BEV 56; times, bounds, the plain version's peak
    memory;
13. a small BEV 56 -> 28 -> 56 model whose SCA at 56 takes the wide kernels
    through the normal dispatch: its parameter gradients through the
    kernels against plain PyTorch with the kernels' roundings, as phase 9;
14. the wide-table route: the flagship serving as phase 3 (WIDE_REQUESTS
    requests) with ``lattice_route="wide"``: exactly 24
    ``fused_site_wide`` and 64 ``lattice_bias_wide`` launches per forward,
    and the render equal to phase 3's;
15. the same with ``site_prefetch`` and ``bias_forward="prefetch"``: 24
    ``fused_site_wide_prefetch`` and 64 ``lattice_bias_wide_prefetch`` per
    forward, the render equal to phase 3's;
16. flagship training on the wide route with ``fused_bwd``, as phase 7:
    the counts of phase 7 on the wide kernels (12 ``fused_site_wide_lse``
    and 12 ``fused_site_bwd`` per step);
17. the pyramid serving as phase 10 with ``bias_forward="prefetch"``: 24
    ``lattice_bias_wide_prefetch`` and 64 ``lattice_bias`` per forward, the
    render equal to phase 10's;
18. each new kernel alone at every shape phases 14-17 give it, at two
    table scales, against its plain version and, with tolerance 0, against
    its bit-equal sibling; ``lattice_bias_wide`` and its backward at the
    flagship's shapes; times, bounds, plain and library times;
19. the folded fused sites: the flagship serving as phase 14
    (WIDE_REQUESTS requests) with ``lattice_route="wide"``,
    ``site_prefetch`` and ``site_fold_heads``: exactly 24
    ``fused_site_fold_heads`` and 64 ``lattice_bias_wide`` per forward, the
    render equal to phase 3's;
20. the flagship serving with ``site_fold_rows`` on "auto" (WIDE_REQUESTS
    requests): 24 ``fused_site_fold_rows`` and 64 ``lattice_bias`` per
    forward, the render equal to phase 3's;
21. flagship training as phase 7 (``fused_bwd``) with ``site_prefetch`` and
    ``site_fold_heads`` on "auto": phase 7's counts with 12
    ``fused_site_fold_heads_lse`` in place of the 12 ``fused_site_lse`` per
    step; step 1's loss printed beside phase 7's;
22. each folded kernel alone at every shape phases 19-21 give it, at two
    table scales, against its plain version and, with tolerance 0, against
    its per-head sibling; times, bounds, plain and library times, and the
    sibling's time in the same call;
23. the windowed bias (``bias_forward="windows"``): the flagship serving as
    phase 3 (WINDOWS_REQUESTS requests), exactly 24 ``fused_site`` and 64
    ``lattice_windows`` per forward, the render equal (max abs 0) to the
    same model's render with every window cut by ``lattice_windows_plain``
    on the card;
24. flagship training as phase 6 with ``bias_forward="windows"``: phase
    6's counts with ``lattice_windows`` for ``lattice_bias`` (120 per step)
    and ``lattice_windows_bwd`` for ``lattice_bias_bwd`` (44);
25. the window kernels alone: ``lattice_windows`` equal to its plain
    version at every shape the bias sees (the flagship's serving and
    training shapes, the pyramid's SCA 56 and BEV 7), ``lattice_windows_bwd``
    within BWD_SUM_TOL of its plain version at the training shapes and the
    pyramid's SCA 56; the windowed bias equal to the plain bias and within
    WINDOWED_TOL of ``lattice_bias.cu`` / ``lattice_bias_wide.cu``; kernel,
    plain, library and bound times; then the pyramid serving with
    ``bias_forward="windows"`` (PYR_WINDOWS_REQUESTS requests): 88
    ``lattice_windows`` per forward, the render equal to its plain-windows
    render.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
there is no CUDA device or the port's package is not beside this file.
"""

from __future__ import annotations

import contextlib
import json
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
# 32 bias launches (stages 0, 1, 5, 6: 8 layers x (TSA + 3 views)). Final
# pass, default route: every site takes the bias kernel, 32 + 12 = 44
# forward and 44 backward, and 44 more forward when the backward recomputes
# the site (site_remat "nothing"). With fused_bwd the 12 narrow sites take
# the logsumexp forward and the site backward instead.
TRAIN_COUNTS = {
    (False, "nothing"): dict(fused_site=12, lattice_bias=32 + 44 + 44,
                             lattice_bias_bwd=44),
    (False, "none"): dict(fused_site=12, lattice_bias=32 + 44,
                          lattice_bias_bwd=44),
    (True, "nothing"): dict(fused_site=12, lattice_bias=32 + 32 + 32,
                            lattice_bias_bwd=32, fused_site_lse=12,
                            fused_site_bwd=12),
}
SERVE_B = 4
FUSED_PER_FORWARD = 24
BIAS_PER_FORWARD = 64
# The pyramid (Config(): BEV 56-28-14-7-14-28-56, widths 64-512, heads
# 2-4-8-16-8-4-2, groups 1-2-4-8-4-2-1, depth 2). Head width 32 at every
# stage: no fused site, every site takes the bias kernels. Per pass, per
# layer: stages 0, 1, 5, 6 one TSA and three SCA sites (G < 4, one per
# view), stages 2-4 one TSA and one SCA with the views folded; 22 per layer,
# 44 per pass. SCA at BEV 56 (stages 0 and 6, 12 per pass) takes the wide
# kernels (ops.deform_attn.bias_route), the 32 others the whole-table ones.
PYR_B = 2
PYR_REQUESTS = 10
PYR_PER_FORWARD = dict(lattice_bias=2 * 32, lattice_bias_wide=2 * 12)  # T=2
# a training step at T=2: the history pass (eval, no gradient), the final
# pass, and with site_remat "nothing" every site's bias again in the
# backward; fused_bwd changes nothing (head width 32)
PYR_TRAIN_COUNTS = {
    "nothing": dict(lattice_bias=32 * 3, lattice_bias_wide=12 * 3,
                    lattice_bias_bwd=32, lattice_bias_wide_bwd=12),
    "none": dict(lattice_bias=32 * 2, lattice_bias_wide=12 * 2,
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
# TRAIN_COUNTS[(True, "nothing")] on the wide kernels; the site backward
# stays fused_site_bwd, whose shared memory holds the flagship's tables
WIDE_NAMES = dict(fused_site="fused_site_wide",
                  fused_site_lse="fused_site_wide_lse",
                  lattice_bias="lattice_bias_wide",
                  lattice_bias_bwd="lattice_bias_wide_bwd",
                  fused_site_bwd="fused_site_bwd")
WIDE_TRAIN_COUNTS = {WIDE_NAMES[k]: v
                     for k, v in TRAIN_COUNTS[(True, "nothing")].items()}
# the pyramid with bias_forward "prefetch" (phase 17): its SCA at BEV 56, the
# one site that takes the wide bias on the "auto" route, on the prefetch
# variant
PYR_PREFETCH_PER_FORWARD = dict(lattice_bias=PYR_PER_FORWARD["lattice_bias"],
                                lattice_bias_wide_prefetch=PYR_PER_FORWARD[
                                    "lattice_bias_wide"])
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
                             lattice_bias=BIAS_PER_FORWARD)
FOLD_TRAIN_COUNTS = {
    ("fused_site_fold_heads_lse" if k == "fused_site_lse" else k): v
    for k, v in TRAIN_COUNTS[(True, "nothing")].items()}
# The windowed bias (ModelConfig.bias_forward="windows", phases 23-25): every
# site that takes the bias takes lattice_windows in its forward and
# lattice_windows_bwd in its backward; the fused sites do not change
WINDOWS_REQUESTS = 10
WINDOWS_PER_FORWARD = dict(fused_site=FUSED_PER_FORWARD,
                           lattice_windows=BIAS_PER_FORWARD)
WINDOW_NAMES = dict(lattice_bias="lattice_windows",
                    lattice_bias_bwd="lattice_windows_bwd")
WINDOWS_TRAIN_COUNTS = {WINDOW_NAMES.get(k, k): v
                        for k, v in TRAIN_COUNTS[(False, "nothing")].items()}
PYR_WINDOWS_REQUESTS = 3
PYR_WINDOWS_PER_FORWARD = dict(lattice_windows=sum(PYR_PER_FORWARD.values()))
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
    seen = {n: sum(e.count for e in avgs if f"{n}_kernel" in e.key)
            for n in per_forward}
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


def site_inputs(seed, B, G, ch, N, Wt, table_std=0.01):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    table = torch.randn(G, HPG, 2 * H - 1, Wt, generator=g,
                        device=dev) * table_std
    k_pos = torch.rand(B, G, N, 2, generator=g, device=dev) * 2.4 - 1.2
    q = torch.randn(B, G, HPG, H * W, ch, generator=g, device=dev) * 0.5
    k = torch.randn(B, G, HPG, N, ch, generator=g, device=dev) * 0.5
    v = torch.randn(B, G, HPG, N, ch, generator=g, device=dev) * 0.5
    return table, k_pos, q, k, v


def check_bias(da, kernel_mod) -> dict:
    import torch

    rows, worst = [], 0.0
    for i, (name, B, G, ch, N, Wt, per_fwd) in enumerate(BIAS_SITES):
        table, k_pos, *_ = site_inputs(10 + i, B, G, ch, N, Wt)
        args = da._kernel_args(table, k_pos, H, W)
        out = kernel_mod.lattice_bias_cuda(*args, H, W)
        tb = table.bfloat16().float()
        ref = da.lattice_bias_plain(tb, k_pos, H, W, torch.float32).bfloat16()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        if not bool((err <= ref.float().abs() * BIAS_ULP).all()):
            fail(f"lattice_bias {name}: max err {float(err.max())} > 1 bf16 ulp")
        worst = max(worst, float(err.max()))
        launch = lambda: kernel_mod.lattice_bias_cuda(*args, H, W)  # noqa: E731
        ms = queued_ms(launch, 20)
        ev = events_ms(launch, 20)
        plain = queued_ms(lambda: da.lattice_bias_plain(tb, k_pos, H, W,
                                                        torch.float32), 5)
        bound, by = bias_bounds(B, G, N, Wt, H, backward=False)
        rows.append(dict(site=name, ms=ms, events_ms=ev, plain_ms=plain,
                         bound_ms=bound, bound_by=by, per_forward=per_fwd,
                         max_abs_err=float(err.max())))
        print(f"lattice_bias {name}: max_abs_err {float(err.max()):.3g} "
              f"kernel {ms:.4f} ms (events {ev:.4f}) plain {plain:.4f} ms "
              f"bound {bound:.4f} ms "
              f"({by}) x{per_fwd}/forward", flush=True)
    return dict(rows=rows, worst=worst)


def site_bound(B, G, ch, N, Wt, extra_bytes=0, lse=False):
    """(bound ms, what bounds it) of a fused site forward: bytes (q, k, v,
    the table, the geometry, the output, the logsumexp, and ``extra_bytes``)
    against 4 ch bf16 FLOP per (query, key) pair at the tensor-core rate
    plus 18 float32 operations (bias lerps, score, running max, exp, sum)."""
    pairs = B * G * HPG * H * W * N
    q_el, kv_el = B * G * HPG * H * W * ch, B * G * HPG * N * ch
    nbytes = ((q_el + 2 * kv_el) * 2 + G * HPG * (2 * H - 1) * Wt * 2
              + B * G * N * 16 + W * 8 + q_el * 4
              + (B * G * HPG * H * W * 4 if lse else 0) + extra_bytes)
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
    import torch

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
                         max_abs_err_online=kept["err_online"]))
        print(f"fused_site {name}: kernel {ms:.4f} ms (events {ev:.4f}) "
              f"plain {plain:.4f} ms sdpa+mask {lib:.4f} ms bound "
              f"{bound:.4f} ms ({by}) x{per_fwd}/forward", flush=True)
    if bad:
        fail(f"fused_site beyond tolerance at {bad}")
    return dict(rows=rows, worst=worst, worst_online=worst_online)


@contextlib.contextmanager
def plain_sites(da, online: bool = False):
    """Route every lattice site through plain PyTorch on the card, fed as
    the kernels are (bf16-rounded table, float32 lerps, bf16 bias), with
    autograd. The fused sites take ``site_consumer`` (p rounded after
    normalising, as the JAX package's ``_site_xla``) or, with ``online``,
    the kernels' own roundings (``site_consumer_online`` forward,
    ``site_bwd_online`` backward)."""
    import torch

    def rounded(t):
        # the bf16-rounded table as a float32 tensor whose gradient reaches
        # ``t`` unrounded, as the kernels' float32 table gradient does
        return t + (t.detach().bfloat16().float() - t.detach())

    def bias(t, p, h, w, kernel=None):
        return da.lattice_bias_plain(rounded(t), p, h, w,
                                     torch.float32).bfloat16()

    def site(q, k, v, p, t, h, w, scale, kernel=None):
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
    forward kernel's output at those shapes against the plain bias too.
    With ``wide``, the wide kernels (``lattice_route="wide"``) at the same
    shapes, the forward also against the whole-table one bit for bit; their
    launches per step are those of phase 16 (``fused_bwd``: the narrow
    sites take the fused site instead)."""
    import torch

    fwd_kernel = "lattice_bias_wide" if wide else None
    bwd_call = (kernel_mod.lattice_bias_wide_bwd_cuda if wide
                else kernel_mod.lattice_bias_bwd_cuda)
    tag = "lattice_bias_wide_bwd" if wide else "lattice_bias_bwd"
    rows, worst, worst_fwd, bad = [], 0.0, 0.0, []
    for i, (name, B, G, ch, N, Wt, per_step) in enumerate(TRAIN_BIAS_SITES):
        if wide and ch <= 8:
            per_step = 0
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
            # it at the serving shapes: within one bf16 ulp of the plain bias
            with torch.no_grad():
                rb = ref.bfloat16().float()
                e_f = (fwd.float() - rb).abs()
                ok_f = bool((e_f <= rb.abs() * BIAS_ULP).all())
                if wide:
                    ok_f = ok_f and torch.equal(
                        fwd, da.lattice_bias(table, k_pos, H, W))
                e_f = float(e_f.max())
                del rb
            torch.cuda.synchronize()
            e_t, e_p = rel_err(dt, rdt), rel_err(dp, rdp)
            ok = ok_f and e_t <= BWD_SUM_TOL and e_p <= BWD_SUM_TOL and bool(
                torch.isfinite(dt).all() and torch.isfinite(dp).all())
            print(f"{tag} {name} table std {std}: forward max "
                  f"abs err {e_f:.3g} ({'within' if ok_f else 'BEYOND'} 1 "
                  f"bf16 ulp{', equal to lattice_bias' if wide else ''}); "
                  f"dtable rel err {e_t:.3g}, dk_pos rel err "
                  f"{e_p:.3g} ({'ok' if ok else 'FAIL'})", flush=True)
            worst_fwd = max(worst_fwd, e_f)
            del fwd
            if not ok:
                bad.append(f"{name} std {std}")
            if std == SITE_TABLE_STDS[0]:
                err = float((dt - rdt).abs().max())
                worst = max(worst, err)
                args = da._kernel_args(table, k_pos, H, W)
                launch = lambda: bwd_call(*args, gout, H, W)  # noqa: E731
                ms = queued_ms(launch, 10)
                ev = events_ms(launch, 10)
                gf = gout.float()
                plain = queued_ms(lambda: torch.autograd.grad(
                    ref, (t2, p2), gf, retain_graph=True), 3)
                bound, by = bias_bounds(B, G, N, Wt, H, backward=True)
                rows.append(dict(site=name, ms=ms, events_ms=ev,
                                 plain_ms=plain, bound_ms=bound, bound_by=by,
                                 per_step=per_step, max_abs_err=err,
                                 rel_err_dtable=e_t, rel_err_dkpos=e_p))
                print(f"{tag} {name}: kernel {ms:.4f} ms (events "
                      f"{ev:.4f}) plain {plain:.4f} ms bound {bound:.4f} ms "
                      f"({by}) x{per_step}/step", flush=True)
            del ref, rdt, rdp, dt, dp
        torch.cuda.empty_cache()
    if bad:
        fail(f"{tag} beyond tolerance at {bad}")
    return dict(rows=rows, worst=worst, worst_fwd=worst_fwd)


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


def bias_bounds(B, G, N, Wt, H, backward: bool, extra_bytes: int = 0):
    """(bound ms, what bounds it) of the bias forward or backward: bytes
    (each input read once, each output written once) against float32
    operations (forward 12 per element: phi, floor, frac and three lerps of
    three; backward 28: window fractions 3, two x-lerps 6, the tail 15 (dwy
    3, d0/d1 3, df 7, 1 - wx, 4 weights as 2 per pair of corners) and 4 adds
    into the table gradient) at the H100's published peaks; ``extra_bytes``
    (a prefetch kernel's pitched table copy) adds to the bytes."""
    elems = B * G * HPG * N * H * H
    table = G * HPG * (2 * H - 1) * Wt
    if backward:
        nbytes = elems * 2 + table * (2 + 4) + B * G * N * (16 + 8) + H * 8
        ops = elems * 28
    else:
        nbytes = elems * 2 + table * 2 + B * G * N * 16 + H * 8
        ops = elems * 12
    nbytes += extra_bytes
    by = "bytes" if nbytes / HBM_BPS >= ops / F32_FLOPS else "operations"
    return max(nbytes / HBM_BPS, ops / F32_FLOPS) * 1e3, by


def check_pyramid_bias(da, kernels) -> dict:
    """The bias kernels at every pyramid shape, forward against the plain
    version (one bf16 ulp) and backward against autograd through it
    (BWD_SUM_TOL of the largest entry), at two table scales: the whole-table
    kernels at every shape, the wide ones at BEV 56. Times at table std
    0.01; the plain version's peak memory at SCA 56."""
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
            rb = ref.detach().bfloat16().float()
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
                # dk_pos from the kernels' dwy, df through the geometry, as
                # _LatticeBiasFn hands them to autograd
                p3 = k_pos.clone().requires_grad_()
                _, _, wy3, f3 = da.lattice_geometry(table.shape, p3, H, H)
                (dp,) = torch.autograd.grad((wy3, f3), p3, (dwy, df))
                torch.cuda.synchronize()
                e_f = (out.float() - rb).abs()
                ok_f = bool((e_f <= rb.abs() * BIAS_ULP).all())
                e_t, e_p = rel_err(dt, rdt), rel_err(dp, rdp)
                ok = (ok_f and e_t <= BWD_SUM_TOL and e_p <= BWD_SUM_TOL
                      and bool(torch.isfinite(dt).all()))
                print(f"pyramid bias {route} {name} table std {std}: forward "
                      f"max abs err {float(e_f.max()):.3g} "
                      f"({'within' if ok_f else 'BEYOND'} 1 bf16 ulp); "
                      f"dtable rel err {e_t:.3g}, dk_pos rel err {e_p:.3g} "
                      f"({'ok' if ok else 'FAIL'}); plain version's peak "
                      f"{plain_gib:.3f} GiB", flush=True)
                if not ok:
                    bad.append(f"{route} {name} std {std}")
                if std != SITE_TABLE_STDS[0]:
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
                         dict(per_forward=per, per_step=per * 3 // 2)),
                        (kb, ms_b, plain_b, float((dt - rdt).abs().max()),
                         dict(per_step=per // 2))):
                    bound, by = bias_bounds(B, G, N, Wt, H, kname == kb)
                    out_rows[kname].append(dict(
                        site=name, ms=ms, plain_ms=plain, bound_ms=bound,
                        bound_by=by, library_ms=None, max_abs_err=err,
                        plain_peak_gib=plain_gib, **launches))
                    print(f"pyramid {kname} {name}: kernel {ms:.4f} ms plain "
                          f"{plain:.4f} ms bound {bound:.4f} ms ({by}); "
                          f"launches {launches}", flush=True)
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
                      max_abs_err_online=kept["lse_err_online"])),
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
              f"x{per_step}/step", flush=True)
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


def check_wide_site(da, kernels) -> tuple:
    """Phase 18, the fused sites of the wide route at every serving shape of
    phases 14-15 (SITE_SITES) and two table scales: ``fused_site_wide``
    equal to ``fused_site`` bit for bit and ``fused_site_wide_prefetch``
    equal to it, both within the fused site's tolerances of the plain
    version and of the online mirror. Times (the prefetch variant's as
    the sum of its kernel's and its pitched table copy's), bounds, plain
    and library times, and
    ``fused_site``'s time at the same shapes for comparison. Returns
    (fused_site_wide record, fused_site_wide_prefetch record)."""
    import torch

    wide = kernels.fused_site_wide
    rows_w, rows_p, bad = [], [], []
    worst = dict(wide=0.0, wide_online=0.0, prefetch=0.0, prefetch_online=0.0)
    for i, (name, B, G, ch, N, Wt, per_fwd) in enumerate(SITE_SITES):
        for std in SITE_TABLE_STDS:
            table, k_pos, q, k, v = site_inputs(80 + i, B, G, ch, N, Wt, std)
            scale = ch ** -0.5
            bf = torch.bfloat16
            kargs = da._kernel_args(table, k_pos, H, W) + tuple(
                x.to(bf).contiguous() for x in (q, k, v))
            geo, qkv = kargs[:7], kargs[8:]
            whole = kernels.fused_site.fused_site_cuda(*kargs, H, W, scale)
            out_w = wide.fused_site_wide_cuda(*geo, *qkv, H, W, scale)
            out_p = wide.fused_site_wide_prefetch_cuda(*geo, *qkv, H, W, scale)
            tb = table.bfloat16().float()
            bias = da.lattice_bias_plain(tb, k_pos, H, W, torch.float32)
            ref = da.site_consumer(q, k, v, bias, scale)
            wabs = da.site_consumer(q, k, v.abs(), bias, scale)
            online = da.site_consumer_online(q, k, v, bias, scale)
            torch.cuda.synchronize()
            same_w = torch.equal(out_w, whole)
            same_p = torch.equal(out_p, out_w)
            errs = {}
            for tag, out in (("wide", out_w), ("prefetch", out_p)):
                d_plain, d_online = (out - ref).abs(), (out - online).abs()
                errs[tag] = (float(d_plain.max()), float(d_online.max()),
                             bool((d_plain <= SITE_P_ROUND * wabs + 1e-5).all())
                             and bool((d_online <= ONLINE_TOL * wabs
                                       + 1e-7).all()))
            ok = same_w and same_p and errs["wide"][2] and errs["prefetch"][2]
            print(f"fused_site_wide {name} table std {std}: "
                  f"{'equals' if same_w else 'DIFFERS FROM'} fused_site; "
                  f"prefetch {'equals' if same_p else 'DIFFERS FROM'} "
                  f"fused_site_wide; max abs err vs plain {errs['wide'][0]:.3g}"
                  f", vs site_consumer_online {errs['wide'][1]:.3g} "
                  f"({'ok' if ok else 'FAIL'})", flush=True)
            if not ok:
                bad.append(f"{name} std {std}")
            for tag in ("wide", "prefetch"):
                worst[tag] = max(worst[tag], errs[tag][0])
                worst[tag + "_online"] = max(worst[tag + "_online"],
                                             errs[tag][1])
            if std != SITE_TABLE_STDS[0]:
                continue
            ms_whole = queued_ms(lambda: kernels.fused_site.fused_site_cuda(
                *kargs, H, W, scale), 20)
            ms_w = queued_ms(lambda: wide.fused_site_wide_cuda(
                *geo, *qkv, H, W, scale), 20)
            launch_p = lambda: wide.fused_site_wide_prefetch_cuda(  # noqa: E731
                *geo, *qkv, H, W, scale)
            ms_p_kernel = device_ms(launch_p, 20,
                                    "fused_site_wide_prefetch_kernel")
            ms_p = queued_ms(launch_p, 20)
            plain = queued_ms(lambda: da.site_plain(q, k, v, k_pos, tb, H, W,
                                                    scale, torch.float32), 5)
            lib = sdpa_ms(q, k, v, bias, scale, 20)
            b_w = site_bound(B, G, ch, N, Wt)
            b_p = site_bound(B, G, ch, N, Wt, pitched_bytes(G, 2 * H - 1, Wt))
            common = dict(site=name, plain_ms=plain, library_ms=lib,
                          per_forward=per_fwd, fused_site_ms=ms_whole)
            rows_w.append(dict(common, ms=ms_w, bound_ms=b_w[0],
                               bound_by=b_w[1], max_abs_err=errs["wide"][0],
                               max_abs_err_online=errs["wide"][1]))
            rows_p.append(dict(common, ms=ms_p, kernel_only_ms=ms_p_kernel,
                               bound_ms=b_p[0], bound_by=b_p[1],
                               max_abs_err=errs["prefetch"][0],
                               max_abs_err_online=errs["prefetch"][1]))
            print(f"fused_site_wide {name}: kernel {ms_w:.4f} ms, prefetch "
                  f"{ms_p:.4f} ms (kernel alone {ms_p_kernel:.4f}), "
                  f"fused_site {ms_whole:.4f} ms; plain {plain:.4f} ms "
                  f"sdpa+mask {lib:.4f} ms; bound {b_w[0]:.4f} / "
                  f"{b_p[0]:.4f} ms ({b_w[1]}) x{per_fwd}/forward", flush=True)
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
    mirror's. Times, bound, plain and library (SDPA forward) times."""
    import torch

    wide = kernels.fused_site_wide
    rows, bad = [], []
    worst = dict(err=0.0, lse=0.0, lse_online=0.0)
    for i, (name, B, G, ch, N, Wt, per_step) in enumerate(TRAIN_SITE_SITES):
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
                ((out - ref).abs() <= SITE_P_ROUND * wabs + 1e-5).all()))
            print(f"fused_site_wide_lse {name} table std {std}: out and lse "
                  f"{'equal' if same else 'DIFFER FROM'} fused_site_lse's; "
                  f"out err {err:.3g}, lse err {e_l:.3g} (online {e_lo:.3g}) "
                  f"({'ok' if ok else 'FAIL'})", flush=True)
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
                             max_abs_err_online=e_lo, max_abs_err_out=err))
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


def check_prefetch_bias(da, kernels) -> tuple:
    """Phase 18, ``lattice_bias_wide_prefetch`` and ``lattice_bias_wide`` at
    every shape of PREFETCH_BIAS_SITES and two table scales: the prefetch
    variant equal to the wide kernel bit for bit and both to the
    whole-table one where its shared memory holds the table (the flagship's
    shapes), all within one bf16 ulp of the plain version. Times (the
    prefetch variant's as the sum of its kernel's and its pitched table
    copy's), bounds, plain times.
    Returns (prefetch record, wide record at the flagship's shapes)."""
    import torch

    fwd = kernels.lattice_bias
    rows_p, rows_w, bad = [], [], []
    worst = dict(prefetch=0.0, wide=0.0)
    for i, (name, Hs, B, G, N, Wt, per_fwd) in enumerate(PREFETCH_BIAS_SITES):
        for std in SITE_TABLE_STDS:
            table, k_pos, _ = bias_inputs(100 + i, B, G, N, Wt, Hs, std)
            args = da._kernel_args(table, k_pos, Hs, Hs)
            out_w = fwd.lattice_bias_wide_cuda(*args[:7], Hs, Hs)
            out_p = fwd.lattice_bias_wide_prefetch_cuda(*args[:7], Hs, Hs)
            whole = da.bias_route(table.shape, Hs, Hs) == "whole"
            same_whole = (not whole or torch.equal(
                fwd.lattice_bias_cuda(*args, Hs, Hs), out_w))
            rb = da.lattice_bias_plain(table.bfloat16().float(), k_pos, Hs, Hs,
                                       torch.float32).bfloat16().float()
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
            if std != SITE_TABLE_STDS[0]:
                continue
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
            b_w = bias_bounds(B, G, N, Wt, Hs, backward=False)
            extra = pitched_bytes(G, 2 * Hs - 1, Wt)
            b_p = bias_bounds(B, G, N, Wt, Hs, backward=False,
                              extra_bytes=extra)
            common = dict(site=name, plain_ms=plain, library_ms=None,
                          per_forward=per_fwd, max_abs_err=err)
            rows_p.append(dict(common, ms=ms_p, kernel_only_ms=ms_p_kernel,
                               wide_ms=ms_w, bound_ms=b_p[0],
                               bound_by=b_p[1]))
            if whole:  # the flagship's shapes (phase 14)
                rows_w.append(dict(common, ms=ms_w, bound_ms=b_w[0],
                                   bound_by=b_w[1]))
            print(f"lattice_bias_wide_prefetch {name}: {ms_p:.4f} ms (kernel "
                  f"alone {ms_p_kernel:.4f}), lattice_bias_wide {ms_w:.4f} "
                  f"ms, plain {plain:.4f} ms; bound {b_p[0]:.4f} / "
                  f"{b_w[0]:.4f} ms ({b_p[1]}) x{per_fwd}/forward",
                  flush=True)
        torch.cuda.empty_cache()
    if bad:
        fail(f"lattice_bias_wide_prefetch beyond tolerance at {bad}")
    return (dict(rows=rows_p, worst=worst["prefetch"]),
            dict(rows=rows_w, worst=worst["wide"]))


def check_fold_sites(da, kernels) -> tuple:
    """Phase 22, the folded fused sites at every shape phases 19-21 give
    them and two table scales: ``fused_site_fold_rows`` and
    ``fused_site_fold_heads`` at the serving sites (SITE_SITES) equal to
    ``fused_site`` and ``fused_site_wide_prefetch`` bit for bit, and
    ``fused_site_fold_heads_lse`` at the training sites (TRAIN_SITE_SITES)
    equal to ``fused_site_lse`` in output and logsumexp; every output within
    SITE_P_ROUND of the plain version, the logsumexp within LSE_TOL of the
    plain one. Times (a head-folded kernel's, as its prefetch sibling's, the
    sum of its kernel's and its pitched table copy's), bounds, plain and
    library times, and the sibling's time in the same call. Returns the
    records of (fused_site_fold_rows, fused_site_fold_heads,
    fused_site_fold_heads_lse)."""
    import torch

    fold, wide = kernels.fused_site_fold, kernels.fused_site_wide
    bf = torch.bfloat16
    recs = {n: dict(rows=[], worst=0.0) for n in ("rows", "heads", "lse")}
    bad = []

    def run(tag, name, B, G, ch, N, Wt, per, std, seed):
        table, k_pos, q, k, v = site_inputs(seed, B, G, ch, N, Wt, std)
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
        print(f"fold {tag} {name} table std {std}: "
              f"{'equals' if same else 'DIFFERS FROM'} {sib}; max abs err vs "
              f"plain {err:.3g}{' (lse)' if tag == 'lse' else ''}, out "
              f"{float(d_out.max()):.3g} ({'ok' if ok else 'FAIL'})",
              flush=True)
        if not ok:
            bad.append(f"{tag} {name} std {std}")
        rec = recs[tag]
        rec["worst"] = max(rec["worst"], err)
        if std != SITE_TABLE_STDS[0]:
            return
        if tag == "rows":
            ms = queued_ms(launch, 20)
            ms_sib = queued_ms(sibling, 20)
        elif tag == "heads":
            ms = queued_ms(launch, 20)
            ms_sib = queued_ms(sibling, 20)
        else:
            ms = queued_ms(launch, 20)
            ms_sib = queued_ms(sibling, 20)
        extra = 0 if tag == "rows" else pitched_bytes(G, 2 * H - 1, Wt)
        bound, by = site_bound(B, G, ch, N, Wt, extra, lse=tag == "lse")
        plain_ms = queued_ms(plain, 5)
        lib = sdpa_ms(q, k, v, bias, scale, 20)
        rec["rows"].append({
            "site": name, "ms": ms, "sibling_ms": ms_sib, "plain_ms": plain_ms,
            "library_ms": lib, "bound_ms": bound, "bound_by": by,
            ("per_step" if tag == "lse" else "per_forward"): per,
            "max_abs_err": err})
        print(f"fold {tag} {name}: kernel {ms:.4f} ms, {sib} {ms_sib:.4f} ms; "
              f"plain {plain_ms:.4f} ms sdpa+mask {lib:.4f} ms; bound "
              f"{bound:.4f} ms ({by}) x{per}/"
              f"{'step' if tag == 'lse' else 'forward'}", flush=True)

    for tag, sites in (("rows", SITE_SITES), ("heads", SITE_SITES),
                       ("lse", TRAIN_SITE_SITES)):
        for i, (name, B, G, ch, N, Wt, per) in enumerate(sites):
            for std in SITE_TABLE_STDS:
                run(tag, name, B, G, ch, N, Wt, per, std, 110 + i)
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
    cotangent entry. The kernel's float32 accumulator (zeroed, read back for
    the cast) is its design, not the function's, and is not counted."""
    win = keys * 3 * h1 * WH
    t3 = G * Y * m_max * WH
    nbytes = win * 2 + t3 * 2 + keys * 8
    ops = win if backward else 0
    by = "bytes" if nbytes / HBM_BPS >= ops / F32_FLOPS else "operations"
    return max(nbytes / HBM_BPS, ops / F32_FLOPS) * 1e3, by


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
    bf16 result within one bf16 ulp; kernel, plain, library
    (``index_select`` / ``index_add_`` of t3's rows) and bound times, the
    kernels and the library calls by ``queued_ms``. Then
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
            del acc, ref, refb, out
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
                               rel_err=e_rel))
            worst_b = max(worst_b, e_abs)
            print(f"lattice_windows_bwd {name}: float32 sums rel err "
                  f"{e_rel:.3g} (abs {e_abs:.3g}), bf16 result "
                  f"{'within' if ulp else 'BEYOND'} one ulp "
                  f"({'ok' if ok else 'FAIL'}); kernel {ms_b:.4f} ms plain "
                  f"{plain_b:.4f} ms index_add_ "
                  f"{lib_b:.4f} ms bound {bound_b:.4f} ms ({by_b}) "
                  f"x{per_bwd}/step", flush=True)
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
            seen_k = {n: sum(e.count for e in avgs if f"{n}_kernel" in e.key)
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
    56 -> 28 -> 56 at width 32 with 2 heads (head width 16, bias kernels and
    plain consumer) and depth 5, 224 x 224 images, whose SCA table at BEV 56
    (2 x 111 x 559) takes the wide kernels."""
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
    with plain_sites(da, online=True):
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
                               lattice_bias=BIAS_PER_FORWARD))
    counts = serve["counts"]

    with torch.no_grad():
        bias = check_bias(da, kernels.lattice_bias)
        site = check_site(da, kernels.fused_site)

    stamp("phase 5")
    # ---- reference: a small model through the kernels and through plain
    # PyTorch on the card. The flagship at random weights is chaotic over
    # two frames (its render moves O(1e-1) under a 1e-6 input change), a
    # 2-stage model is not. Stage 0 has head width 16 (bias kernel, views
    # one by one), stage 1 head width 4 with G=4 (fused site, views folded).
    small = Config()
    small.model = tiny_model_config(embed_dims=(32, 32, 32), n_heads=(2, 8),
                                    n_groups=(1, 4))
    ref_pipe = RegistrationPipeline(small, device="cuda", seed=2)
    sb = {k: torch.as_tensor(v) for k, v in SyntheticDataset(
        n_items=2, num_views=2, window_num_imgs=1, img_height=32,
        img_width=32, seed=3).batch(2).items()}
    kernels.reset_counts()
    out_k = ref_pipe.render(sb)
    used = kernels.counts()
    with plain_sites(da, online=True):
        out_o = ref_pipe.render(sb)
    with plain_sites(da):
        out_p = ref_pipe.render(sb)
    # the kernels against plain PyTorch that rounds as they do; the distance
    # to the plain versions (p rounded after normalising) is printed beside
    # it: it shows how far that one rounding moves this render
    d_kernel = float((out_k - out_o).abs().max())
    d_round = float((out_k - out_p).abs().max())
    print(f"small model (2 stages, f32, B=2, T=2) render, kernels {used}: max "
          f"abs diff to plain PyTorch with the kernels' roundings {d_kernel:.3g} "
          f"(tolerance {RENDER_TOL}); to the plain versions (p rounded after "
          f"normalising) {d_round:.3g}", flush=True)
    if not (used["lattice_bias"] > 0 and used["fused_site"] > 0):
        fail(f"small reference model missed a kernel: {used}")
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
    grads_wide = small_model_grads(da, kernels, fused_bwd=False, wide=True)

    stamp("phases 14-18")
    # ---- the wide-table route (ModelConfig.lattice_route="wide"): the
    # flagship's sites on the kernels that read the table through L1, then
    # on their window-prefetch variants, its training step on the wide
    # kernels, the pyramid with the prefetch bias, and each new kernel
    # alone. Every site kernel of these routes equals its sibling bit for
    # bit and the convolutions pick the same cuDNN algorithms for the same
    # shapes, so each render equals the "auto" route's exactly ----
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
    render_diff = {
        "flagship_wide": float((wide_serve.pop("render")
                                - auto_render).abs().max()),
        "flagship_wide_prefetch": float((prefetch_serve.pop("render")
                                         - auto_render).abs().max()),
        "pyramid_prefetch": float((pyr_prefetch.pop("render")
                                   - pyr_render).abs().max())}
    print(f"renders against the \"auto\" route's, same weights and batch "
          f"(max abs difference): {render_diff}", flush=True)
    if any(d != 0.0 for d in render_diff.values()):
        fail(f"a wide-route render differs from the auto route's: "
             f"{render_diff}")
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
    # sibling bit for bit, so each render equals the "auto" route's ----
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
                                      - auto_render).abs().max()),
        "flagship_fold_rows": float((fold_rows_serve.pop("render")
                                     - auto_render).abs().max())}
    print(f"folded renders against the \"auto\" route's, same weights and "
          f"batch (max abs difference): {fold_diff}", flush=True)
    if any(d != 0.0 for d in fold_diff.values()):
        fail(f"a folded render differs from the auto route's: {fold_diff}")
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
            "per_shape": data["rows"],
            **({"max_abs_err_online": data["worst_online"]}
               if "worst_online" in data else {}),
        }

    record = {"kernels": [
        entry("lattice_bias", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/lattice_bias.cu",
              "bevrender_tpu/ops/pallas/lattice_bias.py:700", bias,
              counts["lattice_bias"],
              launches_train=train_default["counts"]["lattice_bias"],
              launches_train_fused_bwd=train_fused["counts"]["lattice_bias"],
              launches_pyramid_serving=pyr_serve["counts"]["lattice_bias"],
              launches_pyramid_train=pyr_train["counts"]["lattice_bias"],
              per_shape_pyramid=pyr_bias["lattice_bias"]["rows"]),
        entry("fused_site", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site.cu",
              "bevrender_tpu/ops/pallas/fused_attn.py:637", site,
              counts["fused_site"],
              launches_train=train_default["counts"]["fused_site"],
              launches_train_fused_bwd=train_fused["counts"]["fused_site"]),
        entry("lattice_bias_bwd", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/lattice_bias_bwd.cu",
              "bevrender_tpu/ops/pallas/lattice_bias.py:829", bias_bwd,
              train_default["counts"]["lattice_bias_bwd"],
              launches_train_fused_bwd=train_fused["counts"]["lattice_bias_bwd"],
              launches_pyramid_train=pyr_train["counts"]["lattice_bias_bwd"],
              per_shape_pyramid=pyr_bias["lattice_bias_bwd"]["rows"]),
        entry("fused_site_lse", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site.cu",
              "bevrender_tpu/ops/pallas/fused_attn.py:278", site_lse,
              train_fused["counts"]["fused_site_lse"]),
        entry("fused_site_bwd", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site_bwd.cu",
              "bevrender_tpu/ops/pallas/fused_attn.py:429", site_bwd,
              train_fused["counts"]["fused_site_bwd"]),
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
              fold_heads_serve["counts"]["fused_site_fold_heads"]),
        entry("fused_site_fold_heads_lse", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site_fold_heads.cu",
              "bevrender_tpu/ops/pallas/experimental.py:560", site_heads_lse,
              fold_train["counts"]["fused_site_fold_heads_lse"]),
        entry("fused_site_fold_rows", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site_fold_rows.cu",
              "bevrender_tpu/ops/pallas/experimental.py:659", site_rows,
              fold_rows_serve["counts"]["fused_site_fold_rows"]),
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
        "small_model_grad_err": [grads_default["worst"], grads_fused["worst"]],
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
