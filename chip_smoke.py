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
   RENDER_TOL.

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

N_REQUESTS = 50
FUSED_PER_FORWARD = 24
BIAS_PER_FORWARD = 64
BIAS_ULP = 2.0 ** -7   # one bf16 ulp of x is at most |x| * 2^-7
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
    """Device time per call: the CUDA kernels whose name contains
    ``match`` (all kernels when empty), summed by the profiler over
    ``iters`` calls. Falls back to CUDA events when the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if match in e.key)
    return us / iters / 1e3 if us > 0 else events_ms(fn, iters)


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
        ms = device_ms(launch, 20, "lattice_bias_kernel")
        ev = events_ms(launch, 20)
        plain = device_ms(lambda: da.lattice_bias_plain(tb, k_pos, H, W,
                                                        torch.float32), 5)
        out_bytes = B * G * HPG * N * H * W * 2
        nbytes = out_bytes + table.numel() * 2 + B * G * N * 16 + W * 8
        ops = B * G * HPG * N * H * W * 12  # phi, floor, frac, 3 lerps x 3
        bound = max(nbytes / HBM_BPS, ops / F32_FLOPS) * 1e3
        by = "bytes" if nbytes / HBM_BPS >= ops / F32_FLOPS else "operations"
        rows.append(dict(site=name, ms=ms, events_ms=ev, plain_ms=plain,
                         bound_ms=bound, bound_by=by, per_forward=per_fwd,
                         max_abs_err=float(err.max())))
        print(f"lattice_bias {name}: max_abs_err {float(err.max()):.3g} "
              f"kernel {ms:.4f} ms (events {ev:.4f}) plain {plain:.4f} ms "
              f"bound {bound:.4f} ms "
              f"({by}) x{per_fwd}/forward", flush=True)
    return dict(rows=rows, worst=worst)


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
    import torch.nn.functional as F

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
        ms = device_ms(launch, 20, "fused_site_kernel")
        ev = events_ms(launch, 20)
        plain = device_ms(lambda: da.site_plain(q, k, v, k_pos, tb, H, W,
                                                scale, torch.float32), 5)
        # yardstick: PyTorch's attention with the bias given as a mask (the
        # bias is computed beforehand and not timed)
        bf = torch.bfloat16
        bias = da.lattice_bias_plain(tb, k_pos, H, W, torch.float32)
        mask = bias.transpose(-1, -2).to(bf).reshape(-1, H * W, N).contiguous()
        qs, ks, vs = (x.to(bf).reshape(-1, x.shape[-2], ch) for x in (q, k, v))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale), 20)
        pairs = B * G * HPG * H * W * N
        nbytes = ((q.numel() + k.numel() + v.numel()) * 2 + table.numel() * 2
                  + B * G * N * 16 + W * 8 + q.numel() * 4)
        # bf16 products (QK, AV) at the tensor-core rate; bias lerps, score,
        # running max, exp and sum in float32 (18 per pair)
        t_ops = pairs * 4 * ch / BF16_FLOPS + pairs * 18 / F32_FLOPS
        bound = max(nbytes / HBM_BPS, t_ops) * 1e3
        by = "bytes" if nbytes / HBM_BPS >= t_ops else "operations"
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
    the kernels are (bf16-rounded table, float32 lerps, bf16 bias). The
    fused sites take ``site_consumer`` (p rounded after normalising, as the
    JAX package's ``_site_xla``) or, with ``online``, the kernel's own
    roundings (``site_consumer_online``)."""
    import torch

    def bias(t, p, h, w):
        tb = t.bfloat16().float()
        return da.lattice_bias_plain(tb, p, h, w, torch.float32).bfloat16()

    def site(q, k, v, p, t, h, w, scale):
        tb = t.bfloat16().float()
        b = da.lattice_bias_plain(tb, p, h, w, torch.float32)
        consumer = da.site_consumer_online if online else da.site_consumer
        return consumer(q, k, v, b, scale)

    saved = da.lattice_bias, da.fused_site
    da.lattice_bias, da.fused_site = bias, site
    try:
        yield
    finally:
        da.lattice_bias, da.fused_site = saved


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
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {regs[0] if regs else 'cached'}", flush=True)

    # ---- main path: flagship bf16 render+register, B=4, T=2 ----
    cfg = flagship_config(dtype="bfloat16")
    B = 4
    pipe = RegistrationPipeline(cfg, device="cuda", seed=0)
    ds = SyntheticDataset(n_items=B, num_views=cfg.model.num_views,
                          window_num_imgs=1, img_height=224, img_width=224)
    batch = {k: torch.as_tensor(v) for k, v in ds.batch(B).items()}
    rng = torch.Generator().manual_seed(1)
    tiles = torch.rand(64, 224, 224, 3, generator=rng).numpy()
    db = pipe.build_tile_database(list(tiles), batch_size=32)
    if tuple(db.shape) != (64, 224 * 224 * 3):
        fail(f"tile database shape {tuple(db.shape)}")
    pipe.register(batch, top_k=10)  # warm-up request (cuDNN autotune, ...)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(N_REQUESTS + 1)]
    cpu0 = time.process_time()
    marks[0].record()
    for i in range(N_REQUESTS):
        render, idx, dist = pipe.register(batch, top_k=10)
        marks[i + 1].record()
    marks[-1].synchronize()
    host_cpu_ms = (time.process_time() - cpu0) * 1e3 / N_REQUESTS
    counts = kernels.counts()
    req_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    total_ms = marks[0].elapsed_time(marks[-1])
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"fused_site": FUSED_PER_FORWARD * N_REQUESTS,
            "lattice_bias": BIAS_PER_FORWARD * N_REQUESTS}
    print(f"main path launches over {N_REQUESTS} requests: {counts} "
          f"(expected {want})", flush=True)
    if counts != want:
        fail(f"launch counts {counts} != {want}")
    if tuple(render.shape) != (B, 224, 224, 3) or not bool(
            torch.isfinite(render.float()).all()):
        fail(f"render shape {tuple(render.shape)} or non-finite values")
    if tuple(idx.shape) != (B, 10) or tuple(dist.shape) != (B, 10):
        fail(f"top-k shapes {tuple(idx.shape)} {tuple(dist.shape)}")
    if not bool(((idx >= 0) & (idx < 64)).all()) or not bool(
            (dist[:, 1:] >= dist[:, :-1]).all()):
        fail("top-k indices out of range or distances not ascending")
    ms = total_ms / N_REQUESTS
    q = statistics.quantiles(req_ms, n=20)
    print(f"render+register flagship bf16 B={B} T=2: {N_REQUESTS} requests "
          f"back to back in {total_ms:.3f} ms, {ms:.3f} ms/request, "
          f"{B / ms * 1e3:.2f} frames/s; per request min {min(req_ms):.3f} "
          f"median {statistics.median(req_ms):.3f} p95 {q[-1]:.3f} max "
          f"{max(req_ms):.3f} ms; host CPU {host_cpu_ms:.3f} ms/request; "
          f"peak {peak_gb:.3f} GiB [{card}]", flush=True)
    from torch.profiler import ProfilerActivity, profile

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
            for n in ("fused_site", "lattice_bias")}
    print(f"device time of one request (profiler, median of 3: "
          f"{[round(r[0], 3) for r in profiled]}): busy {busy:.3f} ms of "
          f"{ms:.3f} ms/request, idle share {idle:.3f}; kernel launches "
          f"seen {seen}", flush=True)
    for e in avgs[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:100]}", flush=True)
    del pipe, render, idx, dist, db
    torch.cuda.empty_cache()

    with torch.no_grad():
        bias = check_bias(da, kernels.lattice_bias)
        site = check_site(da, kernels.fused_site)

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

    def entry(name, route, src, replaces, data, launches):
        top = max(data["rows"], key=lambda r: r["per_forward"] * r["ms"])
        return {
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
              counts["lattice_bias"]),
        entry("fused_site", "cuda",
              "bevrender_tpu_torch/ops/kernels/csrc/fused_site.cu",
              "bevrender_tpu/ops/pallas/fused_attn.py:637", site,
              counts["fused_site"]),
    ], "card": card, "build_s": build_s, "requests": N_REQUESTS,
        "request_ms": ms, "request_ms_min": min(req_ms),
        "request_ms_max": max(req_ms), "host_cpu_ms": host_cpu_ms,
        "frames_per_s": B / ms * 1e3,
        "peak_gib": peak_gb, "busy_ms": busy, "idle_share": idle,
        "render_diff_online": d_kernel, "render_diff_plain": d_round}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    os.chdir(HERE)
    main()
