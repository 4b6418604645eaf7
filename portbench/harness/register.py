"""A registration cell: ``RegistrationPipeline.register`` of the program
(render a batch of windows, embed, match against the resident tile
database, top-k) in a closed loop of one client.

Set-up builds the pipeline from the seeded weights, the database through
``build_tile_database`` from seeded tiles, ``distinct_requests`` seeded
request batches, and warms up with ``warmup_requests`` requests. The
window sends request after request, each timed from the call until its
top-k indices and distances are on the host, until ``--seconds`` have
passed. The outputs of the window's first ``check_pool`` requests are
kept; after the window ``checked_requests`` of them, drawn from the seed,
are held to the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import bounds, check, trace, traffic
from portbench.harness.device import free, peak_bytes, sync
from portbench.harness.train import flops_per_step, model_state_shapes
from portbench.harness.weights import mix, seeded_state


def run(ctx: dict) -> dict:
    from bevrender_tpu_torch.config import Config
    from bevrender_tpu_torch.inference.register import RegistrationPipeline

    tr, seed, dev, T = ctx["traffic"], ctx["seed"], ctx["device"], ctx["window"]
    B, top_k = tr["batch"], tr["top_k"]
    cfg = Config.from_json(ctx["config_text"])
    shapes = model_state_shapes(cfg)
    sd = seeded_state(ctx["model"], shapes, seed, dev,
                      traffic.windows(tr, T, tr["calibration_windows"], seed, 300,
                                      dev))
    p0 = {n: t.detach().to("cpu", copy=True) for n, t in sd.items()}
    pipe = RegistrationPipeline(cfg, sd, device=dev)
    del sd
    tiles = traffic.tiles(tr["tiles"], tr["tile"], seed, dev).cpu()
    pipe.build_tile_database(tiles, batch_size=256)
    reqs = []
    for r in range(tr["distinct_requests"]):
        batch = traffic.windows(tr, T, B, seed, 200 + r, dev)
        del batch["map"]
        reqs.append(batch)
    for i in range(tr["warmup_requests"]):
        _, idx, dist = pipe.register(reqs[i % len(reqs)], top_k=top_k)
        idx.cpu(), dist.cpu()
    sync(dev)

    lat, enq, kept = [], [], []
    t_start = time.perf_counter()
    setup_s = time.time() - ctx["t0"]
    n = 0
    while True:
        t0 = time.perf_counter()
        out, idx, dist = pipe.register(reqs[n % len(reqs)], top_k=top_k)
        t1 = time.perf_counter()
        idx_h, dist_h = idx.cpu(), dist.cpu()
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        enq.append(t1 - t0)
        if n < tr["check_pool"]:
            kept.append((n % len(reqs), out, idx_h, dist_h))
        n += 1
        if t2 - t_start >= ctx["seconds"]:
            break
    window_s = time.perf_counter() - t_start

    tr_rec = None
    if ctx["trace"]:
        tr_rec = trace.profiled(
            lambda: pipe.register(reqs[0], top_k=top_k)[1].cpu(),
            tr["profiled_requests"], ctx["cell"], dev)
    peak = peak_bytes(dev)
    flops = bound_s = None
    if ctx["trace"]:  # counted once, outside the window
        m = ctx["model"]
        flops = flops_per_step(m, shapes, B, T, False)
        bound_s = bounds.request_s(m, B, T)
    kept = [(r, o.float().cpu(), i, d) for r, o, i, d in kept]
    del pipe, out, idx, dist
    free(dev)
    pick = np.random.default_rng(mix(ctx["seed"], 31)).choice(
        len(kept), size=min(tr["checked_requests"], len(kept)), replace=False)
    return {"kind": "register", "window_s": window_s, "setup_s": setup_s,
            "units": n, "samples": n * B, "latency_s": lat, "enqueue_s": enq,
            "peak": peak, "trace": tr_rec, "flops_per_unit": flops,
            "bound_per_unit_s": bound_s, "world": 1,
            "check_inputs": {"p0": p0, "tiles": tiles,
                             "checked": [kept[int(i)] for i in sorted(pick)],
                             "requests": [{k: v.cpu() for k, v in q.items()}
                                          for q in reqs]}}


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def reference_answers(ctx: dict, inputs: dict, batch: dict,
                      db: torch.Tensor):
    """(render, top-k indices, top-k distances) of the reference on
    ``batch``, ``ref_rows`` windows at a time."""
    from portbench.reference.model import Reference, tf32_off

    dev, tr = ctx["device"], ctx["traffic"]
    w = {n: t.to(dev) for n, t in inputs["p0"].items()}
    cam, pose = batch["camera"].to(dev), batch["vehicle_pose"].to(dev)
    rows = tr["ref_rows"]
    with tf32_off(), torch.no_grad():
        ref = Reference(ctx["model"], w)
        render = torch.cat([ref.render(cam[i:i + rows], pose[i:i + rows])
                            for i in range(0, cam.shape[0], rows)])
        emb = _l2n(render.reshape(render.shape[0], -1))
        d = 2.0 - 2.0 * emb @ db.T
        neg, idx = torch.topk(-d, tr["top_k"])
    return render.cpu(), idx.cpu(), (-neg).cpu()


def own_distances(render: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """float32 distances 2 - 2 cos from each render to every tile."""
    from portbench.reference.model import tf32_off

    with tf32_off(), torch.no_grad():
        emb = _l2n(render.to(db.device).float().reshape(render.shape[0], -1))
        return (2.0 - 2.0 * emb @ db.T).cpu()


def _database(ctx, inputs) -> torch.Tensor:
    t = inputs["tiles"]
    db = torch.empty((t.shape[0], t[0].numel()), device=ctx["device"])
    for i in range(0, t.shape[0], 256):
        part = t[i:i + 256].to(ctx["device"]).reshape(-1, db.shape[1])
        db[i:i + 256] = _l2n(part)
    return db


def _reference(ctx: dict, inputs: dict, r: int, db) -> tuple:
    """The float32 reference's answers to request batch ``r``, once a run."""
    cache = inputs.setdefault("ref", {})
    if r not in cache:
        cache[r] = reference_answers(ctx, inputs, inputs["requests"][r], db)
    return cache[r]


def numbers(ctx: dict, inputs: dict) -> dict:
    db = _database(ctx, inputs)
    out = None
    for r, render, idx, dist in inputs["checked"]:
        ref = _reference(ctx, inputs, r, db)
        nums = check.register_numbers(render, idx, dist, ref[0],
                                      own_distances(render, db))
        out = nums if out is None else check.worst(out, nums)
    del db
    free(ctx["device"])
    return out
