"""A training cell: ``Trainer.train_step_multi`` of the program, each
sub-step one replay of its captured CUDA graph, over seeded windows.

Set-up builds one trainer and state from the seeded weights and drives
the first ``checked_steps`` steps through ``train_step_multi`` on rows
that all differ (groups of one step: the same graph the window replays),
keeping the state before, AdamW's first moment after step 1 and the
parameters after the last. One whole group warms the grouped call; the
window then runs groups of ``steps_per_dispatch`` steps back to back,
cycling over ``groups`` seeded groups, until ``--seconds`` have passed,
and counts every optimizer step's samples over all of its time. With
several ranks each rank takes the strided rows ``r::W`` of the global
batch (as the program's loader shards it), rank 0 decides when the window
ends and every rank runs the same steps.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time

import torch

from portbench.harness import bounds, check, trace, traffic
from portbench.harness.device import peak_bytes, sync
from portbench.harness.weights import seeded_state


def _local(batch: dict, rank: int, world: int) -> dict:
    """This rank's rows of a (K, B, ...) group."""
    return {k: v[:, rank::world] for k, v in batch.items()}


def model_state_shapes(cfg) -> dict:
    from bevrender_tpu_torch.models.bevrender import BEVRenderNet

    with torch.device("meta"):
        net = BEVRenderNet(cfg.model)
    return {n: (tuple(t.shape), t.dtype) for n, t in net.state_dict().items()}


def flops_per_step(m: dict, shapes: dict, rows: int, window: int,
                   training: bool) -> float:
    """Model FLOPs of one step (training: forward and backward) or one
    request over ``rows`` windows, counted by ``FlopCounterMode`` over the
    reference on the meta device: products and convolutions, no recompute."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.model import Reference, param_names

    mm = dict(m, drop_path_rate=0.0)
    with torch.device("meta"):
        w = {n: torch.zeros(s, dtype=dt) for n, (s, dt) in shapes.items()}
        ref = Reference(mm, w, remat=False)
        V, H, W = m["num_views"], m["img_height"], m["img_width"]
        cam = torch.zeros((rows, window, V, H, W, 3))
        pose = torch.zeros((rows, window, 3))
        names = param_names(w)
        with FlopCounterMode(display=False) as fc:
            if training:
                for n in names:
                    w[n].requires_grad_(True)
                out = ref.render(cam, pose, training=True)
                loss = torch.mean((out - torch.zeros_like(out)) ** 2)
                torch.autograd.grad(loss, [w[n] for n in names],
                                    allow_unused=True)
            else:
                with torch.no_grad():
                    ref.render(cam, pose)
    return float(fc.get_total_flops())


def run(ctx: dict) -> dict:
    """Run the cell; returns the record the result line is made from."""
    from bevrender_tpu_torch.config import Config
    from bevrender_tpu_torch.training.trainer import Trainer

    tr, seed, dev, T = ctx["traffic"], ctx["seed"], ctx["device"], ctx["window"]
    rank, world = ctx["rank"], ctx["world"]
    K, B = tr["steps_per_dispatch"], tr["batch"]
    cfg = Config.from_json(ctx["config_text"])
    cfg.train.steps_per_dispatch = K
    cfg.train.batch_size = B
    cfg.train.work_dir = os.path.join(tempfile.gettempdir(), "portbench_work")
    shapes = model_state_shapes(cfg)
    sd = seeded_state(ctx["model"], shapes, seed, dev,
                      traffic.windows(tr, T, tr["calibration_windows"], seed, 300,
                                      dev))
    p0 = {n: t.detach().to("cpu", copy=True) for n, t in sd.items()}
    glob = [traffic.windows(tr, T, K * B, seed, 100 + g, dev)
            for g in range(tr["groups"])]
    glob = [{k: v.reshape((K, B) + v.shape[1:]) for k, v in g.items()}
            for g in glob]
    groups = [_local(g, rank, world) for g in glob]
    n_check = tr["checked_steps"]
    check_rows = None
    if rank == 0:
        check_rows = [{k: v.cpu() for k, v in
                       traffic.rows(glob[i // K], i % K).items()}
                      for i in range(n_check)]
    del glob

    trainer = Trainer(cfg, None, device=dev)
    state = trainer.create_state(state_dict=sd)
    del sd
    names = [n for n, _ in state.net.named_parameters()]
    params = dict(state.net.named_parameters())
    rng = seed
    losses, grad1 = [], None
    for i in range(n_check):
        one = {k: v[i % K:i % K + 1] for k, v in groups[i // K].items()}
        state, metrics, render = trainer.train_step_multi(state, one, rng)
        losses.append(float(metrics["train_batch_loss"][0]))
        if i == 0:
            render1 = render.float().cpu()
        if i == 0:
            # AdamW's first moment after one step is 0.1 the clipped
            # gradient (none where the optimizer never took it)
            moments = state.optimizer.state
            grad1 = {n: (moments[params[n]]["exp_avg"] / 0.1).cpu()
                     if "exp_avg" in moments.get(params[n], {})
                     else torch.zeros(params[n].shape) for n in names}
    p_end = {n: params[n].detach().to("cpu", copy=True) for n in names}
    capture_s = getattr(trainer.step_graph, "capture_s", None)
    state, _, _ = trainer.train_step_multi(state, groups[0], rng)
    sync(dev)

    flag = torch.zeros(1, device=dev)
    t_start = time.perf_counter()
    setup_s = time.time() - ctx["t0"]
    steps, g = 0, 0
    while True:
        state, _, _ = trainer.train_step_multi(state, groups[g], rng)
        steps += K
        g = (g + 1) % len(groups)
        if world > 1:
            flag.fill_(float(rank == 0 and time.perf_counter() - t_start
                             >= ctx["seconds"]))
            torch.distributed.all_reduce(flag)
            if float(flag) > 0:
                break
        else:
            sync(dev)
            if time.perf_counter() - t_start >= ctx["seconds"]:
                break
    sync(dev)
    window_s = time.perf_counter() - t_start

    tr_rec = None
    if ctx["trace"]:
        tr_rec = trace.profiled(
            lambda: trainer.train_step_multi(state, groups[0], rng),
            tr["profiled_dispatches"], f"{ctx['cell']}_{rank}", dev)
        tr_rec["units"] *= K
    peak = peak_bytes(dev)
    flops = bounds_s = None
    if ctx["trace"]:  # counted once, outside the window
        m = ctx["model"]
        flops = flops_per_step(m, shapes, B, T, True)
        bounds_s = bounds.step_s(m, B // world, T)

    del trainer, state, params, groups
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec = {"kind": "train", "window_s": window_s, "setup_s": setup_s,
           "units": steps, "samples": steps * B, "peak": peak,
           "trace": tr_rec, "flops_per_unit": flops,
           "bound_per_unit_s": bounds_s, "capture_s": capture_s,
           "world": world}
    if rank == 0:
        rec["check_inputs"] = {"prog": {"losses": losses, "grad1": grad1,
                                        "p_end": p_end, "render1": render1},
                               "p0": p0, "rows": check_rows, "rng": rng}
    return rec


def reference_numbers(ctx: dict, inputs: dict, site_bf16: bool = False,
                      loss_rows=None) -> dict:
    """The reference's steps from the seeded state on the checked rows
    (``loss_rows``: the loss over those rows alone, a planted fault;
    ``site_bf16``: the sites' operands rounded to bfloat16, a diagnostic)."""
    from portbench.reference.model import Reference, mask_seed, tf32_off, train_steps

    dev = ctx["device"]
    tc = ctx["train_config"]
    w = {n: t.to(dev).clone() for n, t in inputs["p0"].items()}
    batches = [{k: v.to(dev) for k, v in b.items()} for b in inputs["rows"]]
    seeds = [mask_seed(inputs["rng"], i) for i in range(len(batches))]
    with tf32_off():
        ref = Reference(ctx["model"], w, site_bf16=site_bf16)
        losses, grad1, render1 = train_steps(
            ref, batches, seeds, tc["learning_rate"], tc["weight_decay"],
            tc["eps"], tc["grad_clip_norm"], loss_rows=loss_rows)
    names = list(inputs["prog"]["grad1"])
    out = {"losses": losses, "grad1": {n: grad1[n].cpu() for n in names},
           "p_end": {n: w[n].cpu() for n in names},
           # rank 0's rows of the global batch, the render it returns
           "render1": render1[::ctx["world"]]}
    del ref, w
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _reference(ctx: dict, inputs: dict) -> dict:
    """The float32 reference's steps, once a run."""
    if "ref" not in inputs:
        inputs["ref"] = reference_numbers(ctx, inputs)
    return inputs["ref"]


def numbers(ctx: dict, inputs: dict) -> dict:
    return check.train_numbers(inputs["prog"], _reference(ctx, inputs),
                               inputs["p0"])


def site_bf16_numbers(ctx: dict, inputs: dict) -> dict:
    """The reference with its sites' operands in bfloat16, put in the
    program's place: how far the sites' rounding alone moves the numbers."""
    low = reference_numbers(ctx, inputs, site_bf16=True)
    return check.train_numbers(low, _reference(ctx, inputs), inputs["p0"])


def half_batch_numbers(ctx: dict, inputs: dict) -> dict:
    """A planted fault: the reference whose loss is the mean over the first
    half of each batch, the rest left out, put in the program's place."""
    b = inputs["rows"][0]["camera"].shape[0]
    low = reference_numbers(ctx, inputs, loss_rows=slice(0, max(1, b // 2)))
    return check.train_numbers(low, _reference(ctx, inputs), inputs["p0"])

