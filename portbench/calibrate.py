"""Readings that set a cell's limits, each judged against the cell's limits
(``portbench/limits/<cell>.json``) as a run judges it. For each seed: the
program's numbers after a short window (``--seconds``); with
``--control``, those of the program's own bfloat16 path (the
configuration's ``dtype`` made ``bfloat16``), the control; with
``--half-batch`` (training), those of the reference whose loss is the mean
over half of each batch. Two diagnostics of training's leaves: with
``--f32-sites``, the program with its attention sites in float32 (plain
bias lerps, scores, softmax and AV in place of the site kernels); with
``--site-bf16``, the reference with its sites' operands in bfloat16. One
process for all seeds, so that the kernels build and load once; one JSON
line a seed, the readings of each side with their verdict.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 1] [--control] [--half-batch] [--f32-sites] [--site-bf16]

Not run by the benchmark's own runs.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import run  # noqa: E402

WORST_LEAVES = 5


@contextlib.contextmanager
def f32_sites():
    """The program's attention sites in float32 while inside."""
    import torch

    import bevrender_tpu_torch.ops.deform_attn as tda

    saved = tda.lattice_bias, tda.site_consumer, tda.fused_site

    def bias(table, k_pos, H, W, kernel=None):
        return tda.lattice_bias_plain(table, k_pos, H, W, torch.float32)

    def consumer(q, k, v, b, scale, keep=None, dropout_rate=0.0):
        p = torch.softmax(torch.matmul(k, q.transpose(-1, -2)) * scale + b,
                          dim=-2)
        return torch.matmul(p.transpose(-1, -2), v)

    def site(q, k, v, k_pos, table, H, W, scale, kernel=None):
        return consumer(q, k, v, bias(table, k_pos, H, W), scale)

    tda.lattice_bias, tda.site_consumer, tda.fused_site = bias, consumer, site
    try:
        yield
    finally:
        tda.lattice_bias, tda.site_consumer, tda.fused_site = saved


def program_side(ctx, mod, limits, ref_from=None, patch=None) -> tuple:
    """Run the program's cell and judge it; ``ref_from`` a record whose
    reference (same seed, same inputs) is taken instead of computing it."""
    from portbench.harness import check

    with patch or contextlib.nullcontext():
        rec = mod.run(ctx)
    inputs = rec["check_inputs"]
    if ref_from is not None:
        inputs["ref"] = ref_from["ref"]
    t = time.time()
    nums = mod.numbers(ctx, inputs)
    ok, _ = check.judge(nums, limits)
    out = {"correct": ok, "numbers": nums, "setup_s": rec["setup_s"],
           "units": rec["units"], "window_s": rec["window_s"],
           "peak_gib": rec["peak"] / 2 ** 30,
           "reference_s": time.time() - t}
    if rec["kind"] == "train":
        out["worst_leaves"] = worst_leaves(inputs["prog"], inputs)
    return out, inputs


def worst_leaves(prog: dict, inputs: dict) -> dict:
    from portbench.harness import check

    grad, change = check.leaf_gaps(prog, inputs["ref"], inputs["p0"])
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:WORST_LEAVES]  # noqa: E731
    return {"grad": top(grad), "change": top(change)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--half-batch", action="store_true")
    p.add_argument("--f32-sites", action="store_true")
    p.add_argument("--site-bf16", action="store_true")
    args = p.parse_args(argv)
    run._environment()
    import torch

    from portbench.harness import check

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        ctx = run.context(args.workload, seed, args.seconds, 0, dev,
                          t0=time.time())
        mod = run.driver(ctx)
        limits = check.load_limits(ctx["root"], ctx["cell"])
        line = {"seed": seed}
        line["program"], inputs = program_side(ctx, mod, limits)
        if args.control:
            low = json.loads(ctx["config_text"])
            low["model"]["dtype"] = "bfloat16"
            cctx = dict(ctx, config_text=json.dumps(low), t0=time.time())
            line["control"], _ = program_side(cctx, mod, limits, inputs)
        if args.f32_sites:
            fctx = dict(ctx, t0=time.time())
            line["f32_sites"], _ = program_side(fctx, mod, limits, inputs,
                                                f32_sites())
        if args.half_batch:
            nums = mod.half_batch_numbers(ctx, inputs)
            line["half_batch"] = {"correct": check.judge(nums, limits)[0],
                                  "numbers": nums}
        if args.site_bf16:
            low = mod.reference_numbers(ctx, inputs, site_bf16=True)
            nums = check.train_numbers(low, inputs["ref"], inputs["p0"])
            line["site_bf16"] = {"correct": check.judge(nums, limits)[0],
                                 "numbers": nums,
                                 "worst_leaves": worst_leaves(low, inputs)}
        line["seconds"] = time.time() - t
        print(json.dumps(line), flush=True)
        del inputs
    return 0


if __name__ == "__main__":
    sys.exit(main())
