"""The device time of each layer of the program in one cell, read from the
program's spans (``harness/spans.py``).

    python3 portbench/layers.py --workload <cell> --seed <n> [--seconds 5]

Runs the cell's driver with tracing on and a short window (no check of
``correct``). After the harness's own traced span it profiles again with
each device activity joined to the call that launched it: registration
``profiled_requests`` more requests; training one eager
``Trainer.train_step`` on one step's slice of the profiled group (a graph
replay runs no Python, so its spans cannot split the step; the eager step
runs the same ``_step_body``). Prints one JSON line: the layers' device
times a unit (``spans.layers``), the program spans counted, the
``host_wait_ms`` of the harness's traced span, its idle share and length
a unit, its ``breakdown``, and the five heaviest device operations of each
innermost span.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP_OPS = 5


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _attributed(kind: str, fn, units: int, tag: str, dev) -> dict:
    from portbench.harness import spans
    from portbench.harness.device import sync

    if kind == "register":
        return spans.profiled(fn, units, tag, dev)
    env = _closure(fn)  # the harness's traced dispatch
    trainer, state, rng = env["trainer"], env["state"], env["rng"]
    one = {k: v[0] for k, v in env["groups"][0].items()}
    trainer.train_step(state, one, rng)  # the eager step's first call
    sync(dev)
    return spans.profiled(lambda: trainer.train_step(state, one, rng), 1,
                          tag, dev)


def top_ops(rec: dict) -> dict:
    """The heaviest device operations a unit (ms) of each innermost span."""
    by = {}
    for n, d, chain in rec["activities"]:
        span = "unattributed" if chain is None else (chain[0] if chain
                                                     else "outside")
        ops = by.setdefault(span, {})
        ops[n[:80]] = ops.get(n[:80], 0.0) + d * 1e-3 / rec["units"]
    return {s: sorted(([k, v] for k, v in ops.items()),
                      key=lambda kv: -kv[1])[:TOP_OPS]
            for s, ops in sorted(by.items())}


def measure(cell: str, seed: int, seconds: float, dev,
            root: str = ROOT) -> dict:
    """The cell's layers, as the line that ``main`` prints."""
    import torch

    from portbench import run
    from portbench.harness import spans, trace

    ctx = run.context(cell, seed, seconds, 1, dev, root=root)
    kind = ctx["traffic"]["kind"]
    side = {}
    harness_profiled = trace.profiled

    def profiled(fn, units, tag, dev):
        tr = harness_profiled(fn, units, tag, dev)
        side["spans"] = _attributed(kind, fn, units, tag, dev)
        return tr

    trace.profiled = profiled
    try:
        rec = run.driver(ctx).run(ctx)
    finally:
        trace.profiled = harness_profiled
    tr, sp = rec["trace"], side["spans"]
    return {"cell": cell, "seed": seed,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "layers": spans.layers(sp, kind), "spans": sp["spans"],
            "host_wait_ms": spans.host_wait_ms(
                tr, "register" if kind == "register" else "train.dispatch"),
            "idle_share": 1.0 - trace.busy_us(tr) / trace.span_us(tr),
            "traced_ms_per_unit": trace.span_us(tr) * 1e-3 / tr["units"],
            "breakdown": trace.breakdown(tr), "top_ops": top_ops(sp)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import run

    run._environment()
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(json.dumps(measure(args.workload, args.seed, args.seconds, dev)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
