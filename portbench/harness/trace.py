"""A profiled span of the program and what the per-layer readers take
from it.

``profiled(fn, units)`` runs ``fn`` ``units`` times under
``torch.profiler`` (CPU and CUDA activity) inside one annotated range that
ends with a device synchronisation, writes the Chrome trace under the
run's ``TMPDIR``, and reduces it to plain lists: the span's start and end
(host clock of the trace, microseconds), every device activity (kernels,
copies, fills) as (name, start, end), and the host's operations as
(name, start, end) for labelling idle gaps.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

SPAN = "portbench.span"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
# the program's own kernels (csrc/*.cu) and any later ones named alike
PORT_KERNEL = re.compile(r"(lattice|site|bias|window|pitch_table)\w*_kernel")
LABELLED_GAPS = 200


def profiled(fn, units: int, tag: str, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.harness.device import sync

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            for _ in range(units):
                fn()
            sync(dev)
    path = os.path.join(tempfile.gettempdir(), f"portbench_trace_{tag}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events, units)


def reduce(events: list, units: int) -> dict:
    span, dev, host = None, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        if cat == "user_annotation" and name == SPAN:
            span = (t0, t1)
        elif cat in DEVICE_CATS:
            dev.append((name, t0, t1))
        elif cat in HOST_CATS:
            host.append((name, t0, t1))
    if span is None:
        raise RuntimeError("the profiled span is missing from the trace")
    dev = [(n, max(a, span[0]), min(b, span[1])) for n, a, b in dev
           if b > span[0] and a < span[1]]
    return {"span": span, "device": dev, "host": host, "units": units}


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(tr: dict) -> float:
    return sum(b - a for a, b in union((a, b) for _, a, b in tr["device"]))


def span_us(tr: dict) -> float:
    return tr["span"][1] - tr["span"][0]


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by what the host was doing at their middle, in seconds."""
    ops = {}
    for n, a, b in tr["device"]:
        key = n[:120]
        ops[key] = ops.get(key, 0.0) + (b - a) * 1e-6
    busy = union((a, b) for _, a, b in tr["device"])
    gaps, t = [], tr["span"][0]
    for a, b in busy + [[tr["span"][1], tr["span"][1]]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    host = sorted(tr["host"], key=lambda h: h[2] - h[1])
    idle = {}
    # the longest gaps, each labelled by the innermost host operation
    # around its middle
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]:
        mid = 0.5 * (a + b)
        label = next((n for n, c, d in host if c <= mid <= d), "host idle")
        idle[label[:120]] = idle.get(label[:120], 0.0) + (b - a) * 1e-6
    rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                            key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
