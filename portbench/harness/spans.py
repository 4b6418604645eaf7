"""The program's spans (``bevrender_tpu_torch.utils.profiling.annotation``:
``register``, ``register.match``, ``encoder.backbone``,
``encoder.stage<s>``, ``site``, ``model.decoder``, ``train.dispatch``,
``train.replay``, ``train.forward``, ``train.backward``,
``train.optimizer``) and the device work launched inside them.

``profiled(fn, units, tag, dev)`` runs ``fn`` ``units`` times under
``torch.profiler`` and ``attribute`` reduces the Chrome trace: each
kernel, copy and fill is joined by ``args.correlation`` to the
``cuda_runtime`` or ``cuda_driver`` event that launched it, and given to
every program span, on any thread, whose host interval holds that event
(innermost first). An activity that joins no event is unattributed.
``device_ms`` sums the result by span; ``host_wait_ms`` reads the
harness's own trace (``trace.reduce``): the device's idle time inside the
spans of one name.
"""

from __future__ import annotations

import fnmatch
import json
import os
import tempfile

from portbench.harness.trace import DEVICE_CATS, PORT_KERNEL, SPAN, union

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the request's layers, each the device time launched inside the first
# pattern and inside none of the second, "kernels" the program's own
# kernels (``trace.PORT_KERNEL``) or the rest
REGISTER_LAYERS = {
    "backbone_ms": ("encoder.backbone", (), None),
    "encoder_glue_ms": ("encoder.stage*", ("site",), None),
    "site_kernel_ms": ("site", (), True),
    "site_glue_ms": ("site", (), False),
    "decoder_ms": ("model.decoder", (), None),
    "match_ms": ("register.match", (), None),
}
TRAIN_LAYERS = {
    "forward_ms": ("train.forward", (), None),
    "backward_ms": ("train.backward", (), None),
    "optimizer_ms": ("train.optimizer", (), None),
    "site_glue_ms": ("site", (), False),
}


def profiled(fn, units: int, tag: str, dev) -> dict:
    """``fn`` run ``units`` times under the profiler, attributed."""
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
    path = os.path.join(tempfile.gettempdir(), f"portbench_spans_{tag}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return attribute(events, units)


def attribute(events: list, units: int) -> dict:
    """``activities``: (name, microseconds, enclosing program spans
    innermost first, or None where no launching call joins it);
    ``spans``: each program span's name and count."""
    spans, launch, dev = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name != SPAN:
            spans.append((t0, t1, name))
        elif cat in LAUNCH_CATS and corr is not None:
            launch[corr] = t0
        elif cat in DEVICE_CATS:
            dev.append((name, t1 - t0, corr))
    # a launch may follow its activity in the file: join after the pass
    dev = [(n, d, launch.get(c)) for n, d, c in dev]
    spans.sort()
    order = sorted((t, i) for i, (_, _, t) in enumerate(dev) if t is not None)
    chains = [None] * len(dev)
    active, j = [], 0
    for t, i in order:
        while j < len(spans) and spans[j][0] <= t:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[1] >= t]
        chains[i] = tuple(s[2] for s in sorted(active,
                                               key=lambda s: s[1] - s[0]))
    count = {}
    for _, _, n in spans:
        count[n] = count.get(n, 0) + 1
    return {"units": units, "spans": count,
            "activities": [(n, d, c) for (n, d, _), c in zip(dev, chains)]}


def _inside(chain, pattern: str) -> bool:
    return any(fnmatch.fnmatchcase(n, pattern) for n in chain)


def device_ms(rec: dict, inside: str, outside=(), kernels=None) -> float:
    """Device time a unit, in ms, of the activities launched inside a span
    matching ``inside`` and inside none matching ``outside``; with
    ``kernels`` True the program's own kernels alone, False the rest."""
    us = 0.0
    for n, d, chain in rec["activities"]:
        if chain is None or not _inside(chain, inside):
            continue
        if any(_inside(chain, o) for o in outside):
            continue
        if kernels is not None and bool(PORT_KERNEL.search(n)) != kernels:
            continue
        us += d
    return us * 1e-3 / rec["units"]


def launches(rec: dict, inside: str) -> float:
    """Device activities a unit launched inside a span matching ``inside``."""
    n = sum(1 for _, _, c in rec["activities"]
            if c is not None and _inside(c, inside))
    return n / rec["units"]


def unattributed_ms(rec: dict) -> float:
    """Device time a unit of the activities that join no launching call."""
    return sum(d for _, d, c in rec["activities"] if c is None) \
        * 1e-3 / rec["units"]


def layers(rec: dict, kind: str) -> dict:
    """The layers' device times a unit, in ms, and the share they cover of
    the whole: a request's ``register`` span (``kind`` "register"), or all
    of an eager step's device time (forward, backward and optimizer)."""
    table = REGISTER_LAYERS if kind == "register" else TRAIN_LAYERS
    out = {name: device_ms(rec, *args) for name, args in table.items()}
    if kind == "register":
        whole = device_ms(rec, "register")
        parts = sum(out.values())
        out["launches_per_request"] = launches(rec, "register")
    else:
        whole = sum(d for _, d, _ in rec["activities"]) * 1e-3 / rec["units"]
        parts = sum(out[k] for k in ("forward_ms", "backward_ms",
                                     "optimizer_ms"))
    out["span_ms"] = whole
    out["covered"] = parts / whole if whole > 0 else None
    out["unattributed_ms"] = unattributed_ms(rec)
    return out


def host_wait_ms(tr: dict, name: str):
    """Idle time of the device a unit, in ms, in the gaps of the union of
    its activities (over the harness's traced span) whose middle lies in a
    program span ``name``; None where the trace has no such span or no
    device activity."""
    inside = sorted((a, b) for n, a, b in tr["host"] if n == name)
    if not inside or not tr["device"]:
        return None
    busy = union((a, b) for _, a, b in tr["device"])
    gaps, t = [], tr["span"][0]
    for a, b in busy + [[tr["span"][1], tr["span"][1]]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    idle = 0.0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        if any(c <= mid <= d for c, d in inside):
            idle += b - a
    return idle * 1e-3 / tr["units"]
