"""One run of one cell, driven by data: ``BENCHMARK.json`` names the cell's
configuration, traffic and metrics, and each lives in a file of its own
that this module finds by name:

* ``portbench/configs/<config>.json``: the configuration as it is run
  (the program's ``Config`` sections; the reference reads ``model`` and
  ``train``, the window is ``data.window_num_imgs`` + 1 frames, as the
  program's datasets take it);
* ``portbench/traffic/<traffic>.json``: the traffic's sizes, with
  ``kind`` naming the driver (``train`` or ``register``);
* ``portbench/metrics/<metric>.py``: a reader, ``read(rec)``, of one
  metric from the run's record (None where it finds nothing to read);
* ``portbench/limits/<cell>.json``: the limit of each number that decides
  ``correct``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys

BANNED = ("jax", "jaxlib", "flax", "bevrender_tpu")


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(root: str, cell: str) -> dict:
    """The cell's entry, configuration, traffic and metric names."""
    bench = load_benchmark(root)
    work = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if work is None:
        raise SystemExit(f"unknown workload {cell!r}")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config_text = f.read()
    with open(os.path.join(root, "portbench", "traffic",
                           work["traffic"] + ".json")) as f:
        tr = json.load(f)
    cfg = json.loads(config_text)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return {"cell": cell, "work": work, "config_text": config_text,
            "model": cfg["model"], "train_config": cfg["train"],
            "window": cfg["data"]["window_num_imgs"] + 1, "traffic": tr, "end_to_end": e2e, "per_layer": layer}


def reader(root: str, name: str):
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics(root: str, entries: list, rec: dict) -> dict:
    out = {}
    for m in entries:
        value = reader(root, m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def result_line(ctx: dict, rec: dict, correct: bool, check_out: dict,
                device: dict) -> dict:
    root = ctx["root"]
    line = {"correct": bool(correct), "attempted": rec["units"],
            "failed": 0}
    if ctx["trace"]:
        line["metrics"] = metrics(root, ctx["per_layer"], rec)
        if rec.get("trace") is not None:
            from portbench.harness.trace import breakdown

            line["breakdown"] = breakdown(rec["trace"])
    else:
        line["metrics"] = metrics(root, ctx["end_to_end"], rec)
    line["device"] = device
    line["check"] = check_out
    return line


def dumps(line: dict) -> str:
    def fix(x):
        if isinstance(x, float) and not math.isfinite(x):
            return repr(x)
        if isinstance(x, dict):
            return {k: fix(v) for k, v in x.items()}
        if isinstance(x, list):
            return [fix(v) for v in x]
        return x
    return json.dumps(fix(line))
