"""A tiny copy of the benchmark for tests on the CPU: the harness and the
reference of this checkout with tiny configurations, traffic and limits
in a temporary root."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
REPO = os.path.dirname(PORTBENCH)

TINY_MODEL = dict(
    bev_shapes=(8, 8, 8), embed_dims=(8, 8, 8), n_stages=2, depths=(1, 1),
    n_heads=(2, 2), strides=(2, 2), n_groups=(1, 1), kernel_sizes=(3, 3),
    expansion=2, bev_depth_dim=2, num_views=2, img_height=32, img_width=32,
    ori_img_height=32, ori_img_width=40, backbone="ResNet18",
    drop_path_rate=0.2, dtype="bfloat16")
TRAIN = {"kind": "train", "why": "tiny", "batch": 4, "views": 2, "height": 32, "width": 32, "tile": 32,
         "motion_px": 4.0, "turn_rad": 0.05, "steps_per_dispatch": 2,
         "groups": 2, "checked_steps": 3, "profiled_dispatches": 1,
         "calibration_windows": 2}
REGISTER = {"kind": "register", "why": "tiny", "batch": 4, "views": 2, "height": 32, "width": 32, "tile": 32,
            "motion_px": 4.0, "turn_rad": 0.05, "tiles": 16, "top_k": 3,
            "distinct_requests": 2, "warmup_requests": 1, "check_pool": 3,
            "checked_requests": 2, "ref_rows": 2, "profiled_requests": 1,
            "calibration_windows": 2}
# limits of the tiny cells in bf16, for runs that need a result line and
# not a verdict (the float32 cells of test_portbench_runs.py are judged)
LIMITS = {"tiny.train": {"render1_gap_median": 0.05, "grad_gap_median": 0.1},
          "tiny.train.dp2": {"render1_gap_median": 0.05,
                             "grad_gap_median": 0.1},
          "tiny.register": {"render_gap_mean": 0.05, "rank_gap": 0.01}}


def model_section(**over) -> dict:
    """The tiny configuration file: windows of 2 frames."""
    from bevrender_tpu_torch.config import Config, tiny_model_config

    cfg = Config()
    cfg.model = tiny_model_config(**dict(TINY_MODEL, **over))
    d = json.loads(cfg.to_json())
    return {"model": d["model"], "data": {"window_num_imgs": 1},
            "train": d["train"]}


def make_root(tmp: str, limits: dict = None, **model_over) -> str:
    """A checkout-like root under ``tmp`` with the tiny cells."""
    root = os.path.join(tmp, "root")
    shutil.copytree(PORTBENCH, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "tiny.json"), "w") as f:
        json.dump(model_section(**model_over), f)
    for name, tr in (("tiny.train", TRAIN), ("tiny.register", REGISTER)):
        with open(os.path.join(pb, "traffic", name + ".json"), "w") as f:
            json.dump(tr, f)
    for cell, lim in (limits or LIMITS).items():
        with open(os.path.join(pb, "limits", cell + ".json"), "w") as f:
            json.dump(lim, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "tiny"})
    cells = [("tiny.train", "tiny.train", 1), ("tiny.register", "tiny.register", 1),
             ("tiny.train.dp2", "tiny.train", 2)]
    for name, traffic, chips in cells:
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": traffic, "chips": chips,
                                   "why": "tiny"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            kind = traffic.split(".")[1]
            if "workloads" in m and any(w.split(".")[1] == kind
                                        for w in m["workloads"]):
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
