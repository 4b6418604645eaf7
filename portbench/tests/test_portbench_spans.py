"""CPU tests of the program-span readers (``harness/spans.py``) on
synthetic Chrome events, and of ``layers.py`` on the tiny cells.

    python -m pytest portbench/tests/test_portbench_spans.py -q
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from portbench import layers as player
from portbench.harness import cell as hcell
from portbench.harness import spans, trace
from portbench.tests import tiny

REPO = tiny.REPO
NEW = ("host_wait_ms.register", "host_wait_ms.train")


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# a request (0-100) holding a stage (10-60) holding a site (20-40), and a
# match (70-90); launches on the main thread and on another (the backward's)
EVENTS = [
    _x("user_annotation", trace.SPAN, 0.0, 200.0),
    _x("user_annotation", "register", 0.0, 100.0),
    _x("user_annotation", "encoder.stage0", 10.0, 50.0),
    _x("user_annotation", "site", 20.0, 20.0),
    _x("user_annotation", "register.match", 70.0, 20.0),
    _x("cuda_runtime", "cudaLaunchKernel", 12.0, 1.0, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 25.0, 1.0, corr=2),
    _x("cuda_driver", "cuLaunchKernel", 30.0, 1.0, corr=3, tid=2),
    _x("cuda_runtime", "cudaMemcpyAsync", 75.0, 1.0, corr=4),
    _x("cuda_runtime", "cudaLaunchKernel", 150.0, 1.0, corr=5),
    _x("kernel", "ln_kernel", 20.0, 4.0, corr=1),
    _x("kernel", "fused_site_kernel_8", 30.0, 10.0, corr=2),
    _x("kernel", "elementwise_kernel", 40.0, 2.0, corr=3),
    _x("gpu_memcpy", "Memcpy DtoH", 80.0, 6.0, corr=4),
    _x("kernel", "harness_kernel", 152.0, 3.0, corr=5),
    _x("kernel", "lost_kernel", 160.0, 8.0, corr=99),
    _x("gpu_memset", "Memset", 170.0, 1.0),
]


def test_an_activity_goes_to_the_spans_around_its_launch():
    rec = spans.attribute(EVENTS, 2)
    chains = {n: c for n, _, c in rec["activities"]}
    assert chains["ln_kernel"] == ("encoder.stage0", "register")
    assert chains["fused_site_kernel_8"] == ("site", "encoder.stage0",
                                             "register")
    # launched on another thread, inside the site's host interval
    assert chains["elementwise_kernel"] == ("site", "encoder.stage0",
                                            "register")
    assert chains["Memcpy DtoH"] == ("register.match", "register")
    assert chains["harness_kernel"] == ()
    assert rec["spans"] == {"register": 1, "encoder.stage0": 1, "site": 1,
                            "register.match": 1}
    got = spans.layers(rec, "register")
    assert got["site_kernel_ms"] == pytest.approx(10e-3 / 2)
    assert got["site_glue_ms"] == pytest.approx(2e-3 / 2)
    assert got["encoder_glue_ms"] == pytest.approx(4e-3 / 2)
    assert got["match_ms"] == pytest.approx(6e-3 / 2)
    assert got["backbone_ms"] == got["decoder_ms"] == 0.0
    assert got["launches_per_request"] == 2.0
    assert got["span_ms"] == pytest.approx(22e-3 / 2)
    assert got["covered"] == pytest.approx(1.0)


def test_an_activity_with_no_launching_call_is_unattributed():
    rec = spans.attribute(EVENTS, 2)
    chains = {n: c for n, _, c in rec["activities"]}
    assert chains["lost_kernel"] is None and chains["Memset"] is None
    assert spans.unattributed_ms(rec) == pytest.approx(9e-3 / 2)
    assert spans.layers(rec, "register")["unattributed_ms"] == \
        pytest.approx(9e-3 / 2)


def test_a_step_splits_into_forward_backward_optimizer():
    events = [
        _x("user_annotation", "train.forward", 0.0, 10.0),
        _x("user_annotation", "site", 2.0, 4.0),
        _x("user_annotation", "train.backward", 10.0, 10.0),
        _x("user_annotation", "train.optimizer", 20.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 3.0, 1.0, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 8.0, 1.0, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 12.0, 1.0, corr=3, tid=7),
        _x("cuda_runtime", "cudaLaunchKernel", 22.0, 1.0, corr=4),
        _x("cuda_runtime", "cudaLaunchKernel", 31.0, 1.0, corr=5),
        _x("kernel", "softmax_kernel", 5.0, 3.0, corr=1),
        _x("kernel", "conv_kernel", 9.0, 2.0, corr=2),
        _x("kernel", "lattice_bias_bwd_kernel", 13.0, 20.0, corr=3),
        _x("kernel", "adamw_kernel", 34.0, 4.0, corr=4),
        _x("kernel", "loss_item", 39.0, 1.0, corr=5),
    ]
    got = spans.layers(spans.attribute(events, 1), "train")
    assert got["forward_ms"] == pytest.approx(5e-3)
    assert got["backward_ms"] == pytest.approx(20e-3)
    assert got["optimizer_ms"] == pytest.approx(4e-3)
    assert got["site_glue_ms"] == pytest.approx(3e-3)
    assert got["covered"] == pytest.approx(29.0 / 30.0)


def _reduced(host_spans):
    events = [_x("user_annotation", trace.SPAN, 0.0, 100.0),
              _x("kernel", "a", 10.0, 10.0), _x("kernel", "b", 40.0, 10.0),
              _x("kernel", "c", 90.0, 10.0)]
    events += [_x("user_annotation", n, a, b - a) for n, a, b in host_spans]
    return trace.reduce(events, 2)


def test_host_wait_counts_the_gaps_whose_middle_is_in_the_span():
    # gaps 0-10 (middle 5), 20-40 (30), 50-90 (70)
    tr = _reduced([("register", 0.0, 35.0), ("register", 60.0, 100.0)])
    assert spans.host_wait_ms(tr, "register") == pytest.approx(
        (10.0 + 20.0 + 40.0) * 1e-3 / 2)
    tr = _reduced([("register", 25.0, 35.0)])
    assert spans.host_wait_ms(tr, "register") == pytest.approx(20e-3 / 2)
    rec = {"kind": "register", "trace": tr}
    assert hcell.reader(REPO, "host_wait_ms.register")(rec) == \
        pytest.approx(10e-3)
    assert hcell.reader(REPO, "host_wait_ms.train")(rec) is None
    tr = _reduced([("train.dispatch", 0.0, 100.0)])
    rec = {"kind": "train", "trace": tr}
    assert hcell.reader(REPO, "host_wait_ms.train")(rec) == \
        pytest.approx(70e-3 / 2)


def test_breakdown_labels_a_gap_with_the_span_open_at_its_middle():
    tr = _reduced([("register", 0.0, 35.0), ("site", 25.0, 35.0)])
    gaps = dict(trace.breakdown(tr)["idle_gaps"])
    assert gaps["site"] == pytest.approx(20e-6)
    assert gaps["register"] == pytest.approx(10e-6)
    assert gaps["host idle"] == pytest.approx(40e-6)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_reads_nothing(name):
    """The parent's program has no spans: the readers give None, and a
    trace with no device activity (the CPU) gives None too."""
    kind = name.split(".")[1]
    assert hcell.reader(REPO, name)({"kind": kind,
                                     "trace": _reduced([])}) is None
    cpu = trace.reduce([_x("user_annotation", trace.SPAN, 0.0, 10.0),
                        _x("user_annotation", "register", 1.0, 5.0),
                        _x("user_annotation", "train.dispatch", 1.0, 5.0)],
                       1)
    assert hcell.reader(REPO, name)({"kind": kind, "trace": cpu}) is None
    assert hcell.reader(REPO, name)({"kind": kind, "trace": None}) is None


@pytest.mark.parametrize("name", NEW)
def test_the_new_metrics_read_program_spans(name):
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        per_layer = json.load(f)["per_layer"]
    entry = next(m for m in per_layer if m["name"] == name)
    assert entry["source"] == "program_span" and entry["unit"] == "ms"
    assert len(entry["workloads"]) == 1


@pytest.mark.parametrize("cell,kind", [("tiny.register", "register"),
                                       ("tiny.train", "train")])
def test_layers_runs_a_tiny_cell(tmp_path, cell, kind):
    root = tiny.make_root(str(tmp_path))
    out = player.measure(cell, 7, 0.2, torch.device("cpu"), root=root)
    table = spans.REGISTER_LAYERS if kind == "register" else spans.TRAIN_LAYERS
    assert set(table) <= set(out["layers"])
    # the tiny model: T = 2 passes of 2 stages, one layer each, 2 views
    # taken one by one (G = 1): 3 sites a layer
    sites = 2 * 2 * 3
    assert out["spans"]["encoder.backbone"] == 2
    assert out["spans"]["site"] == sites
    if kind == "register":
        assert out["spans"]["register"] == tiny.REGISTER["profiled_requests"]
    else:
        assert out["spans"]["train.forward"] == 1
