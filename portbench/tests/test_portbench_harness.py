"""CPU tests of the benchmark's harness: the data files resolve by name,
the trace and latency arithmetic, the imports, and whole tiny runs.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.harness import cell as hcell
from portbench.harness import trace
from portbench.tests import tiny

REPO = tiny.REPO
PORTBENCH = tiny.PORTBENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


BENCH = _bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    ctx = hcell.resolve(REPO, cell)
    assert ctx["traffic"]["kind"] in ("train", "register")
    assert ctx["model"]["n_stages"] == len(ctx["model"]["depths"])
    assert os.path.exists(os.path.join(PORTBENCH, "limits", cell + ".json"))
    assert ctx["end_to_end"] and ctx["per_layer"]
    assert "setup_s" in [m["name"] for m in ctx["end_to_end"]]


@pytest.mark.parametrize("name", METRICS)
def test_metric_has_a_reader(name):
    assert callable(hcell.reader(REPO, name))


def test_benchmark_keeps_to_its_contract():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + METRICS
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    assert len(json.dumps(BENCH)) < 64 << 10


def test_a_traffic_file_added_is_found_by_name(tmp_path):
    root = tiny.make_root(str(tmp_path))
    tr = dict(tiny.TRAIN, batch=6)
    with open(os.path.join(root, "portbench", "traffic", "train.b6.json"),
              "w") as f:
        json.dump(tr, f)
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny.train.b6", "config": "tiny",
                               "traffic": "train.b6", "chips": 1,
                               "why": "added"})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    ctx = hcell.resolve(root, "tiny.train.b6")
    assert ctx["traffic"]["batch"] == 6
    # a metric listed for no workload is reported in every cell
    assert {m["name"] for m in ctx["end_to_end"]} == {"setup_s"}
    assert ctx["window"] == 2


def test_idle_share_is_one_minus_the_union():
    events = [{"ph": "X", "cat": "user_annotation", "name": trace.SPAN,
               "ts": 0.0, "dur": 100.0},
              {"ph": "X", "cat": "kernel", "name": "a", "ts": 10.0, "dur": 30.0},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 20.0, "dur": 30.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 90.0,
               "dur": 20.0},
              {"ph": "X", "cat": "cpu_op", "name": "host_op", "ts": 50.0,
               "dur": 40.0}]
    tr = trace.reduce(events, 2)
    assert trace.busy_us(tr) == pytest.approx(50.0)  # 10-50 and 90-100
    rec = {"kind": "train", "trace": tr}
    idle = hcell.reader(REPO, "idle_share.train")(rec)
    assert idle == pytest.approx(50.0)
    assert hcell.reader(REPO, "idle_share.register")(rec) is None
    br = trace.breakdown(tr)
    assert br["idle_gaps"][0] == ["host_op", pytest.approx(40e-6)]


def test_p90_is_over_every_request():
    lat = [0.1] * 90 + [1.0] * 10
    rec = {"kind": "register", "latency_s": lat}
    p90 = hcell.reader(REPO, "register_ms_p90")(rec)
    assert 100.0 < p90 < 1000.0
    rec["latency_s"] = [0.1] * 100
    assert hcell.reader(REPO, "register_ms_p90")(rec) == pytest.approx(100.0)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    base = os.path.join(PORTBENCH, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in hcell.BANNED, (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in hcell.BANNED + ("bevrender_tpu_torch",), (path, mod)
            assert not mod.startswith("portbench.harness"), (path, mod)


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh interpreter, then its modules' top-level
    names, compared whole."""
    root = tiny.make_root(str(tmp_path))
    code = (
        "import sys, io, torch\n"
        f"sys.path[:0] = [{root!r}, {REPO!r}]\n"
        "from portbench import run\n"
        f"ctx = run.context('tiny.register', 3, 0.2, 0, torch.device('cpu'), root={root!r})\n"
        "assert run.run_rank(ctx, out=io.StringIO()) == 0\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert "bevrender_tpu_torch" in tops
    assert not set(tops) & set(hcell.BANNED)
