"""The port's profiling and timing utilities (``bevrender_tpu_torch.utils``)
on the CPU, the step timer's statistics against the JAX package's on the
same times. Their run on the card is chip_smoke phase 29."""

import json

import numpy as np
import pytest
import torch

from bevrender_tpu.utils import profiling as jprof
from bevrender_tpu_torch import utils as tutils
from bevrender_tpu_torch.ops.kernels import build
from bevrender_tpu_torch.utils import profiling as tprof
from bevrender_tpu_torch.utils.timing import device_bench


@pytest.mark.parametrize("times,skip", [
    ([0.5, 0.1, 0.3, 0.2], 1), ([0.5, 0.1, 0.3, 0.2], 0),
    ([0.4], 1), ([0.4, 0.2], 5), ([], 1)])
def test_step_timer_stats_match_jax(times, skip):
    jt, tt = jprof.StepTimer(), tprof.StepTimer()
    jt.times, tt.times = list(times), list(times)
    assert tt.stats(skip_first=skip) == jt.stats(skip_first=skip)


def test_step_timer_times_a_block_and_waits_on_tensors():
    timer = tprof.StepTimer()
    for _ in range(3):
        x = torch.ones(64, 64)
        with timer.step({"out": [x @ x]}):
            x = x @ x
    stats = timer.stats()
    assert stats["steps"] == 2
    assert 0 < stats["min_s"] <= stats["mean_s"] <= stats["max_s"]


def test_device_bench_on_the_cpu_is_finite_and_positive():
    a = torch.randn(128, 128)
    ms = device_bench(torch.matmul, a, a, target_s=0.02, reps=2)
    assert np.isfinite(ms) and ms > 0


def test_trace_writes_a_file_with_the_annotation(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotation("port_annotation_probe"):
            torch.ones(8).add_(1)
    assert "port_annotation_probe" in [e.key for e in prof.key_averages()]
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "port_annotation_probe" for e in events)


def test_annotation_without_a_profiler_enters_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first = tprof.annotation("a")
    assert tprof.annotation("b") is first
    with tprof.annotation("c"):
        with tprof.annotation("d"):
            torch.ones(2).add_(1)


def test_annotation_under_a_profiler_is_a_named_range():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        span = tprof.annotation("port_span_probe")
        assert span is not tprof.annotation("port_span_probe")
        with span:
            torch.ones(2).add_(1)
    assert "port_span_probe" in [e.key for e in prof.key_averages()]


def test_device_memory_stats_of_the_cpu_is_none():
    assert tprof.device_memory_stats("cpu") is None
    assert tprof.device_memory_stats(torch.device("cpu")) is None


def test_compilation_cache_moves_the_kernel_build_root(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_ROOT", build.BUILD_ROOT)
    before = build.BUILD_ROOT
    tutils.enable_compilation_cache()
    assert build.BUILD_ROOT == before
    tutils.enable_compilation_cache(str(tmp_path))
    assert build.BUILD_ROOT == tmp_path
    assert build._lib_path("fused_site").parent.parent == tmp_path
