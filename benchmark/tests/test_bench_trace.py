"""The reduction of a profiler trace on a synthetic one: kernels launched
outside the stretch are left out, busy time is the union of device
intervals, and each idle gap is named by the innermost host operation
under way when it began (a runtime call where no torch operation is)."""

import pytest

from benchmark.lib import trace


def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    X("cuda_runtime", "cudaLaunchKernel", 0, 5, 1), X("kernel", "k1", 10, 10, 1),
    X("cpu_op", "aten::add", 18, 10), X("cuda_runtime", "cudaLaunchKernel", 19, 2, 2),
    X("kernel", "k2", 30, 5, 2),                      # idle 20-30 began under aten::add
    X("cpu_op", "aten::mul", 36, 1),
    X("cuda_runtime", "cudaLaunchKernel", 34, 12, 3),  # idle 35-50 began in a bare launch
    X("kernel", "k1", 50, 5, 3),
    X("gpu_memcpy", "Memcpy DtoH", 55, 5, 3),
    X("kernel", "stray", 70, 5, 99),                  # launched before the stretch began
]


def test_reduce():
    r = trace.reduce(EVENTS)
    assert [k for k, _ in r["kernels"]] == ["k1", "k2", "k1"]
    assert r["busy_s"] == pytest.approx(25e-6)        # 10-20, 30-35, 50-60
    assert r["window_s"] == pytest.approx(50e-6)      # 10 to 60
    assert dict(r["idle_gaps"]) == pytest.approx({"aten::add": 10e-6, "cudaLaunchKernel": 15e-6})
    assert dict(r["device_ops"]) == pytest.approx({"k1": 15e-6, "k2": 5e-6})


def test_empty_trace_reads_nothing():
    assert trace.reduce([])["busy_s"] == 0.0
