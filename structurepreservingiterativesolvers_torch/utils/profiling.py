"""Profiling and throughput instrumentation.

The port of the JAX package's ``utils/profiling.py`` (which replaces the
reference's hand-rolled wall-clock phase timers, reference
``solvers.py:140-146,299-314``): a context manager around ``torch.profiler``
for device traces, a wall-clock ``Stopwatch``, and throughput counters
(nnz/s, iterations/s) computed from solve metadata, with the JAX package's
formulas.

``span`` names a stretch of host work in a trace: a ``torch.profiler``
range, and on the card an NVTX range.  The graph runner
(``solvers/graphs.py``) puts one around each replay and each flag read.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the host and the card under ``torch.profiler``; the Chrome
    trace goes into ``logdir``.  Yields the profiler (``key_averages()``)."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


@contextlib.contextmanager
def span(name: str, device: torch.device):
    """A named range of host work: seen by ``torch.profiler`` and, on a CUDA
    device, by NVTX."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if cuda:
            torch.cuda.nvtx.range_pop()


class Stopwatch:
    """Wall-clock phase timer with the reference's timings-dict shape."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.marks = {}

    def mark(self, name: str):
        self.marks[name] = time.perf_counter() - self.t0
        return self.marks[name]


def spmv_throughput(nnz: int, seconds: float) -> float:
    return nnz / seconds if seconds > 0 else float("inf")


def solve_throughput(info: dict, nnz: int, seconds: float) -> dict:
    """Counters for a Krylov solve: per-iteration cost and effective nnz/s
    (each iteration reads the operator at least twice: SpMV + true
    residual)."""
    steps = max(info.get("steps", 0), 1)
    return {
        "iterations_per_s": steps / seconds,
        "spmv_nnz_per_s": 2 * steps * nnz / seconds,
        "seconds_per_iteration": seconds / steps,
    }
