"""Profiling and timing utilities.

Counterpart of :mod:`tetranerf_tpu.utils.profiling`, with the same
contract:

- :func:`trace` records a ``torch.profiler`` trace of the ``with`` block
  (the card's kernels too, where there is one) and writes it as a Chrome
  trace, ``trace.json`` under ``log_dir``.
- :func:`benchmark` measures the steady-state seconds per call of a
  function, chaining several calls between two synchronisations of the
  card (``torch.cuda.synchronize()``): one call per synchronisation would
  time the launch latency, not the work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Sequence

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU ops, and CUDA kernels where a card exists) and
    write ``log_dir/trace.json`` (viewable in ``chrome://tracing`` or
    Perfetto) when it ends; yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(fn: Callable, args_list: Sequence[tuple], warmup: int = 1,
              repeats: int = 2, host_overhead: float = 0.0,
              min_dispatches: int = 16) -> float:
    """Steady-state seconds per call of ``fn`` over the argument tuples of
    ``args_list``: the list is cycled up to ``min_dispatches`` calls, those
    calls run back to back between two synchronisations, and the best of
    ``repeats`` such runs (less ``host_overhead`` seconds) is divided by the
    call count. ``warmup`` runs of the list come first (kernel builds,
    allocator growth)."""
    reps = max(1, -(-min_dispatches // max(len(args_list), 1)))
    calls = list(args_list) * reps
    for _ in range(warmup):
        for args in args_list:
            fn(*args)
        _sync()
    best = float("inf")
    for _ in range(repeats):
        _sync()
        t0 = time.perf_counter()
        for args in calls:
            fn(*args)
        _sync()
        best = min(best, (time.perf_counter() - t0 - host_overhead) / len(calls))
    return best
