"""Tracing and profiling hooks — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/utils/profiling.py``; the
reference's only performance artifact is a wall-clock print in its research
script (LagrangianCoherence LCS/area_of_influence.py:169,293-295):

* ``trace(log_dir)``: ``torch.profiler`` around everything inside the
  context (the card's kernels too, where there is a card), written to
  ``log_dir`` as a Chrome trace (chrome://tracing, Perfetto);
* ``StageTimer``: accumulating per-stage wall-clock timers with a summary;
* ``device_memory_stats``: each card's memory in use, its size and the
  peak, from ``torch.cuda``.
"""
from __future__ import annotations

import collections
import os
import time
from contextlib import contextmanager

import torch

from .logging import logger

__all__ = ["trace", "StageTimer", "device_memory_stats"]


@contextmanager
def trace(log_dir: str):
    """Profile everything inside the context into
    ``log_dir/trace_<pid>_<ns>.json``; yields the ``torch.profiler``
    profile (its ``key_averages()`` sums time by operator)."""
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
        path = os.path.join(log_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


class StageTimer:
    """Accumulating wall-clock stage timers.  A stage that runs on the card
    must end in a synchronisation (a copy to the host does) for its time to
    cover the device's work.

    >>> timers = StageTimer()
    >>> with timers("propagation"):
    ...     run()
    >>> timers.report()
    """

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

    def report(self) -> str:
        lines = [f"{k:30s} {self.totals[k]:9.3f}s / {self.counts[k]}x"
                 for k in sorted(self.totals, key=self.totals.get,
                                 reverse=True)]
        out = "\n".join(lines)
        logger.info("stage timings:\n%s", out)
        return out


def device_memory_stats() -> dict[str, dict]:
    """Per-card memory (bytes in use, the card's size, the peak in use)
    under the keys of the JAX package's (``bytes_in_use``,
    ``bytes_limit``, ``peak_bytes_in_use``), from PyTorch's caching
    allocator; ``{}`` without a card."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}
    return out
