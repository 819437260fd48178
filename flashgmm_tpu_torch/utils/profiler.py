"""Tracing and profiling helpers (port of flashgmm_tpu/utils/profiler.py).

``PhaseTimer`` accumulates host-clock time per named phase, waiting for
the card where the phase's result lies on it; ``trace`` records a
``torch.profiler`` trace (CPU and, when a card is present, CUDA activity)
into a directory as a Chrome trace; ``annotate`` names a function's span
in such a trace (``torch.profiler.record_function``).
"""

import contextlib
import os
import time
from collections import defaultdict

import torch


def _on_card(result) -> bool:
    """Whether a (nested) result holds a tensor on a CUDA device."""
    if isinstance(result, torch.Tensor):
        return result.is_cuda
    if isinstance(result, dict):
        return any(_on_card(v) for v in result.values())
    if isinstance(result, (list, tuple)):
        return any(_on_card(v) for v in result)
    return False


class PhaseTimer:
    """Accumulates wall time per named phase. With ``sync`` and a
    ``result`` on the card, the phase ends at a ``torch.cuda.synchronize()``
    (the card's queue drained), so it times the device's work too."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and result is not None and _on_card(result):
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self):
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": self.totals[name] / self.counts[name] * 1000,
            }
            for name in self.totals
        }

    def __str__(self):
        lines = [
            f"{name:30s} {v['mean_ms']:8.2f} ms x{v['count']}"
            for name, v in sorted(self.report().items())
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "flashgmm_trace"):
    """Record a ``torch.profiler`` trace of the block: CPU activity, and
    CUDA activity when a card is present; written to
    ``log_dir/trace.json`` (Chrome trace format, viewable in Perfetto).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Decorator naming a function's span ``name`` in a profiler trace."""

    def deco(fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco
