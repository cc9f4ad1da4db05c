"""Profiling hooks (the port's counterpart of
`uni_encoder_tpu/utils/profiling.py`).

Capability spec: SURVEY.md §5 (tracing/profiling): the reference has
wall-clock throughput and fvcore FLOP counting only. Here `trace` captures
a torch.profiler trace of the host and the card (a Chrome trace, viewable in
Perfetto or chrome://tracing), `Timer` aggregates section wall-clock times
and `annotate` names a range in the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of what runs inside, host and CUDA activity, into
    `log_dir/trace.json`: `with trace('/tmp/trace'): run_steps()`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Section wall-clock aggregation; `block_on` (a tensor, or tensors)
    makes the section wait for its device's work to finish."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, block_on: Optional[object] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            mean = self.totals[k] / max(self.counts[k], 1)
            lines.append(f"{k:40s} total {self.totals[k]:8.3f}s  mean {mean*1e3:8.2f}ms  n={self.counts[k]}")
        return "\n".join(lines)


def _synchronize(x) -> None:
    """Wait for the CUDA devices of the tensors in `x` (nothing for CPU
    tensors, whose work is done when they are returned)."""
    tensors = x if isinstance(x, (list, tuple)) else [x]
    for device in {t.device for t in tensors if torch.is_tensor(t) and t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


def annotate(name: str):
    """A named range in a trace: a context manager and a decorator
    (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)
