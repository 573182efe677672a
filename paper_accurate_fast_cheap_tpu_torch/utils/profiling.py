"""Tracing, profiling and memory observability (port of the JAX
``utils/profiling.py``): a ``torch.profiler`` trace, named ranges
(``torch.profiler.record_function``), the card's memory in MB under JAX's
keys, a background host-RSS monitor and a wall-clock step timer.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the host and the card (when present):
    ``with trace('prof'): step()`` writes ``prof/trace.json`` (Chrome trace
    format) and yields the profiler for ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range in profiler traces."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> Dict[str, float]:
    """The card's memory in MB: in use, the peak since the last
    ``torch.cuda.reset_peak_memory_stats`` (``peak_bytes_in_use_mb``) and
    the caching allocator's reservation.  Empty without a CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    mb = 1024 * 1024
    return {
        "bytes_in_use_mb": torch.cuda.memory_allocated(dev) / mb,
        "peak_bytes_in_use_mb": torch.cuda.max_memory_allocated(dev) / mb,
        "bytes_reserved_mb": torch.cuda.memory_reserved(dev) / mb,
    }


class MemoryMonitor:
    """Background max-RSS tracker of this process (MB)."""

    def __init__(self, interval_s: float = 1.0):
        self.interval_s = interval_s
        self.max_rss_mb = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self):
        import resource

        while not self._stop.is_set():
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
            self.max_rss_mb = max(self.max_rss_mb, rss)
            self._stop.wait(self.interval_s)

    def __enter__(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


class StepTimer:
    """Wall-clock timing with warmup exclusion and RTF.  The measured block
    must end in ``torch.cuda.synchronize()`` (or a host copy) when it
    launches work on the card: launches return before the card is done."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def mean(self, skip_warmup: int = 1) -> float:
        xs = self.times[skip_warmup:] or self.times
        return sum(xs) / max(len(xs), 1)

    def rtf(self, audio_seconds: float, skip_warmup: int = 1) -> float:
        return self.mean(skip_warmup) / max(audio_seconds, 1e-9)
