"""Profiling and step-time observability (counterpart of
``vsearch_tpu/utils/profiling.py``): a ``torch.profiler`` trace of a
block, the card's memory counters, and the rolling step-time / throughput
counter that the serving layer reports in ``/stats``.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import deque
from typing import Deque, Dict, Optional

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False, *,
          device="cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed block (host ops,
    and the card's kernels unless ``device="cpu"``) and write it to
    ``log_dir`` as a Chrome trace (``trace.json``, viewable in Perfetto).
    Yields the profiler, whose ``key_averages()`` give time by kernel.
    ``create_perfetto_link`` is accepted and unused: the file opens in
    Perfetto as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..device import resolve_device

    acts = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if ProfilerActivity.CUDA in acts:
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Live, peak and total bytes of each CUDA device, from
    ``torch.cuda.memory_stats`` (the caching allocator's counters) and
    ``torch.cuda.mem_get_info``. Raises without CUDA."""
    import torch

    from ..device import resolve_device

    resolve_device("cuda")
    stats: Dict[str, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        m = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": m.get("allocated_bytes.all.current", -1),
            "peak_bytes_in_use": m.get("allocated_bytes.all.peak", -1),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
    return stats


class StepTimer:
    """Rolling step-time / throughput counter.

    Usage::

        timer = StepTimer(window=100)
        for batch in data:
            with timer.step(items=len(batch)):
                run(batch)
        print(timer.summary())
    """

    def __init__(self, window: int = 100):
        self.window = window
        self.times: Deque[float] = deque(maxlen=window)
        self.items: Deque[int] = deque(maxlen=window)
        self.total_steps = 0
        self.total_items = 0
        self._t0: Optional[float] = None

    @contextlib.contextmanager
    def step(self, items: int = 1):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.times.append(dt)
        self.items.append(items)
        self.total_steps += 1
        self.total_items += items

    def summary(self) -> Dict[str, float]:
        # snapshot first: another thread (the serve dispatcher) appends
        # concurrently, and iterating a deque during mutation raises
        # RuntimeError
        for _ in range(8):
            try:
                times = list(self.times)
                items = list(self.items)
                break
            except RuntimeError:
                continue
        else:  # pragma: no cover - pathological contention
            return {}
        if not times:
            return {}
        ts = sorted(times)
        n = len(ts)
        total = sum(times)
        return {
            "steps": self.total_steps,
            "mean_s": total / n,
            "p50_s": ts[n // 2],
            "p99_s": ts[min(n - 1, int(n * 0.99))],
            "items_per_s": sum(items) / total if total else 0.0,
        }

    def log(self, prefix: str = "steps"):
        s = self.summary()
        if s:
            logger.info(
                "%s: mean=%.1f ms p50=%.1f ms p99=%.1f ms "
                "throughput=%.1f items/s", prefix, 1e3 * s["mean_s"],
                1e3 * s["p50_s"], 1e3 * s["p99_s"], s["items_per_s"])
