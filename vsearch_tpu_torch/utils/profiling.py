"""Profiling and step-time observability (counterpart of
``vsearch_tpu/utils/profiling.py``): a ``torch.profiler`` trace of a
block, the card's memory counters, the rolling step-time / throughput
counter that the serving layer reports in ``/stats``, and the tracer
(``TRACER``) whose spans split each device call of the serving path.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger(__name__)

_perf_ns = time.perf_counter_ns


class _Record(dict):
    """A device call's record (``Tracer``): seconds a span path, and in
    ``counts`` the numbers ``Tracer.count`` entered a path (such as each
    encoder forward's real and padding tokens). A reader of the seconds
    sees a plain dict."""

    __slots__ = ("counts",)

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, int] = {}


class _Span:
    """One open span; see ``Tracer``."""

    __slots__ = ("_tracer", "_stack", "name", "path", "root", "call", "rec",
                 "labels", "t0", "_rf")

    def __init__(self, tracer: "Tracer", name: str, root: bool = False,
                 labels: Optional[Dict] = None):
        self._tracer = tracer
        self.name = name
        self.root = root
        self.labels = labels

    def __enter__(self) -> "_Span":
        stack = self._stack = self._tracer._local.stack
        if self.root:
            self.path = self.name
            self.call = next(self._tracer._ids)
            self.rec: Optional[Dict[str, float]] = _Record()
        elif stack:
            parent = stack[-1]
            self.path = (self.name if parent.root
                         else f"{parent.path}/{self.name}")
            self.call, self.rec = parent.call, parent.rec
        else:
            self.path, self.call, self.rec = self.name, None, None
        stack.append(self)
        # set while a torch.profiler records, whichever thread started it
        # (``torch._C._autograd._profiler_enabled()`` reads False under
        # the Kineto profiler)
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self._label())
            self._rf.__enter__()
        else:
            self._rf = None
        self.t0 = _perf_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = _perf_ns() - self.t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._stack.pop()
        path, rec = self.path, self.rec
        if rec is not None and not self.root:
            rec[path] = rec.get(path, 0.0) + dt * 1e-9
        tot = self._tracer.totals.get(path)
        if tot is None:
            tot = self._tracer.totals.setdefault(path, [0, 0])
        tot[0] += 1
        tot[1] += dt

    def _label(self) -> str:
        """The span's name in a profiler trace: its path, ``#`` and its
        call's id, and a root's labels (the trace keeps no arguments of a
        ``record_function``, so they go in the name)."""
        if self.call is None:
            return self.path
        out = f"{self.path}#{self.call}"
        if self.labels:
            out += "".join(f" {k}={v}" for k, v in self.labels.items())
        return out


# ``Tracer.call`` inside a call already open: no new record
_NO_CALL = contextlib.nullcontext()


class _OpenSpans(threading.local):
    """Each thread's stack of open spans, innermost last."""

    def __init__(self):
        self.stack: List[_Span] = []


class Tracer:
    """Spans on ``time.perf_counter_ns`` at the layer boundaries of the
    serving path, and the call record of each device call.

    ``call(name)`` opens the root span of a device call (the coalescer's
    ``serve/call``, or ``Retriever.retrieve``'s ``retrieve`` when no call
    is open on the thread; inside an open call it opens nothing). Every
    ``span(name)`` nests under the thread's innermost open span, so the
    encoder's ``tokenize`` lands under ``query_embed`` or ``rerank``,
    whichever stage called it, and belongs to the call of its root. The
    call's record maps each span's path below the root (``<stage>``,
    ``<stage>/<child>``, ...) to its seconds, repeated spans summed; the
    root itself is not in it. ``record()`` is the thread's open record.
    Its ``counts`` hold what ``count(name, n)`` entered, summed by path
    (``<span path>/<name>``), apart from the seconds.

    ``totals`` holds, per path, the spans closed (or the count given to
    ``add``) and their nanoseconds since the process started, including
    spans outside any call (such as ``serve/select``, or an embed of
    ``/embed``), under their own name. One dict update a span and no
    lock: the serving path's spans all close on the dispatcher thread.

    While a ``torch.profiler`` records, each span also enters a
    ``record_function`` named ``<path>#<call id>`` (a root adds its
    labels), so the spans lie in the profiler's trace on their thread
    beside the kernels they launch. Otherwise no ``record_function`` is
    entered: one costs ~12 µs even with no profiler.
    """

    def __init__(self):
        self._local = _OpenSpans()
        self._ids = itertools.count(1)
        self.totals: Dict[str, List[int]] = {}

    def call(self, name: str, **labels):
        """The root span of a device call and its record, or nothing when
        a call is open on this thread."""
        stack = self._local.stack
        if stack and stack[-1].rec is not None:
            return _NO_CALL
        return _Span(self, name, root=True, labels=labels)

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def add(self, name: str, ns: int, count: int = 1) -> None:
        """Enter ``ns`` nanoseconds measured elsewhere (``count`` of them,
        summed) as a span ``name`` under the innermost open span."""
        stack = self._local.stack
        parent = stack[-1] if stack else None
        path = (name if parent is None or parent.root
                else f"{parent.path}/{name}")
        if parent is not None and parent.rec is not None:
            parent.rec[path] = parent.rec.get(path, 0.0) + ns * 1e-9
        tot = self.totals.get(path)
        if tot is None:
            tot = self.totals.setdefault(path, [0, 0])
        tot[0] += count
        tot[1] += ns

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the open call's count ``name`` under the innermost
        open span (nothing outside a call)."""
        stack = self._local.stack
        parent = stack[-1] if stack else None
        if parent is None or parent.rec is None:
            return
        path = name if parent.root else f"{parent.path}/{name}"
        counts = parent.rec.counts
        counts[path] = counts.get(path, 0) + n

    def record(self) -> Dict[str, float]:
        """The open call record of this thread ({} outside a call)."""
        stack = self._local.stack
        if stack and stack[-1].rec is not None:
            return stack[-1].rec
        return {}

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{path: {"count", "total_s"}} of every path so far."""
        return {path: {"count": c, "total_s": ns * 1e-9}
                for path, (c, ns) in list(self.totals.items())}


# the process's tracer: every span of the port goes here
TRACER = Tracer()


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False, *,
          device="cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed block (host ops
    of every thread, so a serving process's dispatcher and its spans too,
    and the card's kernels unless ``device="cpu"``) and write it to
    ``log_dir`` as a Chrome trace (``trace.json``, viewable in Perfetto).
    Yields the profiler, whose ``key_averages()`` give time by kernel.
    ``create_perfetto_link`` is accepted and unused: the file opens in
    Perfetto as it is."""
    from torch.profiler import ProfilerActivity, profile

    from ..device import resolve_device

    acts = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        extra = {"experimental_config": torch._C._profiler
                 ._ExperimentalConfig(profile_all_threads=True)}
    except (AttributeError, TypeError):  # a PyTorch without the option
        extra = {}
    with profile(activities=acts, **extra) as prof:
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
