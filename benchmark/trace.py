"""A ``torch.profiler`` trace of a steady stretch of the window, read into
what the per-layer metrics need.

The benchmark marks each device call of the system with a
``record_function`` range named ``bench.call#<n>`` (``CALL_PREFIX``), so a
kernel is tied to its call through the CUDA runtime launch that the
profiler records inside that range (the launch and the kernel share a
correlation id). The trace goes to a file in ``TMPDIR`` only while it is
read.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Tuple

CALL_PREFIX = "bench.call#"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
GAP_MIN_US = 5.0  # shorter device idle gaps are not named in the breakdown
NAME_CHARS = 96


class TraceData:
    """The parsed stretch: device activity, and each call's kernels."""

    def __init__(self, events: List[Dict], window_s: float):
        self.window_s = window_s
        # host clock (perf_counter) of the profiler's start and of the
        # synchronise before its stop: a call inside both lies whole in it
        self.host_span = (float("-inf"), float("inf"))
        dev, launches, ann, host = [], {}, [], collections.defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                dev.append((ts, ts + dur, e.get("name", ""),
                            args.get("correlation")))
            elif cat in LAUNCH_CATS:
                if "correlation" in args:
                    launches[args["correlation"]] = (ts, e.get("tid"))
                host[e.get("tid")].append((ts, ts + dur, e.get("name", "")))
            elif cat == "user_annotation":
                ann.append((ts, ts + dur, e.get("name", ""), e.get("tid")))
            elif cat == "cpu_op":
                host[e.get("tid")].append((ts, ts + dur, e.get("name", "")))
        dev.sort()
        self.device = dev
        self.calls = sorted(a for a in ann if a[2].startswith(CALL_PREFIX))
        self._launches = launches
        self._host = host
        self._merged = _merge([(s, e) for s, e, _, _ in dev])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged) / 1e6

    def call_kernels(self) -> Dict[int, List[Tuple[str, float]]]:
        """{call number: [(kernel name, seconds), ...]} for the calls whose
        range lies in the trace, by their launches inside the range on the
        range's thread."""
        by_tid = collections.defaultdict(list)
        for corr, (ts, tid) in self._launches.items():
            by_tid[tid].append((ts, corr))
        for v in by_tid.values():
            v.sort()
        dev_by_corr = collections.defaultdict(list)
        for s, e, name, corr in self.device:
            if corr is not None:
                dev_by_corr[corr].append((name, (e - s) / 1e6))
        out = {}
        for s, e, name, tid in self.calls:
            seq = int(name[len(CALL_PREFIX):].split()[0])
            lst = by_tid.get(tid, [])
            lo = bisect.bisect_left(lst, (s, -1))
            kern = []
            for ts, corr in lst[lo:]:
                if ts > e:
                    break
                kern.extend(dev_by_corr.get(corr, []))
            out[seq] = kern
        return out

    def breakdown(self) -> Dict[str, List[List]]:
        """The ten device operations that took most time, and the ten
        longest sums of device idle gaps by what the calls' thread was
        doing on the host at each gap's middle."""
        ops = collections.Counter()
        for s, e, name, _ in self.device:
            ops[name[:NAME_CHARS]] += (e - s) / 1e6
        tids = {tid for _, _, _, tid in self.calls}
        host = sorted(x for t in tids for x in self._host.get(t, []))
        calls = [(s, e) for s, e, _, _ in self.calls]
        gaps = collections.Counter()
        for (_, e0), (s1, _) in zip(self._merged, self._merged[1:]):
            if s1 - e0 < GAP_MIN_US:
                continue
            mid = 0.5 * (e0 + s1)
            gaps[_host_at(host, calls, mid)] += (s1 - e0) / 1e6
        return {"device_ops": [[n, s] for n, s in ops.most_common(10)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(10)]}


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _host_at(host, calls, t) -> str:
    """The innermost host operation of the calls' thread at ``t``, else
    whether a call was in progress."""
    best = None
    lo = bisect.bisect_right(host, (t, float("inf"), "")) - 1
    # host ops are nested: scan back over those that start before t
    for s, e, name in reversed(host[max(0, lo - 256):lo + 1]):
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    if best is not None:
        return best[2][:NAME_CHARS]
    if any(s <= t <= e for s, e in calls):
        return "host, in a call, outside any op"
    return "host, between calls"


class Profiler:
    """A ``torch.profiler`` stretch over host and device activity."""

    def __init__(self, device):
        self.device = device
        self._prof = None
        self.t0 = self.t1 = self.t_sync = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # the calls run on the service's dispatcher thread, not this one
        try:
            extra = {"experimental_config": torch._C._profiler
                     ._ExperimentalConfig(profile_all_threads=True)}
        except (AttributeError, TypeError):
            extra = {}
        self._prof = profile(activities=acts, **extra)
        self._prof.start()
        self.t0 = time.perf_counter()

    def stop_recording(self) -> None:
        """End the stretch (after the device has run what it was given)."""
        import torch

        self.t_sync = time.perf_counter()
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self._prof.stop()

    def read(self) -> TraceData:
        """The stretch, read (slow: call it after the window)."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self._prof = None
        data = TraceData(events, self.t1 - self.t0)
        data.host_span = (self.t0, self.t_sync)
        return data


def complete_calls(data: TraceData, calls: List[Dict]):
    """[(call record, its kernels)] of the recorded calls that lie whole in
    the stretch."""
    kern = data.call_kernels()
    t0, t1 = data.host_span
    return [(c, kern[c["seq"]]) for c in calls
            if c["seq"] in kern and c["t0"] >= t0 and c["t1"] <= t1]


def kernels_matching(kernels: List[Tuple[str, float]], family: str
                     ) -> List[float]:
    """Seconds of each kernel of ``family`` (``KERNEL_FAMILIES``), in
    launch order."""
    match = KERNEL_FAMILIES[family]
    return [s for n, s in kernels if match(n)]


def _is(name: str):
    """A kernel's symbol, however the profiler decorates it (namespace,
    return type, template or parameter lists), and no longer identifier
    that contains it."""
    pat = re.compile(r"(?<![A-Za-z0-9_])" + name + r"(?![A-Za-z0-9_])")
    return lambda n: pat.search(n) is not None


# the port's kernels by the symbol name the profiler reports
KERNEL_FAMILIES = {
    "k1_pack": _is("pack_kernel"),
    "k3_bucketed": _is("bucketed_kernel"),
    "k4_int8_bucketed": _is("int8_bucketed_kernel"),
}


def stretch_bounds(window_s: float, spec: Dict) -> Optional[Tuple[float, float]]:
    """(start, length) of the traced stretch inside a window of
    ``window_s`` seconds: ``spec["trace_seconds"]`` from
    ``spec["trace_start"]`` of the window (a share)."""
    length = min(float(spec["trace_seconds"]), window_s)
    start = min(float(spec["trace_start"]) * window_s, window_s - length)
    return max(start, 0.0), length
