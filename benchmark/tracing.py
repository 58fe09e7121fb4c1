"""Spans around the port's calls, and the device trace of a traced run.

`Spans` records named host intervals (perf_counter) and, in a traced
run, opens a `torch.profiler.record_function` range of the same name, so
that the kernels launched inside can be told apart. `Trace` runs
`torch.profiler` (CPU and CUDA activity) over part of the window,
exports the chrome trace to TMPDIR, and reduces it to what the per-layer
metrics read: device activities with their start and duration, each
kernel tied to the innermost benchmark range that launched it (through
the launch's correlation id), the device's busy seconds (the union of
its activities) and the longest idle gaps by the host range that was
open when they began.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "bench."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Named host intervals; `traced` adds profiler ranges."""

    def __init__(self):
        self.traced = False
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.traced:
            import torch

            ctx = torch.profiler.record_function(PREFIX + name)
        start = time.perf_counter()
        with ctx:
            yield
        self.times[name].append(time.perf_counter() - start)


class Reduced:
    """A device trace reduced: `activities` [(cat, name, start_us, dur_us,
    range)], `busy_s`, `window_s`, `ranges` {range: count} of benchmark
    ranges that closed inside the window, and `idle` {host range: idle
    seconds}."""

    def __init__(self, activities, ranges, window_s, idle):
        self.activities = activities
        self.ranges = ranges
        self.window_s = window_s
        self.idle = idle
        self.busy_s = _union_us([(a[2], a[2] + a[3])
                                 for a in activities]) / 1e6

    def kernels_in(self, name: str) -> List[Tuple]:
        return [a for a in self.activities
                if a[0] == "kernel" and a[4] == PREFIX + name]

    def per_range(self, name: str):
        """(kernels, device ms) launched in the range `name`, per closed
        range, or None when no such range closed in the window."""
        count = self.ranges.get(PREFIX + name, 0)
        if not count:
            return None
        ks = self.kernels_in(name)
        return len(ks) / count, sum(k[3] for k in ks) / 1e3 / count

    def top_ops(self, k: int = 10) -> List[List]:
        by_name: Dict[str, float] = defaultdict(float)
        for a in self.activities:
            by_name[a[1][:120]] += a[3] / 1e6
        return [[n, s] for n, s in sorted(by_name.items(),
                                          key=lambda x: -x[1])[:k]]

    def top_idle(self, k: int = 10) -> List[List]:
        return [[n, s] for n, s in sorted(self.idle.items(),
                                          key=lambda x: -x[1])[:k]]


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Trace:
    """torch.profiler over a part of the window: `start()`, `stop()`,
    then `reduce()` once the window has closed."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._t0 = self._t1 = 0.0

    def start(self):
        self._torch.cuda.synchronize()
        self._prof.start()
        self._torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def stop(self):
        self._torch.cuda.synchronize()
        self._t1 = time.perf_counter()
        self._prof.stop()

    def reduce(self) -> Reduced:
        """The stopped trace, exported and reduced (after the window:
        the export takes seconds)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce(events, self._t1 - self._t0)


def reduce(events: List[Dict], window_s: float) -> Reduced:
    """The chrome trace's events -> `Reduced`. A kernel belongs to the
    innermost benchmark range, on the launching thread, that holds its
    launch call (matched by correlation id)."""
    ranges: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
    launches: Dict[int, Tuple[int, float]] = {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            ranges[e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), float(e["ts"]))
        elif cat in _DEVICE_CATS:
            device.append((cat, e.get("name", ""), float(e["ts"]),
                           float(e.get("dur", 0)), args.get("correlation")))
    starts = {}
    for tid, rs in ranges.items():
        rs.sort()
        starts[tid] = [r[0] for r in rs]

    def innermost(tid, ts) -> Optional[str]:
        rs = ranges.get(tid)
        if not rs:
            return None
        # Ranges on one thread nest: the latest-starting one that is
        # still open at ts is the innermost.
        last = bisect.bisect_right(starts[tid], ts) - 1
        for i in range(last, max(last - 64, -1), -1):
            if rs[i][1] >= ts:
                return rs[i][2]
        return None

    # The thread that opens the ranges; a launch from another thread
    # (autograd's backward runs on its own) takes the range open there.
    main = max(ranges, key=lambda t: len(ranges[t])) if ranges else None
    activities = []
    for cat, name, ts, dur, corr in device:
        where = launches.get(corr)
        rng = None
        if where:
            rng = innermost(*where) or innermost(main, where[1])
        activities.append((cat, name, ts, dur, rng))
    counts: Dict[str, int] = defaultdict(int)
    for rs in ranges.values():
        for _, _, name in rs:
            counts[name] += 1
    # Idle gaps on the device timeline, named by the host's range.
    idle: Dict[str, float] = defaultdict(float)
    busy = sorted((a[2], a[2] + a[3]) for a in activities)
    end = None
    for s, e in busy:
        if end is not None and s > end:
            name = innermost(main, end) if main is not None else None
            idle["host:" + (name[len(PREFIX):] if name else "other")] += \
                (s - end) / 1e6
        end = e if end is None else max(end, e)
    return Reduced(activities, dict(counts), window_s, dict(idle))
