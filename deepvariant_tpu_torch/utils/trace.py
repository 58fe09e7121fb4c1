"""Spans of the port's own phases, recorded while a profiler records.

`span(name)` marks a phase of work, such as the train step's forward.
It is on while torch's profiler records (`torch.profiler`, autograd's
profiler, `emit_nvtx`, `emit_itt`: each sets
`torch.autograd.profiler._is_profiler_enabled`) and inside
`recording()`, for a caller that wants the spans without a profiler.
Off, it returns one shared no-op context: one check, nothing allocated.

An on span opens a `record_function` range named `dv.<name>`, so the
phase nests under the caller's ranges in any trace, and keeps a
`Record`: the name, the enclosing span's name on this thread, the step
its outermost span was given, host start and end by `time.time_ns()`
taken outside the range, and, once CUDA is in use, a pair of timing
events recorded on the current stream inside it. `time.time_ns()` is
the clock torch's chrome trace writes: a stamp less the trace's
`baseTimeNanoseconds`, in microseconds, is on the trace's `ts` axis,
so a span can be laid beside the kernels of an exported trace.

The records stay in memory (`RECORDER`); nothing synchronizes while
they are taken. Past `CAP` records, those whose events have completed
are folded into per-name totals. `summary()` synchronizes once and gives
per name the calls, host ms, device ms (end event less start event, on
the stream) and self ms (device ms less that of the spans opened
inside it).

`count(name, n)` adds to a named counter while spans are on, such as
which path each training-mode batch norm took; `counts()` reads them.
`reset()` clears the records, the totals and the counters.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import torch

PREFIX = "dv."
# Records kept before the finished ones are folded into totals.
CAP = 4096

_NOOP = contextlib.nullcontext()
_profiler = torch.autograd.profiler
_recording = 0
_recording_lock = threading.Lock()
_local = threading.local()


@dataclasses.dataclass
class Record:
    """One span: `events` is (start, end) CUDA events, or None."""

    name: str
    parent: Optional[str]
    step: Optional[int]
    host_start_ns: int
    host_end_ns: int = 0
    events: Optional[tuple] = None

    def finished(self) -> bool:
        return self.events is None or (self.events[0].query()
                                       and self.events[1].query())

    def device_ms(self) -> Optional[float]:
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])


@dataclasses.dataclass
class _Total:
    calls: int = 0
    host_ns: int = 0
    device_ms: Optional[float] = None
    child_device_ms: float = 0.0


class Recorder:
    """The records of finished spans, and the totals of those folded."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self._lock = threading.Lock()
        self._records: List[Record] = []
        self._totals: Dict[str, _Total] = {}
        self._fold_at = cap
        self._counts: Dict[str, int] = {}

    def count(self, name: str, n: int = 1):
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def add(self, record: Record):
        with self._lock:
            self._records.append(record)
            if len(self._records) >= self._fold_at:
                kept = []
                for r in self._records:
                    if r.finished():
                        _fold(self._totals, r)
                    else:
                        kept.append(r)
                self._records = kept
                self._fold_at = len(kept) + self.cap

    def records(self) -> List[Record]:
        """The records not yet folded, in the order the spans closed."""
        with self._lock:
            return list(self._records)

    def summary(self) -> Dict[str, Dict[str, Optional[float]]]:
        """{name: {calls, host_ms, device_ms, self_ms}}; the device
        numbers are None for spans that recorded no events."""
        with self._lock:
            records = list(self._records)
            totals = {k: dataclasses.replace(v)
                      for k, v in self._totals.items()}
        if not all(r.finished() for r in records):
            torch.cuda.synchronize()
        for r in records:
            _fold(totals, r)
        out = {}
        for name, t in totals.items():
            if not t.calls:
                continue
            out[name] = {
                "calls": t.calls,
                "host_ms": t.host_ns / 1e6,
                "device_ms": t.device_ms,
                "self_ms": None if t.device_ms is None
                else t.device_ms - t.child_device_ms,
            }
        return out

    def reset(self):
        with self._lock:
            self._records = []
            self._totals = {}
            self._fold_at = self.cap
            self._counts = {}


def _fold(totals: Dict[str, _Total], r: Record):
    t = totals.setdefault(r.name, _Total())
    t.calls += 1
    t.host_ns += r.host_end_ns - r.host_start_ns
    ms = r.device_ms()
    if ms is not None:
        t.device_ms = (t.device_ms or 0.0) + ms
        if r.parent is not None:
            totals.setdefault(r.parent, _Total()).child_device_ms += ms


RECORDER = Recorder()


class _Span:
    __slots__ = ("record", "range", "stack")

    def __init__(self, name: str, step: Optional[int]):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        if step is None and parent is not None:
            step = parent.step
        self.stack = stack
        self.record = Record(name, parent.name if parent else None, step, 0)
        self.range = torch.profiler.record_function(PREFIX + name)

    def __enter__(self):
        r = self.record
        self.stack.append(r)
        r.host_start_ns = time.time_ns()
        self.range.__enter__()
        if torch.cuda.is_initialized():
            r.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            r.events[0].record()
        return r

    def __exit__(self, *exc):
        r = self.record
        if r.events is not None:
            r.events[1].record()
        self.range.__exit__(*exc)
        r.host_end_ns = time.time_ns()
        self.stack.pop()
        RECORDER.add(r)
        return False


def on() -> bool:
    """Whether spans and counters record now."""
    return bool(_recording or _profiler._is_profiler_enabled)


def span(name: str, step: Optional[int] = None):
    """A context around one phase named `name`; `step` identifies the
    step that it and the spans opened inside it belong to."""
    if not on():
        return _NOOP
    return _Span(name, step)


def count(name: str, n: int = 1):
    """Adds `n` to the counter `name` while spans are on."""
    if on():
        RECORDER.count(name, n)


@contextlib.contextmanager
def recording():
    """Spans are on inside, with or without a profiler."""
    global _recording
    with _recording_lock:
        _recording += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording -= 1


def records() -> List[Record]:
    return RECORDER.records()


def summary() -> Dict[str, Dict[str, Optional[float]]]:
    return RECORDER.summary()


def counts() -> Dict[str, int]:
    return RECORDER.counts()


def reset():
    RECORDER.reset()
