"""Runtime resource-usage metrics (reference resources.py:30-150).

ResourceMonitor gathers host info and the process's wall/CPU time,
peak RSS, and IO counters as a plain dict mirroring the
ResourceMetrics proto fields (protos/resources.proto:39-80).
psutil is optional: without it, the stdlib resource module still
covers CPU times and peak RSS.
"""

from __future__ import annotations

import platform
import resource
import time
from typing import Dict, Optional


def _get_host_name() -> str:
    return platform.node()


def _psutil():
    try:
        import psutil

        return psutil
    except ImportError:
        return None


def _get_cpu_count() -> int:
    ps = _psutil()
    if ps is not None:
        return ps.cpu_count(logical=False) or 0
    import os

    return os.cpu_count() or 0


def _get_cpu_frequency() -> float:
    ps = _psutil()
    if ps is None:
        return 0.0
    try:
        freq = ps.cpu_freq()
        return freq.current if freq is not None else 0.0
    except NotImplementedError:
        return 0.0


def _get_total_memory() -> int:
    ps = _psutil()
    if ps is None:
        return 0
    return int(ps.virtual_memory().total / (1024 * 1024))


class ResourceMonitor:
    """Collects resource usage for this process (resources.py:51)."""

    def __init__(self):
        self.wall_start: Optional[float] = None
        self._base = {
            "host_name": _get_host_name(),
            "physical_core_count": _get_cpu_count(),
            "cpu_frequency_mhz": _get_cpu_frequency(),
            "total_memory_mb": _get_total_memory(),
        }

    def __enter__(self) -> "ResourceMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        pass

    def start(self) -> "ResourceMonitor":
        self.wall_start = time.time()
        return self

    def metrics(self) -> Dict[str, object]:
        """ResourceMetrics-shaped dict; wall time since last start()."""
        if self.wall_start is None:
            raise RuntimeError("start() must be called prior to metrics()")
        out = dict(self._base)
        out["wall_time_seconds"] = time.time() - self.wall_start
        try:
            rusage = resource.getrusage(resource.RUSAGE_SELF)
            out["cpu_user_time_seconds"] = rusage.ru_utime
            out["cpu_system_time_seconds"] = rusage.ru_stime
            out["memory_peak_rss_mb"] = int(rusage.ru_maxrss / 1024)
        except resource.error:
            pass
        ps = _psutil()
        if ps is not None:
            try:
                io = ps.Process().io_counters()
                out["read_bytes"] = io.read_bytes
                out["write_bytes"] = io.write_bytes
            except (ps.Error, AttributeError, NotImplementedError,
                    ValueError):
                # ValueError: a /proc/<pid>/io without the fields psutil
                # parses (some sandboxed kernels write `char` for
                # `rchar`); the byte counts are then left out.
                pass
        return out
