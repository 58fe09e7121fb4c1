"""Sharded filename specs: 'name@N' and 'name-00000-of-00010' handling.

A copy of what stage 2 needs from `deepvariant_tpu.core.sharded_files`
(reference sharded_file_utils.py semantics): `spec@N` expands to
`spec-KKKKK-of-NNNNN` with 5-digit zero padding, widening if N needs
more digits.
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional, Tuple

_SHARD_SPEC = re.compile(r"^(.*)@(\d+)((?:\.\w+)*)$")
_SHARDED_NAME = re.compile(r"^(.*)-(\d{5,})-of-(\d{5,})((?:\.\w+)*)$")


def parse_sharded_file_spec(spec: str) -> Optional[Tuple[str, int, str]]:
    """Return (basename, num_shards, suffix) for 'base@N[.suffix]' or None."""
    m = _SHARD_SPEC.match(spec)
    if not m:
        return None
    return m.group(1), int(m.group(2)), m.group(3) or ""


def sharded_filename(basename: str, shard: int, num_shards: int,
                     suffix: str = "") -> str:
    width = max(5, len(str(num_shards)))
    return f"{basename}-{shard:0{width}d}-of-{num_shards:0{width}d}{suffix}"


def maybe_sharded_output_path(spec: str, task_id: int) -> str:
    """Resolve the path this task should write ('base@N' -> its shard)."""
    parsed = parse_sharded_file_spec(spec)
    if parsed is None:
        return spec
    base, n, suffix = parsed
    if not 0 <= task_id < n:
        raise ValueError(f"task {task_id} out of range for {spec}")
    return sharded_filename(base, task_id, n, suffix)


def glob_sharded_inputs(spec: str) -> List[str]:
    """Expand an input spec: '@N' form, a real sharded family on disk,
    a glob, or a single path."""
    parsed = parse_sharded_file_spec(spec)
    if parsed is not None:
        base, n, suffix = parsed
        return [sharded_filename(base, i, n, suffix) for i in range(n)]
    if any(ch in spec for ch in "*?["):
        return sorted(glob.glob(spec))
    m = _SHARDED_NAME.match(spec)
    if m is None and not os.path.exists(spec):
        # Maybe the caller gave the base name of an on-disk sharded family.
        family = sorted(glob.glob(spec + "-?????-of-?????*"))
        if family:
            return family
        # Or the family inserts the shard between stem and extension
        # ('out.tfrecord.gz' -> 'out-00000-of-00004.tfrecord.gz'), as
        # the parallel CVO writer pool does (calling/cvo_writer.py).
        name = os.path.basename(spec)
        if "." in name:
            dot = len(spec) - len(name) + name.index(".")
            family = sorted(
                glob.glob(spec[:dot] + "-?????-of-?????" + spec[dot:])
            )
            if family:
                return family
    return [spec]
