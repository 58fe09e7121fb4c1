"""Parallel CVO writer pool for call_variants.

Counterpart of `deepvariant_tpu/calling/cvo_writer.py` (the reference's
round-robin writer processes, call_variants.py:934-1053): each worker
is a plain `python -m deepvariant_tpu_torch.calling.cvo_writer <path>`
subprocess that owns one output shard and reads length-framed pickles
of (variant, alt_allele_indices, probabilities) batches on stdin; it
rounds the probabilities (round_gls) and encodes the CVOs itself, so
the main process only ships pickles. A fresh interpreter that imports
only this module and the port's torch-free host code never touches the
card and re-imports no caller's `__main__`.

Shard files follow the `base-KKKKK-of-NNNNN` family and are read back
through `glob_sharded_inputs`. Within a shard the order is FIFO; across
shards batches go round-robin. Backpressure is the OS pipe buffer.
"""

from __future__ import annotations

import os
import pickle
import struct
import subprocess
import sys
from typing import List, Sequence, Tuple

from deepvariant_tpu_torch.core.genomics_math import round_gls
from deepvariant_tpu_torch.core.sharded_files import sharded_filename
from deepvariant_tpu_torch.core.types import CallVariantsOutput, Variant
from deepvariant_tpu_torch.io.tfrecord import TFRecordWriter

# One work item: (variant, alt_allele_indices, probabilities).
CvoItem = Tuple[Variant, List[int], List[float]]

_LEN = struct.Struct("<Q")


def encode_cvo(variant: Variant, alt_allele_indices: Sequence[int],
               probs: Sequence[float]) -> bytes:
    """round_gls + wire-encode one CallVariantsOutput."""
    gls = round_gls([float(p) for p in probs])
    return CallVariantsOutput(
        variant=variant,
        alt_allele_indices=list(alt_allele_indices),
        genotype_probabilities=gls,
    ).encode()


def _writer_main(path: str) -> int:
    """Worker entry: drain framed batches from stdin into `path`.

    Frame = 8-byte LE length + pickle of a list[CvoItem]; a zero length
    terminates. Prints the record count on stdout for the parent to
    cross-check. The frames come only from the parent process.
    """
    stdin = sys.stdin.buffer
    n = 0
    with TFRecordWriter(path) as writer:
        while True:
            header = stdin.read(_LEN.size)
            if len(header) < _LEN.size:
                raise EOFError("writer feed pipe closed without EOF frame")
            (length,) = _LEN.unpack(header)
            if length == 0:
                break
            buf = stdin.read(length)
            if len(buf) < length:
                raise EOFError("truncated writer feed frame")
            for variant, alt_indices, probs in pickle.loads(buf):
                writer.write(encode_cvo(variant, alt_indices, probs))
                n += 1
    print(n, flush=True)
    return 0


def shard_paths(output_path: str, num_writers: int) -> List[str]:
    """Shard family for a parallel write ('out.tfrecord.gz' ->
    'out-00000-of-0000N.tfrecord.gz')."""
    base = output_path
    suffix = ""
    name = os.path.basename(output_path)
    if "." in name:
        dot = len(output_path) - len(name) + name.index(".")
        base, suffix = output_path[:dot], output_path[dot:]
    return [
        sharded_filename(base, i, num_writers, suffix)
        for i in range(num_writers)
    ]


class CvoWriterPool:
    """Round-robin pool of CVO writer subprocesses.

    Usage:
        pool = CvoWriterPool(out_path, num_writers=4)
        pool.put_batch(items)   # list of (variant, alt_indices, probs)
        n = pool.close()        # EOF frames + join; total records
    """

    def __init__(self, output_path: str, num_writers: int):
        if num_writers < 1:
            raise ValueError("num_writers must be >= 1")
        self.paths = shard_paths(output_path, num_writers)
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get(
            "PYTHONPATH", "")
        self._procs = [
            subprocess.Popen(
                [sys.executable, "-m",
                 "deepvariant_tpu_torch.calling.cvo_writer", path],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
            )
            for path in self.paths
        ]
        self._next = 0

    def put_batch(self, items: List[CvoItem]) -> None:
        """Ship one batch to the next writer (blocks on the OS pipe when
        that worker is behind)."""
        proc = self._procs[self._next]
        blob = pickle.dumps(items, protocol=pickle.HIGHEST_PROTOCOL)
        proc.stdin.write(_LEN.pack(len(blob)))
        proc.stdin.write(blob)
        self._next = (self._next + 1) % len(self._procs)

    def close(self) -> int:
        """Send every worker its EOF frame, wait for all of them, and
        return the total count of records written."""
        for proc in self._procs:
            try:
                proc.stdin.write(_LEN.pack(0))
                proc.stdin.close()
            except BrokenPipeError:
                pass  # the worker died; its exit code is reported below
        total, failed = 0, []
        for i, proc in enumerate(self._procs):
            out = proc.stdout.read()
            proc.stdout.close()
            proc.wait()
            if proc.returncode != 0:
                failed.append(f"CVO writer {i} ({self.paths[i]}) exited "
                              f"with code {proc.returncode}")
            else:
                total += int(out.split()[-1])
        if failed:
            raise RuntimeError("; ".join(failed))
        return total


if __name__ == "__main__":
    sys.exit(_writer_main(sys.argv[1]))
