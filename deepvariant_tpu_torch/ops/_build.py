"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for sm_90a into `build/<name>-<hash>.so`, where the hash covers the
source and the flags, so an edited source is rebuilt at its next use.
Libraries are loaded with ctypes. Nothing is built at import: `load`
builds what is missing on first use, and `build` compiles every source
at once, one `nvcc` process each, all started together.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(_PACKAGE, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def source_names() -> List[str]:
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC_DIR, "*.cu"))
    )


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under /usr/local/cuda/bin; the CUDA "
            "kernels are built from source on first use"
        )
    return path


def build(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: all) that are not built yet.

    Returns {name: compiler messages} for the sources compiled now (the
    `-Xptxas -v` register and shared-memory report). Raises with the
    compiler's output if any compile fails.
    """
    todo = [n for n in (names or source_names())
            if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    messages, failures = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        messages[name] = out
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("\n".join(failures))
    return messages


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
