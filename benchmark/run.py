"""Runs one benchmark cell of the PyTorch/CUDA port on this machine.

    python3 benchmark/run.py --workload wgs.train --seed 7 --seconds 45 \
        --trace 0

Loads and warms up the cell's path (set-up), measures for `--seconds`,
checks what the timed path produced against the plain reference, and
prints one JSON object as the last line of standard output. With
`--trace 1` it reports the cell's per-layer metrics from a device trace
of part of the window instead of its end-to-end metrics. It needs as
many CUDA devices as the cell asks for and never falls back to the CPU.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# Build and kernel caches at fixed paths inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
os.environ["USE_FLAX"] = "0"

from benchmark import harness  # noqa: E402


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi: not readable"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {seen} "
              "visible", file=sys.stderr)
        return 2
    print(f"[card] {card_line()}; peaks: bf16 989 TFLOP/s dense, HBM "
          f"3.35 TB/s", file=sys.stderr)
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda",
                          t_process=T_PROCESS)
    out = harness.run(ctx)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    if ctx.trace and out.reduced is not None:
        device["busy_s"] = out.reduced.busy_s
        device["window_s"] = out.reduced.window_s
    line = harness.result_line(ctx, out, device)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 3
    for c in out.checks:
        print(f"[compared] {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
