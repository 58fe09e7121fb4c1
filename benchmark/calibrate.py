"""Readings from which the limits of `correct` are set, on the card.

    python3 benchmark/calibrate.py --workload wgs.train \
        --workload pacbio.train --seeds 11,12,13 --control-seeds 21,22,23 \
        --seconds 3

For each cell and each of `--seeds`, one whole run of the cell (a short
window) in this process, and its numbers; for each of `--control-seeds`,
the numbers of the control (the reference one precision below bfloat16
in the program's place) and of half of each batch left out. Prints one
JSON line per reading. Not run by the benchmark's own runs.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True, action="append")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--controls", default="fp8")
    args = ap.parse_args()
    for name in args.workload:
        calibrate(name, args)


def calibrate(name, args):
    import torch

    cell = harness.load_cell(name)
    drv = harness.driver(cell.traffic["driver"])

    def context(seed):
        return harness.Context(cell=cell, seed=seed, seconds=args.seconds,
                               trace=False, device=args.device,
                               t_process=time.time())

    def emit(kind, seed, numbers, **more):
        print(json.dumps({"workload": name, "reading": kind, "seed": seed,
                          "numbers": numbers, **more}), flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        out = drv.run(context(seed))
        emit("program", seed, out.readings, metrics=out.metrics)
        del out
        torch.cuda.empty_cache()
    kinds = [(q, {"quant": q}) for q in args.controls.split(",") if q]
    kinds.append(("half_batch", {"half_batch": True}))
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        read = drv.control_readings(context(seed), [c for _, c in kinds])
        for (kind, _), numbers in zip(kinds, read):
            emit(kind, seed, numbers)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
