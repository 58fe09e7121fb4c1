"""Summarize per-checkpoint `.metrics` files as a checkpoint/F1 table
(reference tools/print_f1.py:28-88).

The port's copy of `deepvariant_tpu.tools.print_f1`: host code with the
same table.

The training case study's checkpoint sweep evaluates every saved
checkpoint (call_variants -> postprocess -> vcf_eval --metrics_out
<ckpt>.metrics) and then runs this tool to pick the best one. Each
`ckpt-N.metrics` file is a flat JSON dict carrying at least
TPs_All / FNs_All / FPs_All; F1_All is derived here so upstream
evaluators only need raw counts.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence

_CKPT_RE = re.compile(r"ckpt-(\d+)\.metrics$")


def checkpoint_number(filename: str) -> Optional[int]:
    m = _CKPT_RE.search(filename)
    return int(m.group(1)) if m else None


def read_metrics_file(path: str) -> Dict[str, float]:
    """One `.metrics` JSON -> flat dict with derived F1_All."""
    with open(path) as f:
        metrics = {
            key.replace("/", "_"): float(value)
            for key, value in json.load(f).items()
        }
    metrics["checkpoint"] = checkpoint_number(path)
    tp, fn, fp = (metrics["TPs_All"], metrics["FNs_All"],
                  metrics["FPs_All"])
    denom = 2 * tp + fn + fp
    metrics["F1_All"] = 2 * tp / denom if denom else 0.0
    metrics["TPs+FNs_All"] = tp + fn
    return metrics


def collect(metrics_dir: str) -> List[Dict[str, float]]:
    rows = []
    for name in sorted(os.listdir(metrics_dir)):
        path = os.path.join(metrics_dir, name)
        if os.path.isfile(path) and checkpoint_number(name) is not None:
            rows.append(read_metrics_file(path))
    rows.sort(key=lambda m: m["checkpoint"])
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Print checkpoint F1 table from *.metrics files."
    )
    p.add_argument("--metrics_dir", required=True)
    args = p.parse_args(argv)
    for m in collect(args.metrics_dir):
        print(f"{m['checkpoint']}\t{m['TPs+FNs_All']}\t{m['F1_All']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
