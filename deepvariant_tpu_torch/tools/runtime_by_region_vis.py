"""Visualize make_examples runtime-by-region TSVs.

The port's copy of `deepvariant_tpu.tools.runtime_by_region_vis`: host
code writing the same HTML from the runtime TSV that the port's
make_examples writes.

Reference parity: runtime_by_region_vis.py (altair HTML report,
docs/runtime-by-region.md) — reads the per-region stage timing TSV
written by the runner and emits a single-file HTML report with stage
totals, the slowest regions, and an inline-SVG stage breakdown.
"""

from __future__ import annotations

import html
from typing import Dict, List, Tuple


def read_runtime_tsv(path: str) -> Tuple[List[str], List[Dict]]:
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = []
        for line in f:
            parts = line.rstrip("\n").split("\t")
            row = {"region": parts[0]}
            for name, value in zip(header[1:], parts[1:]):
                row[name] = float(value)
            rows.append(row)
    return header[1:], rows


def write_report(tsv_path: str, output_html: str, top_n: int = 20):
    columns, rows = read_runtime_tsv(tsv_path)
    stage_cols = [c for c in columns if c != "total"]
    totals = {c: sum(r[c] for r in rows) for c in columns}
    slowest = sorted(rows, key=lambda r: -r.get("total", 0))[:top_n]
    parts = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        "<title>Runtime by region</title>"
        "<style>body{font-family:sans-serif;margin:2em}"
        "table{border-collapse:collapse}"
        "td,th{border:1px solid #ccc;padding:4px 10px}</style></head><body>",
        "<h1>make_examples runtime by region</h1>",
        f"<p>{len(rows)} regions, "
        f"{totals.get('total', 0):.1f}s total</p>",
        "<h3>Stage totals</h3><table><tr><th>stage</th><th>seconds</th>"
        "<th>share</th></tr>",
    ]
    grand = totals.get("total", 0) or 1.0
    for c in stage_cols:
        parts.append(
            f"<tr><td>{html.escape(c)}</td><td>{totals[c]:.2f}</td>"
            f"<td>{100 * totals[c] / grand:.1f}%</td></tr>"
        )
    parts.append("</table>")
    # Inline SVG stacked bar of stage shares.
    width = 640
    x = 0
    svg = [f'<svg width="{width}" height="40">']
    palette = ["#4878CF", "#EE854A", "#6ACC64", "#D65F5F", "#956CB4"]
    for i, c in enumerate(stage_cols):
        w = int(width * totals[c] / grand)
        svg.append(
            f'<rect x="{x}" y="5" width="{w}" height="30" '
            f'fill="{palette[i % len(palette)]}">'
            f"<title>{html.escape(c)}: {totals[c]:.1f}s</title></rect>"
        )
        x += w
    svg.append("</svg>")
    parts.append("<h3>Stage share</h3>" + "".join(svg))
    parts.append(
        f"<h3>Slowest {len(slowest)} regions</h3><table><tr><th>region</th>"
        + "".join(f"<th>{html.escape(c)}</th>" for c in columns)
        + "</tr>"
    )
    for r in slowest:
        parts.append(
            f"<tr><td>{html.escape(r['region'])}</td>"
            + "".join(f"<td>{r[c]:.3f}</td>" for c in columns)
            + "</tr>"
        )
    parts.append("</table></body></html>")
    with open(output_html, "w") as f:
        f.write("".join(parts))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser("runtime_by_region_vis")
    p.add_argument("--input", required=True, help="runtime TSV")
    p.add_argument("--title", default="Runtime by region")
    p.add_argument("--output", required=True, help="output HTML")
    args = p.parse_args(argv)
    write_report(args.input, args.output)
    print(f"runtime_by_region_vis: wrote {args.output}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
