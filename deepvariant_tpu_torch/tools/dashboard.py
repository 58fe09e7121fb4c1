"""Multi-chart HTML report composition (dashboard_utils parity).

The port's copy of `deepvariant_tpu.tools.dashboard`: host code writing
the same HTML as the JAX package's.

The reference's `dashboard_utils.create_html_report`
(dashboard_utils.py:71-177) assembles a list of Altair charts and raw
HTML snippets into one self-contained report page (title, subtitle,
optional outline, per-chart anchors). This framework has no Altair
dependency: charts are dependency-free inline-SVG objects (`BarChart`,
`LineChart`, `Table`) whose markup embeds directly, so the produced
HTML renders offline with no JavaScript or network fetches — the
equivalent of the reference's vega-embed pipeline.

The spec format matches the reference: each item is a dict with a
unique "id" and either a "chart" (any object with `to_html()`) or an
"html" string.
"""

from __future__ import annotations

import html as html_mod
from typing import Any, Dict, List, Sequence

CSS_STYLES = """
<style>
    body { font-family: sans-serif; }
    .chart-container { padding: 30px; display: inline-block;
                       vertical-align: top; }
    .chart-container.block { display: block; }
    .dataframe { border-collapse: collapse; white-space: nowrap; }
    .dataframe tr:nth-child(even) { background-color: #ddd; }
    .dataframe td, .dataframe th { border: 1px solid #ddd; padding: 8px; }
    .dataframe tr:hover { background-color: #a8a8a8; }
    .dataframe th { text-align: left; background-color: #4c78a8;
                    padding-top: 12px; padding-bottom: 12px; color: white; }
</style>
"""


def _esc(text: Any) -> str:
    return html_mod.escape(str(text))


class BarChart:
    """Inline-SVG vertical bar chart."""

    def __init__(self, labels: Sequence, values: Sequence[float],
                 title: str = "", width: int = 640, height: int = 180,
                 color: str = "#4878CF"):
        self.labels = list(labels)
        self.values = list(values)
        self.title = title
        self.width, self.height, self.color = width, height, color

    def to_html(self) -> str:
        head = f"<h3>{_esc(self.title)}</h3>" if self.title else ""
        if not self.values:
            return head + "<p>no data</p>"
        vmax = max(self.values) or 1
        w, h = self.width, self.height
        bar_w = max(1, (w - 40) // len(self.values) - 2)
        bars = []
        for i, v in enumerate(self.values):
            bh = int((h - 40) * v / vmax)
            x = 30 + i * (bar_w + 2)
            bars.append(
                f'<rect x="{x}" y="{h - 25 - bh}" width="{bar_w}" '
                f'height="{bh}" fill="{self.color}">'
                f"<title>{_esc(self.labels[i])}: {v}</title></rect>"
            )
        return (
            head + f'<svg width="{w}" height="{h}">' + "".join(bars)
            + f'<line x1="28" y1="{h - 25}" x2="{w - 5}" y2="{h - 25}" '
            'stroke="#333"/></svg>'
        )


class LineChart:
    """Inline-SVG polyline chart over (x, y) points."""

    def __init__(self, xs: Sequence[float], ys: Sequence[float],
                 title: str = "", width: int = 640, height: int = 180,
                 color: str = "#4878CF"):
        self.xs, self.ys = list(xs), list(ys)
        self.title = title
        self.width, self.height, self.color = width, height, color

    def to_html(self) -> str:
        head = f"<h3>{_esc(self.title)}</h3>" if self.title else ""
        if not self.xs:
            return head + "<p>no data</p>"
        w, h = self.width, self.height
        x0, x1 = min(self.xs), max(self.xs)
        y0, y1 = min(self.ys), max(self.ys)
        xr = (x1 - x0) or 1.0
        yr = (y1 - y0) or 1.0
        pts = " ".join(
            f"{30 + (x - x0) / xr * (w - 40):.1f},"
            f"{h - 25 - (y - y0) / yr * (h - 40):.1f}"
            for x, y in zip(self.xs, self.ys)
        )
        return (
            head + f'<svg width="{w}" height="{h}">'
            f'<polyline points="{pts}" fill="none" stroke="{self.color}" '
            'stroke-width="1.5"/>'
            f'<line x1="28" y1="{h - 25}" x2="{w - 5}" y2="{h - 25}" '
            'stroke="#333"/></svg>'
        )


class Table:
    """HTML table styled like the reference's pandas `.dataframe`."""

    def __init__(self, columns: Sequence[str], rows: Sequence[Sequence],
                 title: str = ""):
        self.columns = list(columns)
        self.rows = [list(r) for r in rows]
        self.title = title

    def to_html(self) -> str:
        head = f"<h3>{_esc(self.title)}</h3>" if self.title else ""
        header = "".join(f"<th>{_esc(c)}</th>" for c in self.columns)
        body = "".join(
            "<tr>" + "".join(f"<td>{_esc(c)}</td>" for c in row) + "</tr>"
            for row in self.rows
        )
        return (
            head + '<table class="dataframe">'
            f"<thead><tr>{header}</tr></thead>"
            f"<tbody>{body}</tbody></table>"
        )


def create_html_report(
    specs: List[Dict[str, Any]],
    html_output,
    title: str = "",
    subtitle: str = "",
    charts_on_separate_lines: bool = False,
    include_outline: bool = False,
) -> None:
    """Write a self-contained multi-chart HTML report.

    Mirrors dashboard_utils.create_html_report (dashboard_utils.py:71):
    each spec needs an "id" plus a "chart" (object with to_html()) or
    an "html" string; charts get anchors so an optional outline links
    to them.
    """
    for i, spec in enumerate(specs):
        if not isinstance(spec, dict):
            raise ValueError(f'item #{i + 1} in specs list is not a dictionary.')
        if "id" not in spec:
            raise ValueError(
                f'item #{i + 1} in specs list does not have an "id" key.'
            )

    container_class = (
        "chart-container block" if charts_on_separate_lines
        else "chart-container"
    )
    parts = [
        "<!DOCTYPE html>\n<html>\n<head>\n<meta charset='utf-8'>\n",
        f"<title>{_esc(title)}</title>\n" if title else "",
        CSS_STYLES,
        "</head>\n<body>",
        f"<h1>{_esc(title)}</h1>\n",
        f"<h2>{_esc(subtitle)}</h2>\n",
        "<div>",
    ]
    if include_outline:
        parts.append("<h3>Outline</h3>\n<ul>\n")
        for spec in specs:
            cid = spec["id"]
            parts.append(f'  <li><a href="#a_{cid}">{cid}</a></li>\n')
        parts.append("</ul>\n")

    for spec in specs:
        cid = spec["id"]
        if "chart" in spec:
            try:
                chart_html = spec["chart"].to_html()
            except Exception:
                chart_html = f"<p>Error making chart for {_esc(cid)}</p>"
            parts.append(f'<a name="a_{cid}"></a>\n')
            parts.append(
                f'<div class="{container_class}" id="vis_{cid}">'
                f"{chart_html}</div>\n"
            )
        elif "html" in spec:
            parts.append(spec["html"])
    parts.append("</div>\n</body></html>")
    html_output.write("".join(parts))
