"""ResultsLog — accumulate per-epoch/step row dicts, persist CSV + a
self-contained HTML report.

Parity with the reference's ResultsLog (utils.py:31-73), which wrote a CSV
and a Bokeh HTML document (its Line plotting was commented out,
utils.py:66-68). Here the HTML is dependency-free: one inline-SVG line chart
per numeric column, so the artifact renders anywhere.
"""

from __future__ import annotations

import html
import os
from typing import Any, Dict, List


class ResultsLog:
    def __init__(self, path: str = "results.csv", plot_path: str | None = None):
        self.path = path
        self.plot_path = plot_path or (os.path.splitext(path)[0] + ".html")
        self.rows: List[Dict[str, Any]] = []

    def add(self, **kwargs: Any) -> None:
        self.rows.append(dict(kwargs))

    # -- persistence --------------------------------------------------------

    def _columns(self) -> List[str]:
        cols: List[str] = []
        for row in self.rows:
            for k in row:
                if k not in cols:
                    cols.append(k)
        return cols

    def save(self, title: str = "training results") -> None:
        cols = self._columns()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            f.write(",".join(cols) + "\n")
            for row in self.rows:
                f.write(",".join(str(row.get(c, "")) for c in cols) + "\n")
        with open(self.plot_path, "w") as f:
            f.write(self._render_html(title, cols))

    def load(self, path: str | None = None) -> List[Dict[str, Any]]:
        path = path or self.path
        with open(path) as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        cols = lines[0].split(",")
        self.rows = []
        for ln in lines[1:]:
            vals = ln.split(",")
            row: Dict[str, Any] = {}
            for c, v in zip(cols, vals):
                if v == "":
                    continue
                try:
                    row[c] = float(v) if "." in v or "e" in v.lower() else int(v)
                except ValueError:
                    row[c] = v
            self.rows.append(row)
        return self.rows

    # -- plotting -----------------------------------------------------------

    def _render_html(self, title: str, cols: List[str]) -> str:
        charts = []
        numeric_cols = [
            c
            for c in cols
            if any(isinstance(r.get(c), (int, float)) for r in self.rows)
        ]
        for c in numeric_cols:
            ys = [
                float(r[c])
                for r in self.rows
                if isinstance(r.get(c), (int, float))
            ]
            if len(ys) >= 2:
                charts.append(self._svg_line(c, ys))
        body = "\n".join(charts) or "<p>(not enough data to plot)</p>"
        return (
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title></head>"
            f"<body><h1>{html.escape(title)}</h1>{body}</body></html>"
        )

    @staticmethod
    def _svg_line(name: str, ys: List[float], w: int = 640, h: int = 240) -> str:
        lo, hi = min(ys), max(ys)
        span = (hi - lo) or 1.0
        pts = " ".join(
            f"{40 + i * (w - 60) / max(len(ys) - 1, 1):.1f},"
            f"{h - 30 - (y - lo) / span * (h - 60):.1f}"
            for i, y in enumerate(ys)
        )
        return (
            f"<h3>{html.escape(name)}</h3>"
            f"<svg width='{w}' height='{h}' style='border:1px solid #ccc'>"
            f"<polyline fill='none' stroke='#1f77b4' stroke-width='1.5' "
            f"points='{pts}'/>"
            f"<text x='5' y='15' font-size='11'>{hi:.4g}</text>"
            f"<text x='5' y='{h - 10}' font-size='11'>{lo:.4g}</text>"
            "</svg>"
        )
