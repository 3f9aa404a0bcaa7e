"""A small figure writer that draws the evaluation figures as SVG text.

The card's machine has no matplotlib, and SVG is text: it needs no library
and no rasterizer.  A `Figure` holds a row or a column (or a grid) of
`Axes`; each axes maps data to pixels over the limits of what it holds
(with a 5% margin, as matplotlib's default), with ticks at 1, 2 or 5 times
a power of ten, and draws:

- ``stairs(values, edges, fill, alpha, label)``: a step histogram;
- ``scatter(x, y, alpha, label)``: markers;
- ``plot(x, y, label)``: a line;
- ``quiver(x, y, u, v)``: arrows, scaled so that the longest is 0.9 of the
  spacing of a square grid of as many points;

with ``set_title`` and ``legend``.  Non-finite points are not drawn.  Each
series is one SVG element (``class`` stairs, scatter, line or quiver) whose
``data-*`` attributes keep the values it was given, exactly (``repr`` of
each float), so a test can read them back.  Series take matplotlib's
default colour cycle in order.

Usage::

    fig = Figure(1, 2, figsize=(10, 5))
    fig.axes[0].stairs(counts, edges, fill=True, alpha=0.4, label="train samples")
    fig.axes[0].legend()
    fig.savefig("plot_000_iter_00000001.svg")
"""
import math
from typing import List, Optional, Sequence, Tuple
from xml.sax.saxutils import escape, quoteattr

import numpy as np

DPI = 100
COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
          "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")
_FONT = 'font-family="sans-serif" font-size="11"'


def values(x) -> np.ndarray:
    """A tensor, array or sequence as a float64 numpy vector."""
    return np.asarray(x.tolist() if hasattr(x, "tolist") else x, dtype=np.float64).reshape(-1)


def _data(name: str, v: np.ndarray) -> str:
    return f' data-{name}="{" ".join(repr(float(a)) for a in v)}"'


def nice_ticks(lo: float, hi: float, target: int = 5) -> List[float]:
    """Ticks at multiples of 1, 2 or 5 times a power of ten inside [lo, hi],
    about ``target`` of them."""
    span = hi - lo
    step = 10.0 ** math.floor(math.log10(span / target))
    for m in (1, 2, 5, 10):
        if span / (m * step) <= target + 1:
            step *= m
            break
    first = math.ceil(lo / step - 1e-9)
    ticks = []
    k = first
    while k * step <= hi + 1e-9 * step:
        ticks.append(float(f"{k * step:.12g}"))
        k += 1
    return ticks


class Axes:
    """One panel: a frame at ``box = (left, top, width, height)`` pixels."""

    def __init__(self, box: Tuple[float, float, float, float]):
        self.box = box
        self.series: List[dict] = []
        self.title: Optional[str] = None
        self.show_legend = False

    def _add(self, kind: str, label: Optional[str], **kw) -> None:
        color = COLORS[len(self.series) % len(COLORS)]
        self.series.append(dict(kind=kind, label=label, color=color, **kw))

    def stairs(self, counts, edges, fill: bool = False, alpha: float = 1.0,
               label: Optional[str] = None) -> None:
        counts, edges = values(counts), values(edges)
        if edges.size != counts.size + 1:
            raise ValueError(f"stairs: {counts.size} values need {counts.size + 1} edges, "
                             f"got {edges.size}")
        self._add("stairs", label, values=counts, edges=edges, fill=fill, alpha=alpha)

    def scatter(self, x, y, alpha: float = 1.0, label: Optional[str] = None) -> None:
        self._add("scatter", label, x=values(x), y=values(y), alpha=alpha)

    def plot(self, x, y, label: Optional[str] = None) -> None:
        self._add("line", label, x=values(x), y=values(y), alpha=1.0)

    def quiver(self, x, y, u, v) -> None:
        self._add("quiver", None, x=values(x), y=values(y), u=values(u), v=values(v), alpha=1.0)

    def set_title(self, title: str) -> None:
        self.title = title

    def legend(self) -> None:
        self.show_legend = True

    def limits(self) -> Tuple[float, float, float, float]:
        """(x0, x1, y0, y1): the finite data's range, widened by 5% a side."""
        xs, ys = [], []
        for s in self.series:
            if s["kind"] == "stairs":
                xs.append(s["edges"])
                ys.append(np.append(s["values"], 0.0))
            else:
                xs.append(s["x"])
                ys.append(s["y"])
        out = []
        for v in (xs, ys):
            v = np.concatenate(v) if v else np.zeros(0)
            v = v[np.isfinite(v)]
            lo, hi = (float(v.min()), float(v.max())) if v.size else (0.0, 1.0)
            pad = 0.05 * (hi - lo) if hi > lo else 0.5
            out += [lo - pad, hi + pad]
        return tuple(out)

    def svg(self, index: int = 0) -> List[str]:
        """SVG elements of the panel; ``index`` names its clip path."""
        left, top, width, height = self.box
        x0, x1, y0, y1 = self.limits()
        px = lambda x: left + (x - x0) / (x1 - x0) * width
        py = lambda y: top + height - (y - y0) / (y1 - y0) * height
        out = [f'<g class="axes"><rect x="{left:.2f}" y="{top:.2f}" width="{width:.2f}" '
               f'height="{height:.2f}" fill="white" stroke="black"/>']
        for t in nice_ticks(x0, x1):
            out.append(f'<line x1="{px(t):.2f}" y1="{top + height:.2f}" x2="{px(t):.2f}" '
                       f'y2="{top + height + 4:.2f}" stroke="black"/><text x="{px(t):.2f}" '
                       f'y="{top + height + 16:.2f}" text-anchor="middle" {_FONT}>{t:g}</text>')
        for t in nice_ticks(y0, y1):
            out.append(f'<line x1="{left - 4:.2f}" y1="{py(t):.2f}" x2="{left:.2f}" y2="{py(t):.2f}" '
                       f'stroke="black"/><text x="{left - 6:.2f}" y="{py(t) + 4:.2f}" '
                       f'text-anchor="end" {_FONT}>{t:g}</text>')
        out.append(f'<clipPath id="clip{index}"><rect x="{left:.2f}" y="{top:.2f}" '
                   f'width="{width:.2f}" height="{height:.2f}"/></clipPath>'
                   f'<g clip-path="url(#clip{index})">')
        for s in self.series:
            out.append(self._series_svg(s, px, py))
        out.append("</g>")
        if self.title is not None:
            out.append(f'<text x="{left + width / 2:.2f}" y="{top - 8:.2f}" text-anchor="middle" '
                       f'font-family="sans-serif" font-size="13">{escape(self.title)}</text>')
        if self.show_legend:
            out.append(self._legend_svg())
        out.append("</g>")
        return out

    def _series_svg(self, s: dict, px, py) -> str:
        color, alpha, kind = s["color"], s["alpha"], s["kind"]
        label = "" if s["label"] is None else f" data-label={quoteattr(s['label'])}"
        if kind == "stairs":
            e, c = s["edges"], s["values"]
            d = [f"M{px(e[0]):.2f},{py(0.0):.2f}"]
            for i, count in enumerate(c):
                d.append(f"L{px(e[i]):.2f},{py(count):.2f}L{px(e[i + 1]):.2f},{py(count):.2f}")
            d.append(f"L{px(e[-1]):.2f},{py(0.0):.2f}")
            fill = f'fill="{color}" fill-opacity="{alpha}"' if s["fill"] else 'fill="none"'
            return (f'<path class="stairs"{label}{_data("values", c)}{_data("edges", e)} '
                    f'd="{"".join(d)}" {fill} stroke="{color}" stroke-opacity="{alpha}"/>')
        ok = np.isfinite(s["x"]) & np.isfinite(s["y"])
        if kind == "scatter":
            dots = "".join(f'<circle cx="{px(x):.2f}" cy="{py(y):.2f}" r="3"/>'
                           for x, y in zip(s["x"][ok], s["y"][ok]))
            return (f'<g class="scatter"{label}{_data("x", s["x"])}{_data("y", s["y"])} '
                    f'fill="{color}" fill-opacity="{alpha}">{dots}</g>')
        if kind == "line":
            pts = " ".join(f"{px(x):.2f},{py(y):.2f}" for x, y in zip(s["x"][ok], s["y"][ok]))
            return (f'<polyline class="line"{label}{_data("x", s["x"])}{_data("y", s["y"])} '
                    f'points="{pts}" fill="none" stroke="{color}" stroke-width="1.5"/>')
        # quiver: arrows in pixels, u and v scaled alike.
        ok &= np.isfinite(s["u"]) & np.isfinite(s["v"])
        norm = np.hypot(s["u"][ok], s["v"][ok])
        spacing = self.box[2] / max(math.sqrt(max(int(ok.sum()), 1)), 1.0)
        k = 0.9 * spacing / norm.max() if norm.size and norm.max() > 0 else 0.0
        arrows = []
        for x, y, u, v in zip(s["x"][ok], s["y"][ok], s["u"][ok], s["v"][ok]):
            xa, ya = px(x), py(y)
            xb, yb = xa + k * u, ya - k * v
            length = math.hypot(xb - xa, yb - ya)
            if length == 0:
                continue
            ux, uy = (xb - xa) / length, (yb - ya) / length
            h = min(6.0, 0.4 * length)
            head = (f"{xb - h * ux - 0.5 * h * uy:.2f},{yb - h * uy + 0.5 * h * ux:.2f} "
                    f"{xb:.2f},{yb:.2f} {xb - h * ux + 0.5 * h * uy:.2f},{yb - h * uy - 0.5 * h * ux:.2f}")
            arrows.append(f'<line x1="{xa:.2f}" y1="{ya:.2f}" x2="{xb:.2f}" y2="{yb:.2f}"/>'
                          f'<polyline points="{head}" fill="none"/>')
        return (f'<g class="quiver"{_data("x", s["x"])}{_data("y", s["y"])}{_data("u", s["u"])}'
                f'{_data("v", s["v"])} stroke="black" stroke-width="1">{"".join(arrows)}</g>')

    def _legend_svg(self) -> str:
        left, top, width, _ = self.box
        labelled = [s for s in self.series if s["label"] is not None]
        x, y = left + width - 150, top + 8
        rows = [f'<rect x="{x:.2f}" y="{y:.2f}" width="142" height="{8 + 16 * len(labelled)}" '
                f'fill="white" fill-opacity="0.8" stroke="#cccccc"/>']
        for i, s in enumerate(labelled):
            yy = y + 4 + 16 * i
            rows.append(f'<rect x="{x + 6:.2f}" y="{yy + 2:.2f}" width="16" height="9" '
                        f'fill="{s["color"]}" fill-opacity="{s["alpha"]}"/><text x="{x + 28:.2f}" '
                        f'y="{yy + 11:.2f}" {_FONT}>{escape(s["label"])}</text>')
        return f'<g class="legend">{"".join(rows)}</g>'


class Figure:
    """``nrows x ncols`` axes (``axes``, row by row) on a ``figsize`` of
    inches at 100 pixels an inch."""

    def __init__(self, nrows: int = 1, ncols: int = 1, figsize: Sequence[float] = (6.4, 4.8)):
        self.width, self.height = figsize[0] * DPI, figsize[1] * DPI
        cw, ch = self.width / ncols, self.height / nrows
        self.axes = [Axes((c * cw + 55, r * ch + 30, cw - 75, ch - 60))
                     for r in range(nrows) for c in range(ncols)]

    def to_svg(self) -> str:
        body = [line for i, ax in enumerate(self.axes) for line in ax.svg(i)]
        return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{self.width:.0f}" '
                f'height="{self.height:.0f}" viewBox="0 0 {self.width:.0f} {self.height:.0f}">'
                f'<rect width="100%" height="100%" fill="white"/>' + "\n".join(body) + "</svg>\n")

    def savefig(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_svg())
