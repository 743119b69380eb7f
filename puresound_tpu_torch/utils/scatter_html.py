"""Dependency-free interactive scatter-plot HTML export (a copy of
puresound_tpu/utils/scatter_html.py, standard library only, which the port
keeps as its own: it imports nothing of the JAX package).

PureSound's tSNE action writes a plotly HTML (its egs/tse/main.py:283-348);
this emits a self-contained HTML/SVG page with the same interactions (hover
tooltip with speaker + utterance id, legend click to toggle a speaker, zoom
via mouse wheel) and no runtime dependency.
"""
from __future__ import annotations

import json
from typing import Sequence

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: sans-serif; margin: 1em; }}
 #plot {{ border: 1px solid #ccc; cursor: crosshair; }}
 #tip {{ position: absolute; background: #222; color: #fff; padding: 3px 7px;
        border-radius: 3px; font-size: 12px; pointer-events: none;
        visibility: hidden; }}
 .leg {{ display: inline-block; margin: 2px 8px; cursor: pointer;
        font-size: 13px; user-select: none; }}
 .leg.off {{ opacity: 0.25; }}
</style></head>
<body>
<h3>{title}</h3>
<div id="legend"></div>
<svg id="plot" width="{w}" height="{h}"></svg>
<div id="tip"></div>
<script>
const pts = {points};
const groups = {groups};
const W = {w}, H = {h}, PAD = 30;
const colors = ["#1f77b4","#ff7f0e","#2ca02c","#d62728","#9467bd",
  "#8c564b","#e377c2","#7f7f7f","#bcbd22","#17becf","#aec7e8","#ffbb78",
  "#98df8a","#ff9896","#c5b0d5","#c49c94","#f7b6d2","#c7c7c7","#dbdb8d",
  "#9edae5"];
const svg = document.getElementById("plot");
const tip = document.getElementById("tip");
let xs = pts.map(p => p[0]), ys = pts.map(p => p[1]);
let x0 = Math.min(...xs), x1 = Math.max(...xs);
let y0 = Math.min(...ys), y1 = Math.max(...ys);
let scale = 1.0, offx = 0, offy = 0;
const off = new Set();
function sx(x) {{ return PAD + (x - x0) / (x1 - x0 || 1) * (W - 2*PAD) * scale + offx; }}
function sy(y) {{ return H - PAD - (y - y0) / (y1 - y0 || 1) * (H - 2*PAD) * scale + offy; }}
function draw() {{
  svg.innerHTML = "";
  pts.forEach((p, i) => {{
    if (off.has(p[2])) return;
    const c = document.createElementNS("http://www.w3.org/2000/svg", "circle");
    c.setAttribute("cx", sx(p[0])); c.setAttribute("cy", sy(p[1]));
    c.setAttribute("r", 4); c.setAttribute("fill-opacity", 0.6);
    c.setAttribute("fill", colors[groups.indexOf(p[2]) % colors.length]);
    c.addEventListener("mousemove", ev => {{
      tip.style.visibility = "visible";
      tip.style.left = (ev.pageX + 12) + "px";
      tip.style.top = (ev.pageY + 12) + "px";
      tip.textContent = p[2] + " | " + p[3];
    }});
    c.addEventListener("mouseout", () => tip.style.visibility = "hidden");
    svg.appendChild(c);
  }});
}}
const legend = document.getElementById("legend");
groups.forEach(g => {{
  const s = document.createElement("span");
  s.className = "leg";
  s.style.color = colors[groups.indexOf(g) % colors.length];
  s.textContent = "\\u25cf " + g;
  s.addEventListener("click", () => {{
    if (off.has(g)) {{ off.delete(g); s.classList.remove("off"); }}
    else {{ off.add(g); s.classList.add("off"); }}
    draw();
  }});
  legend.appendChild(s);
}});
svg.addEventListener("wheel", ev => {{
  ev.preventDefault();
  scale *= ev.deltaY < 0 ? 1.15 : 1/1.15;
  scale = Math.max(0.2, Math.min(20, scale));
  draw();
}});
draw();
</script></body></html>
"""


def write_scatter_html(path: str, xy, labels: Sequence[str],
                       names: Sequence[str], title: str = "t-SNE",
                       width: int = 760, height: int = 640) -> str:
    """Write an interactive scatter page.

    xy: [N, 2] array-like; labels: per-point group (speaker); names:
    per-point hover text (utterance id). Returns the path.
    """
    points = [[float(x), float(y), str(l), str(n)]
              for (x, y), l, n in zip(xy, labels, names)]
    groups = sorted(set(str(l) for l in labels))
    html = _PAGE.format(title=title, points=json.dumps(points),
                        groups=json.dumps(groups), w=width, h=height)
    with open(path, "w") as f:
        f.write(html)
    return path
