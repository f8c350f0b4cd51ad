"""Live training dashboard, the visdom ``Logger`` / ``Visualizer`` role
(counterpart of ``cistar_tpu/utils/dashboard.py``).

The reference pushes losses and current images to a visdom server
(``CycleGAN/utils.py:19-91``, ``p2pHD/util/visualizer.py``). Here a
stdlib HTTP server tails the experiment dir's ``live_log.jsonl`` /
``loss_log.jsonl`` (written by :class:`~cistar_tpu_torch.utils.metrics.
MetricsLogger`) and serves an auto-refreshing page with the loss curves
(an SVG line chart with a crosshair tooltip, and a table view), the
throughput and the latest saved images:

    python -m cistar_tpu_torch.apps.dashboard --dir checkpoints/r2l_MSRB_7

Default port 8097 (visdom's). Data endpoints: ``/data`` (JSON series),
``/images/<name>`` (PNGs found under the experiment dir). No device is
involved.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

__all__ = ["parse_history", "LiveDashboard", "INDEX_HTML"]

_MAX_POINTS = 2000  # downsample beyond this so the page stays light


def parse_history(exp_dir: str) -> Dict[str, object]:
    """Read the fine-grained live log (fallback: per-epoch log) into
    ``{"x": [...], "epoch": [...], "series": {name: [...]}}`` with NaN-holes
    for records missing a key."""
    path = os.path.join(exp_dir, "live_log.jsonl")
    per_epoch = False
    if not os.path.exists(path):
        path = os.path.join(exp_dir, "loss_log.jsonl")
        per_epoch = True
    records: List[dict] = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn tail write during training
    if len(records) > _MAX_POINTS:
        stride = -(-len(records) // _MAX_POINTS)
        records = records[::stride]
    keys = sorted({k for r in records for k in r
                   if k not in ("epoch", "batch")})
    series = {k: [r.get(k) for r in records] for k in keys}
    return {
        "x": list(range(len(records))),
        "epoch": [r.get("epoch", 0) for r in records],
        "batch": [r.get("batch", 0) for r in records],
        "per_epoch": per_epoch,
        "series": series,
    }


_IMG_CACHE: Dict[str, Tuple[float, List[str]]] = {}


def _list_images(exp_dir: str, limit: int = 12) -> List[str]:
    """Newest PNGs under the experiment dir (incl. ``web/images``),
    exp_dir-relative paths. The recursive walk + per-file stat is cached for
    a few seconds so the 3 s poll of every open dashboard tab doesn't turn
    into a continuous stat storm on checkpoint-heavy experiment dirs."""
    import time as _time

    now = _time.time()
    hit = _IMG_CACHE.get(exp_dir)
    if hit is not None and now - hit[0] < 2.5:
        return hit[1]
    found: List[Tuple[float, str]] = []
    for base, _dirs, files in os.walk(exp_dir):
        for fn in files:
            if fn.lower().endswith((".png", ".jpg", ".jpeg")):
                p = os.path.join(base, fn)
                found.append((os.path.getmtime(p),
                              os.path.relpath(p, exp_dir)))
    found.sort(reverse=True)
    out = [rel for _t, rel in found[:limit]]
    _IMG_CACHE[exp_dir] = (now, out)
    return out


def _sanitize(obj):
    """Replace non-finite floats with None, recursively (valid strict JSON)."""
    if isinstance(obj, float):
        return obj if obj == obj and obj not in (float("inf"), float("-inf")) \
            else None
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


class _Handler(BaseHTTPRequestHandler):
    exp_dir: str = "."

    def _send(self, code: int, ctype: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args) -> None:  # quiet
        pass

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if self.path in ("/", "/index.html"):
            page = INDEX_HTML.replace("__TITLE__",
                                      os.path.basename(self.exp_dir) or "run")
            self._send(200, "text/html; charset=utf-8", page.encode())
        elif self.path == "/data":
            data = parse_history(self.exp_dir)
            data["images"] = _list_images(self.exp_dir)
            # bare NaN/Infinity is invalid JSON — the browser's
            # response.json() rejects it and the page freezes on the last
            # good frame; map non-finite floats to null (renders as holes)
            self._send(200, "application/json",
                       json.dumps(_sanitize(data)).encode())
        elif self.path.startswith("/images/"):
            rel = self.path[len("/images/"):]
            base = os.path.realpath(self.exp_dir)
            full = os.path.realpath(os.path.join(base, rel))
            # traversal guard AND extension allowlist: the experiment dir
            # also holds checkpoints/configs that must not be served
            if full.startswith(base + os.sep) and os.path.isfile(full) \
                    and full.lower().endswith((".png", ".jpg", ".jpeg")):
                with open(full, "rb") as f:
                    self._send(200, "image/png", f.read())
            else:
                self._send(404, "text/plain", b"not found")
        else:
            self._send(404, "text/plain", b"not found")


class LiveDashboard:
    """Serve ``exp_dir`` on ``port`` (0 = ephemeral); non-blocking."""

    def __init__(self, exp_dir: str, port: int = 8097, host: str = "0.0.0.0"):
        handler = type("Handler", (_Handler,), {"exp_dir": exp_dir})
        self.server = ThreadingHTTPServer((host, port), handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "LiveDashboard":
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()

    def serve_forever(self) -> None:
        print(f"live dashboard: http://localhost:{self.port}/")
        self.server.serve_forever()


# The page: CSS role tokens (light + dark from the validated default palette),
# SVG line chart with fixed-slot categorical colors, crosshair tooltip listing
# every series at the nearest X, legend with line keys, table view, image
# strip. Data refreshes every 3 s and keeps the previous frame while loading.
INDEX_HTML = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>__TITLE__ — training</title>
<style>
.viz-root {
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f4f3ef;
  --text-primary: #0b0b0b; --text-secondary: #52514e; --grid: #e4e2da;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #232322;
    --text-primary: #ffffff; --text-secondary: #c3c2b7; --grid: #3a3936;
  }
}
html, body { margin: 0; background: var(--surface-1); }
.viz-root { font: 14px/1.45 system-ui, sans-serif; color: var(--text-primary);
  background: var(--surface-1); min-height: 100vh; padding: 20px 24px; }
h1 { font-size: 17px; margin: 0 0 2px; }
.sub { color: var(--text-secondary); font-size: 12.5px; margin-bottom: 14px; }
.tiles { display: flex; gap: 10px; flex-wrap: wrap; margin-bottom: 16px; }
.tile { background: var(--surface-2); border-radius: 8px; padding: 8px 14px; }
.tile .v { font-size: 19px; font-weight: 650; font-variant-numeric: tabular-nums; }
.tile .k { color: var(--text-secondary); font-size: 11.5px; }
.card { background: var(--surface-2); border-radius: 10px; padding: 14px 16px;
  margin-bottom: 16px; }
.legend { display: flex; gap: 14px; flex-wrap: wrap; margin: 2px 0 8px;
  font-size: 12.5px; color: var(--text-secondary); }
.legend span.key { display: inline-block; width: 14px; height: 0;
  border-top: 2.5px solid; vertical-align: middle; margin-right: 5px;
  border-radius: 2px; }
svg text { fill: var(--text-secondary); font: 11px system-ui, sans-serif; }
#tip { position: fixed; pointer-events: none; background: var(--surface-1);
  border: 1px solid var(--grid); border-radius: 7px; padding: 7px 10px;
  font-size: 12px; display: none; box-shadow: 0 2px 10px rgba(0,0,0,.18);
  z-index: 5; }
#tip .row { display: flex; align-items: center; gap: 6px; }
#tip .val { font-weight: 650; color: var(--text-primary);
  font-variant-numeric: tabular-nums; margin-left: auto; padding-left: 10px; }
#tip .name { color: var(--text-secondary); }
#tip span.key { display: inline-block; width: 12px; height: 0;
  border-top: 2.5px solid; border-radius: 2px; }
details { margin-top: 6px; color: var(--text-secondary); }
table { border-collapse: collapse; font-size: 12px; margin-top: 8px;
  font-variant-numeric: tabular-nums; }
td, th { padding: 3px 10px; border-bottom: 1px solid var(--grid);
  text-align: right; color: var(--text-primary); }
th { color: var(--text-secondary); font-weight: 600; }
.imgs { display: flex; gap: 10px; flex-wrap: wrap; }
.imgs figure { margin: 0; }
.imgs img { max-width: 220px; border-radius: 6px; display: block;
  background: var(--surface-1); }
.imgs figcaption { font-size: 11px; color: var(--text-secondary);
  margin-top: 3px; max-width: 220px; overflow-wrap: anywhere; }
</style></head>
<body class="viz-root">
<h1>__TITLE__</h1>
<div class="sub" id="sub">waiting for first data…</div>
<div class="tiles" id="tiles"></div>
<div class="card">
  <div class="legend" id="legend"></div>
  <svg id="chart" width="100%" height="340" role="img"
       aria-label="loss curves over training"></svg>
  <details><summary>table view (last 15 records)</summary>
    <div id="tablewrap"></div></details>
</div>
<div class="card"><div class="imgs" id="imgs"></div></div>
<div id="tip"></div>
<script>
"use strict";
const LIGHT = ["#2a78d6","#eb6834","#1baf7a","#eda100","#e87ba4","#008300",
               "#4a3aa7","#e34948"];
const DARK  = ["#3987e5","#d95926","#199e70","#c98500","#d55181","#008300",
               "#9085e9","#e66767"];
const mq = window.matchMedia("(prefers-color-scheme: dark)");
const palette = () => (mq.matches ? DARK : LIGHT);
let D = null;          // latest /data payload
let layout = null;     // geometry of the last render (for the crosshair)

function fmt(v) {
  if (v === null || v === undefined || Number.isNaN(v)) return "–";
  const a = Math.abs(v);
  return a >= 100 ? v.toFixed(1) : a >= 1 ? v.toFixed(3) : v.toPrecision(3);
}

function render() {
  if (!D || !D.x.length) return;
  // throughput is a different measure than the losses — never on the loss
  // axis (one-axis rule); it lives in the tiles and the table instead
  const keys = Object.keys(D.series).filter(k => k !== "img_per_s");
  const charted = keys.slice(0, 8);          // fixed slots, never cycled
  const pal = palette();
  const svg = document.getElementById("chart");
  const W = svg.clientWidth, H = 340, L = 52, R = 86, T = 12, B = 30;
  const xs = D.x, n = xs.length;
  let lo = Infinity, hi = -Infinity;
  for (const k of charted) for (const v of D.series[k])
    if (v !== null && isFinite(v)) { lo = Math.min(lo, v); hi = Math.max(hi, v); }
  if (!isFinite(lo)) { lo = 0; hi = 1; }
  if (hi - lo < 1e-12) { hi = lo + 1; }
  const px = i => L + (n === 1 ? 0 : (W - L - R) * i / (n - 1));
  const py = v => T + (H - T - B) * (1 - (v - lo) / (hi - lo));
  const NS = "http://www.w3.org/2000/svg";
  const el = (t, at) => { const e = document.createElementNS(NS, t);
    for (const k in at) e.setAttribute(k, at[k]); return e; };
  svg.textContent = "";
  // recessive grid + y ticks
  for (let g = 0; g <= 4; g++) {
    const v = lo + (hi - lo) * g / 4, y = py(v);
    svg.appendChild(el("line", {x1: L, x2: W - R, y1: y, y2: y,
      stroke: "var(--grid)", "stroke-width": 1}));
    const t = el("text", {x: L - 6, y: y + 3, "text-anchor": "end"});
    t.textContent = fmt(v); svg.appendChild(t);
  }
  const xt = el("text", {x: (L + W - R) / 2, y: H - 8,
    "text-anchor": "middle"});
  xt.textContent = D.per_epoch ? "epoch" : "log step"; svg.appendChild(xt);
  charted.forEach((k, si) => {
    let d = "", pen = false;
    for (let i = 0; i < n; i++) {
      const v = D.series[k][i];
      if (v === null || !isFinite(v)) { pen = false; continue; }
      d += (pen ? "L" : "M") + px(i).toFixed(1) + "," + py(v).toFixed(1);
      pen = true;
    }
    svg.appendChild(el("path", {d, fill: "none", stroke: pal[si],
      "stroke-width": 2, "stroke-linejoin": "round"}));
    if (charted.length <= 4) {          // selective direct labels at line end
      let last = null;
      for (let i = n - 1; i >= 0; i--) {
        const v = D.series[k][i];
        if (v !== null && isFinite(v)) { last = [i, v]; break; }
      }
      if (last) {
        const t = el("text", {x: px(last[0]) + 6, y: py(last[1]) + 3});
        t.textContent = k; t.style.fill = pal[si]; svg.appendChild(t);
      }
    }
  });
  layout = {L, R, T, B, W, H, n, px};
  // legend (always, with line keys)
  const lg = document.getElementById("legend"); lg.textContent = "";
  keys.forEach((k, si) => {
    const item = document.createElement("span");
    const key = document.createElement("span");
    key.className = "key";
    key.style.borderTopColor = si < 8 ? pal[si] : "transparent";
    item.appendChild(key);
    item.appendChild(document.createTextNode(
      si < 8 ? k : k + " (table only)"));
    lg.appendChild(item);
  });
  // stat tiles: epoch + latest value per series (first 4) + throughput
  const tiles = document.getElementById("tiles"); tiles.textContent = "";
  const tile = (k, v) => { const d = document.createElement("div");
    d.className = "tile";
    const dv = document.createElement("div"); dv.className = "v";
    dv.textContent = v;
    const dk = document.createElement("div"); dk.className = "k";
    dk.textContent = k; d.appendChild(dv); d.appendChild(dk);
    tiles.appendChild(d); };
  tile("epoch", String(D.epoch[n - 1]));
  keys.slice(0, 4).forEach(k => { tile(k, fmt(D.series[k][n - 1])); });
  if (D.series.img_per_s) tile("img/s", fmt(D.series.img_per_s[n - 1]));
  document.getElementById("sub").textContent =
    n + " records · " + keys.length + " series · refreshes every 3 s";
  // table view (all series, throughput included)
  const allKeys = Object.keys(D.series);
  const tw = document.getElementById("tablewrap"); tw.textContent = "";
  const tab = document.createElement("table");
  const hr = document.createElement("tr");
  for (const h of ["epoch", "batch", ...allKeys]) {
    const th = document.createElement("th"); th.textContent = h;
    hr.appendChild(th); }
  tab.appendChild(hr);
  for (let i = Math.max(0, n - 15); i < n; i++) {
    const tr = document.createElement("tr");
    for (const v of [D.epoch[i], D.batch[i],
                     ...allKeys.map(k => fmt(D.series[k][i]))]) {
      const td = document.createElement("td"); td.textContent = String(v);
      tr.appendChild(td); }
    tab.appendChild(tr);
  }
  tw.appendChild(tab);
  // images
  const im = document.getElementById("imgs"); im.textContent = "";
  for (const rel of D.images || []) {
    const fig = document.createElement("figure");
    const img = document.createElement("img");
    img.src = "/images/" + rel; img.alt = rel; img.loading = "lazy";
    const cap = document.createElement("figcaption"); cap.textContent = rel;
    fig.appendChild(img); fig.appendChild(cap); im.appendChild(fig);
  }
}

// crosshair + tooltip: nearest X, every series listed, value leads
const svgEl = document.getElementById("chart");
const tip = document.getElementById("tip");
let hair = null;
svgEl.addEventListener("pointermove", ev => {
  if (!layout || !D) return;
  const r = svgEl.getBoundingClientRect();
  const x = ev.clientX - r.left;
  const {L, R, W, T, H, B, n, px} = layout;
  if (x < L || x > W - R) { tip.style.display = "none";
    if (hair) hair.remove(), hair = null; return; }
  const i = Math.max(0, Math.min(n - 1,
    Math.round((x - L) / (W - L - R) * (n - 1))));
  if (!hair) {
    hair = document.createElementNS("http://www.w3.org/2000/svg", "line");
    hair.setAttribute("stroke", "var(--text-secondary)");
    hair.setAttribute("stroke-width", "1");
    hair.setAttribute("stroke-dasharray", "3,3");
    svgEl.appendChild(hair);
  }
  hair.setAttribute("x1", px(i)); hair.setAttribute("x2", px(i));
  hair.setAttribute("y1", T); hair.setAttribute("y2", H - B);
  const pal = palette();
  tip.textContent = "";
  const head = document.createElement("div");
  head.className = "name";
  head.textContent = "epoch " + D.epoch[i] +
    (D.per_epoch ? "" : " · batch " + D.batch[i]);
  tip.appendChild(head);
  Object.keys(D.series).filter(k => k !== "img_per_s").slice(0, 8)
      .forEach((k, si) => {
    const row = document.createElement("div"); row.className = "row";
    const key = document.createElement("span"); key.className = "key";
    key.style.borderTopColor = pal[si];
    const nm = document.createElement("span"); nm.className = "name";
    nm.textContent = k;
    const val = document.createElement("span"); val.className = "val";
    val.textContent = fmt(D.series[k][i]);
    row.appendChild(key); row.appendChild(nm); row.appendChild(val);
    tip.appendChild(row);
  });
  tip.style.display = "block";
  const tw = tip.offsetWidth;
  tip.style.left = Math.min(ev.clientX + 14,
                            window.innerWidth - tw - 8) + "px";
  tip.style.top = (ev.clientY + 14) + "px";
});
svgEl.addEventListener("pointerleave", () => {
  tip.style.display = "none"; if (hair) { hair.remove(); hair = null; } });

async function tick() {
  try {
    const r = await fetch("/data");
    D = await r.json();
    render();
  } catch (e) { /* keep previous frame */ }
  setTimeout(tick, 3000);
}
mq.addEventListener("change", render);
window.addEventListener("resize", render);
tick();
</script></body></html>
"""
