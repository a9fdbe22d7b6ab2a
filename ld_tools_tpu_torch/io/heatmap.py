"""Heatmap rendering: plotly-figure-schema JSON + self-contained HTML (a
copy of ld_tools_tpu/io/heatmap.py: the files it writes are the JAX
tool's byte for byte).

The reference renders with the plotly library (ld_triangle.py:239-340).
This environment has no plotly package, and the output contract is (a) an
interactive HTML heatmap with per-cell hover annotations and (b) an
optional JSON dump of the figure object (`-j` flag, ld_triangle.py:333-336).
Both are produced here without plotly: the JSON follows plotly's figure
schema (data/layout) so existing downstream tooling can parse it, and the
HTML embeds a small canvas renderer (no external assets — works offline,
matching the reference's fully-offline operation after prep).

All 45 palette names the reference accepts (its README palette list) are
recognized; colors follow the standard sequential colormaps of the same
names.
"""

from __future__ import annotations

import json

# name -> gradient stops (position in [0,1], "#rrggbb").  ColorBrewer
# families use their published 3-stop skeletons; cmocean/carto families use
# representative endpoints of the public colormaps of the same name.
PALETTES = {
    "algae": ["#d7f9d0", "#4cab68", "#0a2b16"],
    "amp": ["#f1ecec", "#d65f5f", "#3c0911"],
    "blues": ["#f7fbff", "#6baed6", "#08306b"],
    "blugrn": ["#d5efdb", "#63a97f", "#1d4f60"],
    "bluyl": ["#f7feae", "#46aea0", "#045275"],
    "brwnyl": ["#ede5cf", "#c1766f", "#541f3f"],
    "bugn": ["#f7fcfd", "#66c2a4", "#00441b"],
    "bupu": ["#f7fcfd", "#8c96c6", "#4d004b"],
    "burg": ["#ffc6c4", "#cc607d", "#672044"],
    "burgyl": ["#fbe6c5", "#dc7176", "#70284a"],
    "darkmint": ["#d2fbd4", "#559c9e", "#123f5a"],
    "deep": ["#fdfecc", "#4e7cad", "#271a2c"],
    "dense": ["#e6f1f1", "#7c6bb0", "#360e24"],
    "emrld": ["#d3f2a3", "#4c9b82", "#074050"],
    "gnbu": ["#f7fcf0", "#7bccc4", "#084081"],
    "greens": ["#f7fcf5", "#74c476", "#00441b"],
    "greys": ["#ffffff", "#969696", "#000000"],
    "magenta": ["#f3cbd3", "#ca699d", "#6c2167"],
    "matter": ["#feedb0", "#c4594e", "#2f0f3e"],
    "mint": ["#e4f1e1", "#63a6a0", "#0d585f"],
    "oranges": ["#fff5eb", "#fd8d3c", "#7f2704"],
    "orrd": ["#fff7ec", "#fc8d59", "#7f0000"],
    "oryel": ["#ecda9a", "#f66356", "#ee4d5a"],
    "peach": ["#fde0c5", "#f59e72", "#eb4a40"],
    "pinkyl": ["#fef6b5", "#f3809c", "#e15383"],
    "pubu": ["#fff7fb", "#74a9cf", "#023858"],
    "pubugn": ["#fff7fb", "#67a9cf", "#014636"],
    "purd": ["#f7f4f9", "#df65b0", "#67001f"],
    "purp": ["#f3e0f7", "#9f82ce", "#63589f"],
    "purples": ["#fcfbfd", "#9e9ac8", "#3f007d"],
    "purpor": ["#f9ddda", "#c76a9e", "#573b88"],
    "rdpu": ["#fff7f3", "#f768a1", "#49006a"],
    "redor": ["#f6d2a9", "#ea8171", "#b13f64"],
    "reds": ["#fff5f0", "#fb6a4a", "#67000d"],
    "speed": ["#fffdcd", "#7a9b26", "#172313"],
    "sunset": ["#f3e79b", "#eb7f86", "#5c53a5"],
    "sunsetdark": ["#fcde9c", "#e34f6f", "#7c1d6f"],
    "teal": ["#d1eeea", "#568f8b", "#2a5674"],
    "tealgrn": ["#b0f2bc", "#4cc8a3", "#257d98"],
    "tempo": ["#fff6f4", "#4f9e81", "#141d43"],
    "turbid": ["#e9f6ab", "#a57b4f", "#221f1b"],
    "ylgn": ["#ffffe5", "#78c679", "#004529"],
    "ylgnbu": ["#ffffd9", "#41b6c4", "#081d58"],
    "ylorbr": ["#ffffe5", "#fe9929", "#662506"],
    "ylorrd": ["#ffffcc", "#fd8d3c", "#800026"],
}


def colorscale_stops(name: str):
    key = str(name).lower()
    if key not in PALETTES:
        # the reference errors on unknown palettes too (plotly raises
        # inside ld_triangle.py); a silent greens fallback would hide
        # the typo
        raise ValueError(
            f"unknown color palette {name!r}; valid names: "
            + ", ".join(sorted(PALETTES))
        )
    stops = PALETTES[key]
    n = len(stops)
    return [[i / (n - 1), c] for i, c in enumerate(stops)]


def build_figure(
    ld_two_dim,
    info_two_dim,
    rs_ids,
    *,
    disp_letters: bool,
    color_pal: str,
    font_size,
    square_shape: bool,
    title_text: str,
    footer_text,
) -> dict:
    """Plotly-figure-schema dict for a lower-triangle LD heatmap.

    Mirrors the reference's figure structure: annotated heatmap with rsID
    axis labels when ``disp_letters`` (ld_triangle.py:246-269), bare
    heatmap with hidden tick labels otherwise (:279-290), reversed y axis
    (:317-319), footer smuggled in as the x-axis title (:320-329).
    """
    trace = {
        "type": "heatmap",
        "z": [list(row) for row in ld_two_dim],
        "hovertext": [list(row) for row in info_two_dim],
        "hoverinfo": "text",
        "xgap": 1,
        "ygap": 1,
        "colorscale": colorscale_stops(color_pal),
        "showscale": False,
    }
    layout = {
        "title": {"text": title_text},
        "xaxis": {"side": "bottom"},
        "yaxis": {"autorange": "reversed"},
    }
    if disp_letters:
        trace["x"] = list(rs_ids)
        trace["y"] = list(rs_ids)
        annotations = []
        n = len(ld_two_dim)
        for i in range(n):
            for j in range(n):
                ann = {
                    "text": str(ld_two_dim[i][j]),
                    "x": rs_ids[j],
                    "y": rs_ids[i],
                    "xref": "x",
                    "yref": "y",
                    "showarrow": False,
                }
                if font_size is not None:
                    ann["font"] = {"size": font_size}
                annotations.append(ann)
        layout["annotations"] = annotations
        if font_size is not None:
            layout["xaxis"]["tickfont"] = {"size": font_size}
            layout["yaxis"]["tickfont"] = {"size": font_size}
    else:
        layout["xaxis"]["showticklabels"] = False
        layout["yaxis"]["showticklabels"] = False
    if square_shape:
        layout["xaxis"]["constraintoward"] = "left"
        layout["yaxis"]["scaleanchor"] = "x"
        layout["yaxis"]["scaleratio"] = 1
        layout["plot_bgcolor"] = "rgba(0,0,0,0)"
    if footer_text is not None:
        layout["xaxis"]["title"] = {"text": footer_text, "font": {"size": 10}}
    return {"data": [trace], "layout": layout}


def write_json(path: str, figure: dict) -> None:
    with open(path, "w") as fh:
        json.dump(figure, fh, indent=2)


# --- columnar (O(n)-strings) hover payload --------------------------------
#
# Per-cell hovertext strings are O(n^2) x ~200 bytes: a 10k-variant figure
# would carry ~10 GB of JSON (VERDICT r3).  Past _HOVER_CELLS_MAX variants
# the figure switches to a columnar payload: the 4-dp value matrices ship
# as base64 int16 (value * 1e4; strict lower triangle, row-major) plus
# O(n) per-variant arrays, and the HTML canvas renderer assembles each
# hover string client-side in the reference's exact format
# (ld_triangle.py:200-213).  The z matrix is not shipped at all — the
# client derives it from the chosen measure and the threshold, exactly as
# the table writer does (sub-threshold cells render 0 but keep hover).

_HOVER_CELLS_MAX = 500  # per-cell strings keep byte parity up to here

# Quantized-code widths: uniform-ploidy LD values live in [-1, 1], so
# int16 codes (v * 1e4, sentinel magnitude 20001) suffice.  Mixed-ploidy
# (chrX) cross-profile pairs follow the reference's zip-truncation math,
# where frequencies exceed 1 and D'/r^2 are unbounded (calc_ld.py:30-90
# over unequal lists) — those figures use int32 codes with a far
# sentinel.  The sentinel encodes the reference's int-0 ('0'); its
# negation encodes IEEE -0.0 after round4 ('-0.0').
_Q_WIDTHS = {"i2": 20001, "i4": 1 << 30}


def encode_q_rows(
    values, int_zero, row_lo: int, row_hi: int, qdtype: str = "i2"
) -> bytes:
    """Quantize rows [row_lo, row_hi) of a 4-dp value block.

    ``values``: (row_hi - row_lo, >=row_hi) f64 block whose row k holds
    pair values of global variant row_lo + k; only the strict lower
    triangle (first row_lo + k entries) is kept.  Returns little-endian
    int16/int32 bytes: round(v * 1e4), with the int-0 sentinel and
    negative zero mapped to out-of-range codes.
    """
    import numpy as np

    sent = _Q_WIDTHS[qdtype]
    np_dt = np.int16 if qdtype == "i2" else np.int32
    out = []
    for k in range(row_hi - row_lo):
        i = row_lo + k
        row = np.asarray(values[k][:i], dtype=np.float64)
        q = np.clip(np.rint(row * 1e4), -(sent - 1), sent - 1).astype(np_dt)
        neg = (q == 0) & np.signbit(row)
        q[neg] = -sent
        iz = np.asarray(int_zero[k][:i], dtype=bool)
        q[iz] = sent
        out.append(q.astype(f"<{qdtype}").tobytes())
    return b"".join(out)


def build_figure_columnar(
    *,
    n: int,
    rs_ids,
    positions,
    alleles,
    types,
    measure: str,
    thres,
    r2_q: bytes,
    dp_q: bytes,
    color_pal: str,
    title_text: str,
    footer_text,
    square_shape: bool,
    freq_q=None,
    freq1_q: bytes = None,
    freq2_q: bytes = None,
    qdtype: str = "i2",
) -> dict:
    """Figure dict with the columnar hover payload (> _HOVER_CELLS_MAX).

    ``r2_q``/``dp_q``: int16/int32 (per ``qdtype``) strict-lower-triangle
    buffers from encode_q_rows, n*(n-1)/2 entries each.  ``freq_q`` is
    the O(n) per-variant alt-freq list (value * 1e4 ints) for
    uniform-ploidy chromosomes; mixed chromosomes pass pair-dependent
    ``freq1_q`` / ``freq2_q`` triangle buffers instead (reference
    calc_ld.py:37-44).
    """
    import base64

    width = 2 if qdtype == "i2" else 4
    expected = n * (n - 1) // 2 * width
    if len(r2_q) != expected or len(dp_q) != expected:
        raise ValueError(
            f"value buffers must hold n*(n-1)/2 {qdtype} codes "
            f"({expected} bytes); got {len(r2_q)}/{len(dp_q)}"
        )
    if freq_q is None and (
        freq1_q is None or freq2_q is None
        or len(freq1_q) != expected or len(freq2_q) != expected
    ):
        raise ValueError(
            "mixed-ploidy figures need freq1_q/freq2_q triangle buffers "
            "of the same size as the value buffers"
        )
    columnar = {
        "n": n,
        "measure": measure,
        "thres": thres,
        "qw": width,
        "qs": _Q_WIDTHS[qdtype],
        "rsids": list(rs_ids),
        "pos": [int(p) for p in positions],
        "alleles": list(alleles),
        "types": list(types),
        "r2q": base64.b64encode(r2_q).decode(),
        "dpq": base64.b64encode(dp_q).decode(),
    }
    if freq_q is not None:
        columnar["freqq"] = [int(f) for f in freq_q]
    else:
        columnar["f1q"] = base64.b64encode(freq1_q).decode()
        columnar["f2q"] = base64.b64encode(freq2_q).decode()
    layout = {
        "title": {"text": title_text},
        "xaxis": {"side": "bottom", "showticklabels": False},
        "yaxis": {"autorange": "reversed", "showticklabels": False},
    }
    if square_shape:
        layout["xaxis"]["constraintoward"] = "left"
        layout["yaxis"]["scaleanchor"] = "x"
        layout["yaxis"]["scaleratio"] = 1
        layout["plot_bgcolor"] = "rgba(0,0,0,0)"
    if footer_text is not None:
        layout["xaxis"]["title"] = {"text": footer_text, "font": {"size": 10}}
    trace = {
        "type": "heatmap",
        "hoverinfo": "text",
        "xgap": 1,
        "ygap": 1,
        "colorscale": colorscale_stops(color_pal),
        "showscale": False,
    }
    return {"data": [trace], "layout": layout, "columnar": columnar}


# --- pooled overview payload (very large figures) --------------------------
#
# Even columnar, a 10k-variant figure ships ~100M int16 codes (267 MB of
# HTML).  Past _OVERVIEW_MIN variants the HTML switches to a pooled
# OVERVIEW: the pool grid max-pools f x f cell regions (f = ceil(n /
# _OVERVIEW_P)) by the color measure, and each pool cell carries its
# REPRESENTATIVE pair — the member pair maximizing max(measure, 0) — as
# (exact r2 code, exact dp code, i, j).  Hover shows that pair in the
# reference's exact format under a region banner; the full-resolution
# figure JSON (-j) is unchanged.  Mixed-ploidy (chrX int32-code) figures
# keep the full columnar payload — their sets never approach this size.

_OVERVIEW_MIN = 4096   # variants; above this the HTML pools (env-overridable
                       # by the tool layer)
_OVERVIEW_P = 2000     # target pool-grid side
_POOL_SHIFT = 17       # bits for each of i/j in the pooling composite


def pool_shape(n: int):
    """(f, P): pool factor and grid side for an n-variant overview."""
    f = -(-n // _OVERVIEW_P)
    return f, -(-n // f)


def pool_rows_composite(pooled, values, int_zero, row_lo: int, row_hi: int,
                        f: int) -> None:
    """Max-pool rows [row_lo, row_hi) of a rounded value block into the
    (P, P) int64 composite accumulator ``pooled`` (init -1).

    Composite = (key << 34) | (i << 17) | j with key = max(round(v*1e4),
    0) and int-0 sentinels as 0 — so the elementwise max picks the pair
    maximizing the displayed measure, and its (i, j) ride along for free.
    Supports n < 2^17 (131k variants — far past any sane heatmap).
    """
    import numpy as np

    rows = row_hi - row_lo
    if row_hi >= (1 << _POOL_SHIFT):
        raise ValueError(
            f"overview pooling supports up to {1 << _POOL_SHIFT} "
            "variants"
        )
    cols = np.asarray(values[0]).shape[0] if rows else 0
    if rows == 0 or cols == 0:
        return
    vals = np.asarray(values, dtype=np.float64)[:, :cols]
    q = np.rint(vals * 1e4).astype(np.int64)
    q[np.asarray(int_zero, dtype=bool)[:, :cols]] = 0
    np.maximum(q, 0, out=q)
    i_idx = np.arange(row_lo, row_hi, dtype=np.int64)[:, None]
    j_idx = np.arange(cols, dtype=np.int64)[None, :]
    comp = (q << 34) | (i_idx << _POOL_SHIFT) | j_idx
    comp[j_idx >= i_idx] = -1  # strict lower triangle only
    col_starts = np.arange(0, cols, f)
    colred = np.maximum.reduceat(comp, col_starts, axis=1)
    pr = np.arange(row_lo, row_hi) // f
    row_starts = np.concatenate(([0], np.flatnonzero(np.diff(pr)) + 1))
    rowred = np.maximum.reduceat(colred, row_starts, axis=0)
    pr_vals = pr[row_starts]
    w = colred.shape[1]
    # advanced indexing yields a copy — assign back explicitly
    pooled[pr_vals, :w] = np.maximum(pooled[pr_vals, :w], rowred)


def build_figure_overview(
    *,
    n: int,
    rs_ids,
    positions,
    alleles,
    types,
    measure: str,
    thres,
    pooled,
    r2_q: bytes,
    dp_q: bytes,
    color_pal: str,
    title_text: str,
    footer_text,
    square_shape: bool,
    freq_q,
) -> dict:
    """Figure dict with the pooled overview payload.

    ``pooled`` is the (P, P) composite accumulator filled by
    pool_rows_composite; ``r2_q``/``dp_q`` are the FULL int16 triangle
    buffers (the representative pairs' exact codes are gathered from
    them, then the full buffers are dropped — only O(P^2) survives into
    the HTML).
    """
    import base64

    import numpy as np

    f, P = pool_shape(n)
    if pooled.shape != (P, P):
        raise ValueError(
            f"pooled accumulator must be ({P}, {P}); got {pooled.shape}"
        )
    r2_full = np.frombuffer(r2_q, dtype="<i2")
    dp_full = np.frombuffer(dp_q, dtype="<i2")
    # pooled lower triangle INCLUDING the diagonal (diagonal pool cells
    # hold their sub-diagonal member pairs), row-major
    pi, pj = np.tril_indices(P)
    comp = pooled[pi, pj]
    valid = comp >= 0
    i_arr = ((comp >> _POOL_SHIFT) & ((1 << _POOL_SHIFT) - 1))
    j_arr = comp & ((1 << _POOL_SHIFT) - 1)
    t_full = (i_arr * (i_arr - 1)) // 2 + j_arr
    t_safe = np.where(valid, t_full, 0)
    r2o = np.where(valid, r2_full[t_safe], 0).astype("<i2")
    dpo = np.where(valid, dp_full[t_safe], 0).astype("<i2")
    io = np.where(valid, i_arr, -1).astype("<i4")
    jo = np.where(valid, j_arr, -1).astype("<i4")
    overview = {
        "n": n,
        "P": P,
        "f": f,
        "measure": measure,
        "thres": thres,
        "qs": _Q_WIDTHS["i2"],
        "rsids": list(rs_ids),
        "pos": [int(p) for p in positions],
        "alleles": list(alleles),
        "types": list(types),
        "freqq": [int(v) for v in freq_q],
        "r2o": base64.b64encode(r2o.tobytes()).decode(),
        "dpo": base64.b64encode(dpo.tobytes()).decode(),
        "io": base64.b64encode(io.tobytes()).decode(),
        "jo": base64.b64encode(jo.tobytes()).decode(),
    }
    layout = {
        "title": {"text": title_text},
        "xaxis": {"side": "bottom", "showticklabels": False},
        "yaxis": {"autorange": "reversed", "showticklabels": False},
    }
    if square_shape:
        layout["xaxis"]["constraintoward"] = "left"
        layout["yaxis"]["scaleanchor"] = "x"
        layout["yaxis"]["scaleratio"] = 1
        layout["plot_bgcolor"] = "rgba(0,0,0,0)"
    if footer_text is not None:
        layout["xaxis"]["title"] = {"text": footer_text, "font": {"size": 10}}
    trace = {
        "type": "heatmap",
        "hoverinfo": "text",
        "xgap": 1,
        "ygap": 1,
        "colorscale": colorscale_stops(color_pal),
        "showscale": False,
    }
    return {"data": [trace], "layout": layout, "overview": overview}


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>LD heatmap</title>
<style>
 body { font-family: sans-serif; margin: 12px; }
 #title { white-space: pre-line; font-size: 14px; }
 #footer { white-space: pre-line; font-size: 10px; color: #444; }
 #hint { font-size: 10px; color: #888; }
 #wrap { position: relative; display: inline-block; }
 #tip { position: absolute; display: none; background: #fff; border: 1px solid #888;
        padding: 6px 8px; font-size: 11px; pointer-events: none; z-index: 9;
        box-shadow: 0 1px 4px rgba(0,0,0,.3); max-width: 360px; }
 canvas { image-rendering: pixelated; cursor: crosshair; }
</style></head><body>
<div id="title"></div>
<div id="wrap"><canvas id="hm"></canvas><div id="tip"></div></div>
<div id="hint">scroll to zoom &#183; drag to pan &#183; double-click to reset</div>
<div id="footer"></div>
<script>
const FIG = __FIGURE_JSON__;
const trace = FIG.data[0];
const z = trace.z, info = trace.hovertext, n = z.length;
const stops = trace.colorscale;
const labels = trace.x || null;
const fontSize = (FIG.layout.xaxis.tickfont||{}).size || 11;
function hex2rgb(h) { return [parseInt(h.slice(1,3),16), parseInt(h.slice(3,5),16), parseInt(h.slice(5,7),16)]; }
function colorAt(t) {
  for (let k = 1; k < stops.length; k++) {
    if (t <= stops[k][0]) {
      const a = hex2rgb(stops[k-1][1]), b = hex2rgb(stops[k][1]);
      const u = (t - stops[k-1][0]) / (stops[k][0] - stops[k-1][0] || 1);
      return [0,1,2].map(i => Math.round(a[i] + (b[i]-a[i]) * u));
    }
  }
  return hex2rgb(stops[stops.length-1][1]);
}
let zmin = Infinity, zmax = -Infinity;
for (const row of z) for (const v of row) { if (v < zmin) zmin = v; if (v > zmax) zmax = v; }
if (zmax === zmin) zmax = zmin + 1;
const margin = labels ? 90 : 10;
const cell = Math.max(3, Math.min(28, Math.floor(900 / n)));
const gap = trace.xgap || 0;
const size = n * cell;
const canvas = document.getElementById('hm');
canvas.width = size + margin; canvas.height = size + margin;
const ctx = canvas.getContext('2d');
const showNums = __SHOW_NUMBERS__;
// Zoom/pan view state (plotly-modebar equivalents: wheel = zoom at
// cursor, drag = pan, double-click = reset).  ox/oy are the top-left
// origin in CELL units; s is the zoom factor.
let view = {s: 1, ox: 0, oy: 0};
function clampView() {
  const px = cell * view.s, span = size / px;
  view.ox = Math.min(Math.max(view.ox, 0), Math.max(0, n - span));
  view.oy = Math.min(Math.max(view.oy, 0), Math.max(0, n - span));
}
function draw() {
  const px = cell * view.s;
  ctx.fillStyle = '#ffffff'; ctx.fillRect(0, 0, canvas.width, canvas.height);
  // y autorange is reversed in the figure: row 0 renders at the top.
  const i0 = Math.max(0, Math.floor(view.oy));
  const i1 = Math.min(n, Math.ceil(view.oy + size / px));
  const j0 = Math.max(0, Math.floor(view.ox));
  const j1 = Math.min(n, Math.ceil(view.ox + size / px));
  for (let i = i0; i < i1; i++) for (let j = j0; j < j1; j++) {
    const c = colorAt((z[i][j] - zmin) / (zmax - zmin));
    ctx.fillStyle = `rgb(${c[0]},${c[1]},${c[2]})`;
    ctx.fillRect(margin + (j - view.ox) * px, (i - view.oy) * px,
                 px - gap, px - gap);
  }
  ctx.fillStyle = '#ffffff';
  ctx.fillRect(0, 0, margin, canvas.height);
  ctx.fillRect(0, size, canvas.width, canvas.height - size);
  if (labels) {
    ctx.fillStyle = '#000'; ctx.font = fontSize + 'px sans-serif';
    for (let j = j0; j < j1; j++) {
      ctx.save();
      ctx.translate(margin + (j - view.ox) * px + px / 2, size + 4);
      ctx.rotate(Math.PI / 2); ctx.textBaseline = 'middle';
      ctx.fillText(labels[j], 0, 0); ctx.restore();
    }
    ctx.textAlign = 'right'; ctx.textBaseline = 'middle';
    for (let i = i0; i < i1; i++) {
      ctx.fillText(labels[i], margin - 4, (i - view.oy) * px + px / 2);
    }
    if (showNums && px >= 14) {
      ctx.textAlign = 'center';
      for (let i = i0; i < i1; i++) for (let j = j0; j < j1; j++) {
        const t = (z[i][j] - zmin) / (zmax - zmin);
        ctx.fillStyle = t > 0.55 ? '#fff' : '#000';
        ctx.fillText(String(z[i][j]).slice(0, 6),
                     margin + (j - view.ox) * px + px / 2,
                     (i - view.oy) * px + px / 2);
      }
    }
    ctx.textAlign = 'left';
  }
}
let drawPending = false;
function scheduleDraw() {
  if (drawPending) return;
  drawPending = true;
  requestAnimationFrame(() => { drawPending = false; draw(); });
}
draw();
const tip = document.getElementById('tip');
let dragging = null;
canvas.addEventListener('wheel', ev => {
  ev.preventDefault();
  const r = canvas.getBoundingClientRect();
  const cx = ev.clientX - r.left - margin, cy = ev.clientY - r.top;
  const px = cell * view.s;
  const jC = view.ox + cx / px, iC = view.oy + cy / px;
  view.s = Math.min(64, Math.max(1, view.s * (ev.deltaY < 0 ? 1.25 : 0.8)));
  const npx = cell * view.s;
  view.ox = jC - cx / npx; view.oy = iC - cy / npx;
  clampView(); scheduleDraw();
});
canvas.addEventListener('mousedown', ev => {
  dragging = {x: ev.clientX, y: ev.clientY, ox: view.ox, oy: view.oy,
              moved: false};
});
window.addEventListener('mousemove', ev => {
  if (!dragging) return;
  const px = cell * view.s;
  dragging.moved = true;
  view.ox = dragging.ox - (ev.clientX - dragging.x) / px;
  view.oy = dragging.oy - (ev.clientY - dragging.y) / px;
  clampView(); scheduleDraw();
  tip.style.display = 'none';
});
window.addEventListener('mouseup', () => dragging = null);
canvas.addEventListener('dblclick', () => {
  view = {s: 1, ox: 0, oy: 0}; scheduleDraw();
});
canvas.addEventListener('mousemove', ev => {
  if (dragging) return;
  const r = canvas.getBoundingClientRect();
  const px = cell * view.s;
  const x = ev.clientX - r.left - margin, y = ev.clientY - r.top;
  const j = Math.floor(view.ox + x / px), i = Math.floor(view.oy + y / px);
  // bound by the DRAWN plot rect, not the zoomed logical extent — the
  // label margins must never hover a cell
  if (x >= 0 && x < size && y >= 0 && y < size
      && i >= 0 && i < n && j >= 0 && j < n && info[i][j]) {
    tip.innerHTML = info[i][j];
    tip.style.display = 'block';
    tip.style.left = (ev.clientX - r.left + 14) + 'px';
    tip.style.top = (ev.clientY - r.top + 14) + 'px';
  } else tip.style.display = 'none';
});
canvas.addEventListener('mouseleave', () => tip.style.display = 'none');
document.getElementById('title').textContent = (FIG.layout.title||{}).text || '';
const xt = ((FIG.layout.xaxis||{}).title||{}).text || '';
document.getElementById('footer').innerHTML = xt;
</script></body></html>
"""


_HTML_TEMPLATE_COLUMNAR = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>LD heatmap</title>
<style>
 body { font-family: sans-serif; margin: 12px; }
 #title { white-space: pre-line; font-size: 14px; }
 #footer { white-space: pre-line; font-size: 10px; color: #444; }
 #hint { font-size: 10px; color: #888; }
 #wrap { position: relative; display: inline-block; }
 #tip { position: absolute; display: none; background: #fff; border: 1px solid #888;
        padding: 6px 8px; font-size: 11px; pointer-events: none; z-index: 9;
        box-shadow: 0 1px 4px rgba(0,0,0,.3); max-width: 360px; }
 canvas { cursor: crosshair; }
</style></head><body>
<div id="title"></div>
<div id="wrap"><canvas id="hm"></canvas><div id="tip"></div></div>
<div id="hint">scroll to zoom &#183; drag to pan &#183; double-click to reset</div>
<div id="footer"></div>
<script>
// Columnar payload: per-variant arrays are O(n) strings; the 4-dp value
// matrices arrive as base64 int16 (value*1e4, strict lower triangle,
// row-major).  Hover text is assembled here in the reference's exact
// per-cell format (ld_triangle.py:200-213); z is derived from the chosen
// measure + threshold exactly like the table writer (sub-threshold cells
// render 0 but keep their true hover values).
const FIG = __FIGURE_JSON__;
const C = FIG.columnar, n = C.n;
const stops = FIG.data[0].colorscale;
const QW = C.qw, QS = C.qs;  // code byte width and sentinel magnitude
function b64q(s) {
  const bin = atob(s), m = bin.length / QW;
  const a = QW === 2 ? new Int16Array(m) : new Int32Array(m);
  if (QW === 2) {
    for (let k = 0; k < m; k++)
      a[k] = ((bin.charCodeAt(2*k) | (bin.charCodeAt(2*k+1) << 8)) << 16) >> 16;
  } else {
    for (let k = 0; k < m; k++)
      a[k] = bin.charCodeAt(4*k) | (bin.charCodeAt(4*k+1) << 8)
           | (bin.charCodeAt(4*k+2) << 16) | (bin.charCodeAt(4*k+3) << 24);
  }
  return a;
}
const r2q = b64q(C.r2q), dpq = b64q(C.dpq);
const f1q = C.f1q ? b64q(C.f1q) : null;
const f2q = C.f2q ? b64q(C.f2q) : null;
const measq = C.measure === "r_square" ? r2q : dpq;
const tri = (i, j) => i * (i - 1) / 2 + j;   // j < i
// str(round(v, 4)) reconstruction, including the int-0 sentinel ('0'),
// float zero ('0.0') and negative zero ('-0.0')
function fmt(m) {
  if (m === QS) return "0";
  if (m === -QS) return "-0.0";
  const sgn = m < 0 ? "-" : ""; m = Math.abs(m);
  const whole = Math.floor(m / 10000);
  let f = String(m % 10000).padStart(4, "0").replace(/0+$/, "");
  return sgn + whole + "." + (f || "0");
}
function zAt(i, j) {
  if (j >= i) return 0;
  const m = measq[tri(i, j)];
  if (m === QS) return 0;
  const v = m / 1e4;
  if (C.thres !== null && v < C.thres) return 0;
  return v;
}
function hex2rgb(h) { return [parseInt(h.slice(1,3),16), parseInt(h.slice(3,5),16), parseInt(h.slice(5,7),16)]; }
function colorAt(t) {
  for (let k = 1; k < stops.length; k++) {
    if (t <= stops[k][0]) {
      const a = hex2rgb(stops[k-1][1]), b = hex2rgb(stops[k][1]);
      const u = (t - stops[k-1][0]) / (stops[k][0] - stops[k-1][0] || 1);
      return [0,1,2].map(i => Math.round(a[i] + (b[i]-a[i]) * u));
    }
  }
  return hex2rgb(stops[stops.length-1][1]);
}
let zmin = 0, zmax = -Infinity;
for (let k = 0; k < measq.length; k++) {
  const m = measq[k];
  if (m === QS || m === -QS) continue;
  const v = m / 1e4;
  if (C.thres !== null && v < C.thres) continue;
  if (v < zmin) zmin = v;
  if (v > zmax) zmax = v;
}
if (zmax <= zmin) zmax = zmin + 1;
const side = Math.min(900, Math.max(n, 64));
const canvas = document.getElementById('hm');
canvas.width = side; canvas.height = side;
const ctx = canvas.getContext('2d');
// Zoom/pan view state: ox/oy = top-left origin in CELL units; px =
// pixels per cell at the current zoom.  Every redraw max-pools the
// VISIBLE cell range from the full-resolution payload, so zooming in IS
// full-resolution hover/render on demand.
let view = {px: side / n, ox: 0, oy: 0};
function clampView() {
  const span = side / view.px;
  view.ox = Math.min(Math.max(view.ox, 0), Math.max(0, n - span));
  view.oy = Math.min(Math.max(view.oy, 0), Math.max(0, n - span));
}
// normalized palette position of z == 0 — the background (upper
// triangle / below-threshold) color.  When negatives are impossible
// (thresholded figure, or r^2) cells at-or-below background are
// skipped (pure speed); otherwise every lower-triangle cell pools so
// negative D' regions color like the small-figure per-cell renderer.
const t0 = (0 - zmin) / (zmax - zmin);
const SKIP_BG = C.thres !== null || zmin >= 0;
function draw() {
  const px = view.px;
  const img = ctx.createImageData(side, side);
  const W = side;
  // max-pool visible cells into pixels (several cells can share one
  // pixel when zoomed out: keep the strongest signal so hits stay
  // visible); y autorange is reversed — row 0 at the top
  const pool = new Float32Array(W * side).fill(SKIP_BG ? t0 : -Infinity);
  const i0 = Math.max(1, Math.floor(view.oy));
  const i1 = Math.min(n, Math.ceil(view.oy + side / px));
  for (let i = i0; i < i1; i++) {
    const yA = (i - view.oy) * px, yB = (i + 1 - view.oy) * px;
    const y0 = Math.max(0, Math.floor(yA));
    const y1 = Math.min(side, Math.max(y0 + 1, Math.floor(yB)));
    if (y1 <= 0) continue;
    const j0 = Math.max(0, Math.floor(view.ox));
    const j1 = Math.min(i, Math.ceil(view.ox + side / px));
    for (let j = j0; j < j1; j++) {
      const t = (zAt(i, j) - zmin) / (zmax - zmin);
      if (SKIP_BG && t <= t0) continue;  // pool starts at the z==0
                                         // color; can't raise a pixel
      const xA = (j - view.ox) * px, xB = (j + 1 - view.ox) * px;
      const x0 = Math.max(0, Math.floor(xA));
      const x1 = Math.min(side, Math.max(x0 + 1, Math.floor(xB)));
      for (let y = y0; y < y1; y++) for (let x = x0; x < x1; x++) {
        const o = y * W + x;
        if (t > pool[o]) pool[o] = t;
      }
    }
  }
  for (let o = 0; o < pool.length; o++) {
    const c = colorAt(pool[o] === -Infinity ? t0 : pool[o]);
    img.data[4*o] = c[0]; img.data[4*o+1] = c[1];
    img.data[4*o+2] = c[2]; img.data[4*o+3] = 255;
  }
  ctx.putImageData(img, 0, 0);
}
let drawPending = false;
function scheduleDraw() {
  if (drawPending) return;
  drawPending = true;
  requestAnimationFrame(() => { drawPending = false; draw(); });
}
draw();
const tip = document.getElementById('tip');
let dragging = null;
canvas.addEventListener('wheel', ev => {
  ev.preventDefault();
  const r = canvas.getBoundingClientRect();
  const cx = ev.clientX - r.left, cy = ev.clientY - r.top;
  const jC = view.ox + cx / view.px, iC = view.oy + cy / view.px;
  const base = side / n;
  view.px = Math.min(40, Math.max(base, view.px * (ev.deltaY < 0 ? 1.25 : 0.8)));
  view.ox = jC - cx / view.px; view.oy = iC - cy / view.px;
  clampView(); scheduleDraw();
});
canvas.addEventListener('mousedown', ev => {
  dragging = {x: ev.clientX, y: ev.clientY, ox: view.ox, oy: view.oy};
});
window.addEventListener('mousemove', ev => {
  if (!dragging) return;
  view.ox = dragging.ox - (ev.clientX - dragging.x) / view.px;
  view.oy = dragging.oy - (ev.clientY - dragging.y) / view.px;
  clampView(); scheduleDraw();
  tip.style.display = 'none';
});
window.addEventListener('mouseup', () => dragging = null);
canvas.addEventListener('dblclick', () => {
  view = {px: side / n, ox: 0, oy: 0}; scheduleDraw();
});
canvas.addEventListener('mousemove', ev => {
  if (dragging) return;
  const r = canvas.getBoundingClientRect();
  const j = Math.floor(view.ox + (ev.clientX - r.left) / view.px);
  const i = Math.floor(view.oy + (ev.clientY - r.top) / view.px);
  if (i > 0 && i < n && j >= 0 && j < i) {
    const t = tri(i, j);
    const rs = C.rsids, pos = C.pos, al = C.alleles, ty = C.types;
    const fx = f2q ? fmt(f2q[t]) : fmt(C.freqq[j]);
    const fy = f1q ? fmt(f1q[t]) : fmt(C.freqq[i]);
    tip.innerHTML = "\\nr2: " + fmt(r2q[t]) + "<br>\\nD': " + fmt(dpq[t])
      + "<br>\\nabs_dist: " + Math.abs(pos[j] - pos[i]) + "<br><br>\\n"
      + rs[j] + ".hg38_pos: " + pos[j] + "<br>\\n"
      + rs[i] + ".hg38_pos: " + pos[i] + "<br><br>\\n"
      + rs[j] + ".alleles: " + al[j] + "<br>\\n"
      + rs[i] + ".alleles: " + al[i] + "<br><br>\\n"
      + rs[j] + ".type: " + ty[j] + "<br>\\n"
      + rs[i] + ".type: " + ty[i] + "<br><br>\\n"
      + rs[j] + ".alt_freq: " + fx + "<br>\\n"
      + rs[i] + ".alt_freq: " + fy + "\\n";
    tip.style.display = 'block';
    tip.style.left = (ev.clientX - r.left + 14) + 'px';
    tip.style.top = (ev.clientY - r.top + 14) + 'px';
  } else tip.style.display = 'none';
});
canvas.addEventListener('mouseleave', () => tip.style.display = 'none');
document.getElementById('title').textContent = (FIG.layout.title||{}).text || '';
const xt = ((FIG.layout.xaxis||{}).title||{}).text || '';
document.getElementById('footer').innerHTML = xt;
</script></body></html>
"""


_HTML_TEMPLATE_OVERVIEW = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>LD heatmap (overview)</title>
<style>
 body { font-family: sans-serif; margin: 12px; }
 #title { white-space: pre-line; font-size: 14px; }
 #footer { white-space: pre-line; font-size: 10px; color: #444; }
 #hint { font-size: 10px; color: #888; }
 #wrap { position: relative; display: inline-block; }
 #tip { position: absolute; display: none; background: #fff; border: 1px solid #888;
        padding: 6px 8px; font-size: 11px; pointer-events: none; z-index: 9;
        box-shadow: 0 1px 4px rgba(0,0,0,.3); max-width: 360px; }
 canvas { cursor: crosshair; }
</style></head><body>
<div id="title"></div>
<div id="wrap"><canvas id="hm"></canvas><div id="tip"></div></div>
<div id="hint">pooled overview &#183; scroll to zoom &#183; drag to pan &#183;
double-click to reset</div>
<div id="footer"></div>
<script>
// Pooled overview payload: the figure max-pools f x f cell regions by
// the color measure; each pool cell ships its representative pair's
// EXACT 4-dp codes and indices, so hover shows a real pair in the
// reference's per-cell format (ld_triangle.py:200-213) under a region
// banner.  Full-resolution values live in the -j JSON, not the HTML.
const FIG = __FIGURE_JSON__;
const C = FIG.overview, n = C.n, P = C.P, F = C.f;
const stops = FIG.data[0].colorscale;
const QS = C.qs;
function b64i(s, w) {
  const bin = atob(s), m = bin.length / w;
  const a = w === 2 ? new Int16Array(m) : new Int32Array(m);
  if (w === 2) {
    for (let k = 0; k < m; k++)
      a[k] = ((bin.charCodeAt(2*k) | (bin.charCodeAt(2*k+1) << 8)) << 16) >> 16;
  } else {
    for (let k = 0; k < m; k++)
      a[k] = bin.charCodeAt(4*k) | (bin.charCodeAt(4*k+1) << 8)
           | (bin.charCodeAt(4*k+2) << 16) | (bin.charCodeAt(4*k+3) << 24);
  }
  return a;
}
const r2o = b64i(C.r2o, 2), dpo = b64i(C.dpo, 2);
const io = b64i(C.io, 4), jo = b64i(C.jo, 4);
const measo = C.measure === "r_square" ? r2o : dpo;
const ptri = (pi, pj) => pi * (pi + 1) / 2 + pj;   // pj <= pi
function fmt(m) {
  if (m === QS) return "0";
  if (m === -QS) return "-0.0";
  const sgn = m < 0 ? "-" : ""; m = Math.abs(m);
  const whole = Math.floor(m / 10000);
  let f = String(m % 10000).padStart(4, "0").replace(/0+$/, "");
  return sgn + whole + "." + (f || "0");
}
function zAt(pi, pj) {
  if (pj > pi) return 0;
  const t = ptri(pi, pj);
  if (io[t] < 0) return 0;
  const m = measo[t];
  if (m === QS) return 0;
  const v = m / 1e4;
  if (C.thres !== null && v < C.thres) return 0;
  return Math.max(v, 0);
}
function hex2rgb(h) { return [parseInt(h.slice(1,3),16), parseInt(h.slice(3,5),16), parseInt(h.slice(5,7),16)]; }
function colorAt(t) {
  for (let k = 1; k < stops.length; k++) {
    if (t <= stops[k][0]) {
      const a = hex2rgb(stops[k-1][1]), b = hex2rgb(stops[k][1]);
      const u = (t - stops[k-1][0]) / (stops[k][0] - stops[k-1][0] || 1);
      return [0,1,2].map(i => Math.round(a[i] + (b[i]-a[i]) * u));
    }
  }
  return hex2rgb(stops[stops.length-1][1]);
}
let zmin = 0, zmax = -Infinity;
for (let pi = 0; pi < P; pi++) for (let pj = 0; pj <= pi; pj++) {
  const v = zAt(pi, pj);
  if (v > zmax) zmax = v;
}
if (zmax <= zmin) zmax = zmin + 1;
const side = Math.min(1000, Math.max(P, 64));
const canvas = document.getElementById('hm');
canvas.width = side; canvas.height = side;
const ctx = canvas.getContext('2d');
let view = {px: side / P, ox: 0, oy: 0};  // origin in POOL-cell units
function clampView() {
  const span = side / view.px;
  view.ox = Math.min(Math.max(view.ox, 0), Math.max(0, P - span));
  view.oy = Math.min(Math.max(view.oy, 0), Math.max(0, P - span));
}
function draw() {
  const px = view.px, W = side;
  const img = ctx.createImageData(side, side);
  const pool = new Float32Array(W * side);
  const i0 = Math.max(0, Math.floor(view.oy));
  const i1 = Math.min(P, Math.ceil(view.oy + side / px));
  for (let pi = i0; pi < i1; pi++) {
    const y0 = Math.max(0, Math.floor((pi - view.oy) * px));
    const y1 = Math.min(side, Math.max(y0 + 1, Math.floor((pi + 1 - view.oy) * px)));
    if (y1 <= 0) continue;
    const j0 = Math.max(0, Math.floor(view.ox));
    const j1 = Math.min(pi + 1, Math.ceil(view.ox + side / px));
    for (let pj = j0; pj < j1; pj++) {
      const v = zAt(pi, pj);
      if (v <= 0) continue;
      const x0 = Math.max(0, Math.floor((pj - view.ox) * px));
      const x1 = Math.min(side, Math.max(x0 + 1, Math.floor((pj + 1 - view.ox) * px)));
      for (let y = y0; y < y1; y++) for (let x = x0; x < x1; x++) {
        const o = y * W + x;
        if (v > pool[o]) pool[o] = v;
      }
    }
  }
  for (let o = 0; o < pool.length; o++) {
    const c = colorAt((pool[o] - zmin) / (zmax - zmin));
    img.data[4*o] = c[0]; img.data[4*o+1] = c[1];
    img.data[4*o+2] = c[2]; img.data[4*o+3] = 255;
  }
  ctx.putImageData(img, 0, 0);
}
let drawPending = false;
function scheduleDraw() {
  if (drawPending) return;
  drawPending = true;
  requestAnimationFrame(() => { drawPending = false; draw(); });
}
draw();
const tip = document.getElementById('tip');
let dragging = null;
canvas.addEventListener('wheel', ev => {
  ev.preventDefault();
  const r = canvas.getBoundingClientRect();
  const cx = ev.clientX - r.left, cy = ev.clientY - r.top;
  const jC = view.ox + cx / view.px, iC = view.oy + cy / view.px;
  const base = side / P;
  view.px = Math.min(40, Math.max(base, view.px * (ev.deltaY < 0 ? 1.25 : 0.8)));
  view.ox = jC - cx / view.px; view.oy = iC - cy / view.px;
  clampView(); scheduleDraw();
});
canvas.addEventListener('mousedown', ev => {
  dragging = {x: ev.clientX, y: ev.clientY, ox: view.ox, oy: view.oy};
});
window.addEventListener('mousemove', ev => {
  if (!dragging) return;
  view.ox = dragging.ox - (ev.clientX - dragging.x) / view.px;
  view.oy = dragging.oy - (ev.clientY - dragging.y) / view.px;
  clampView(); scheduleDraw();
  tip.style.display = 'none';
});
window.addEventListener('mouseup', () => dragging = null);
canvas.addEventListener('dblclick', () => {
  view = {px: side / P, ox: 0, oy: 0}; scheduleDraw();
});
canvas.addEventListener('mousemove', ev => {
  if (dragging) return;
  const r = canvas.getBoundingClientRect();
  const pj = Math.floor(view.ox + (ev.clientX - r.left) / view.px);
  const pi = Math.floor(view.oy + (ev.clientY - r.top) / view.px);
  if (pi >= 0 && pi < P && pj >= 0 && pj <= pi) {
    const t = ptri(pi, pj);
    if (io[t] < 0) { tip.style.display = 'none'; return; }
    const i = io[t], j = jo[t];
    const rs = C.rsids, pos = C.pos, al = C.alleles, ty = C.types;
    tip.innerHTML = "[strongest pair of this " + F + "&#215;" + F
      + "-variant region]<br>"
      + "\\nr2: " + fmt(r2o[t]) + "<br>\\nD': " + fmt(dpo[t])
      + "<br>\\nabs_dist: " + Math.abs(pos[j] - pos[i]) + "<br><br>\\n"
      + rs[j] + ".hg38_pos: " + pos[j] + "<br>\\n"
      + rs[i] + ".hg38_pos: " + pos[i] + "<br><br>\\n"
      + rs[j] + ".alleles: " + al[j] + "<br>\\n"
      + rs[i] + ".alleles: " + al[i] + "<br><br>\\n"
      + rs[j] + ".type: " + ty[j] + "<br>\\n"
      + rs[i] + ".type: " + ty[i] + "<br><br>\\n"
      + rs[j] + ".alt_freq: " + fmt(C.freqq[j]) + "<br>\\n"
      + rs[i] + ".alt_freq: " + fmt(C.freqq[i]) + "\\n";
    tip.style.display = 'block';
    tip.style.left = (ev.clientX - r.left + 14) + 'px';
    tip.style.top = (ev.clientY - r.top + 14) + 'px';
  } else tip.style.display = 'none';
});
canvas.addEventListener('mouseleave', () => tip.style.display = 'none');
document.getElementById('title').textContent = (FIG.layout.title||{}).text || '';
const xt = ((FIG.layout.xaxis||{}).title||{}).text || '';
document.getElementById('footer').innerHTML = xt;
</script></body></html>
"""


def write_html(path: str, figure: dict, disp_letters: bool) -> None:
    # token replacement, not str.format: the embedded JS is full of
    # braces and would otherwise need error-prone {{ }} doubling
    if "overview" in figure:
        html = _HTML_TEMPLATE_OVERVIEW.replace(
            "__FIGURE_JSON__", json.dumps(figure)
        )
    elif "columnar" in figure:
        html = _HTML_TEMPLATE_COLUMNAR.replace(
            "__FIGURE_JSON__", json.dumps(figure)
        )
    else:
        html = _HTML_TEMPLATE.replace(
            "__FIGURE_JSON__", json.dumps(figure)
        ).replace(
            "__SHOW_NUMBERS__", "true" if disp_letters else "false"
        )
    with open(path, "w") as fh:
        fh.write(html)
