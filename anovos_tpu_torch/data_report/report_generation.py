"""Full report generation (reference: data_report/report_generation.py:3984).

Consumes the master_path CSV/JSON contract (files named after analyzer
functions + ``freqDist_``/``eventDist_``/``drift_``/``outlier_``/``geo_``
chart JSONs) and emits a single self-contained ``ml_anovos_report.html``.
The reference renders via datapane; here the report is a dependency-free
HTML document with tabbed sections, client-paged tables, and plotly.js
(CDN) hydrating the same chart JSON objects the preprocessing step wrote.

Tab parity with the reference (:4111-4136 lists + tab builders):
executive summary with the 10-flag diagnosis matrix and drift/stability
big numbers (:524-906), wiki (:909), descriptive statistics (:994),
quality check (:1154), attribute associations (:1291), drift & stability
with per-attribute SI gauges and metric line charts (:99, :1434), the
time-series viz suite at daily/hourly/weekly grain with seasonal
decomposition and ADF/KPSS stationarity (:1942-3208), and the geospatial
tab with location scatter/density charts and cluster tables (:3210-3982).

This is the port's own copy of ``anovos_tpu/data_report/report_generation.py``
(pure host code; the port imports nothing of the JAX package).  Every tab
whose input is a file under ``master_path`` is kept byte for byte.  The
Degraded Sections tab leads the report whenever the degradation registry
(``resilience/policy.py``) or the ingest guard (``data_ingest/guard.py``)
holds an entry, with the JAX markup and text.  The Run Timings tab
renders from ``<master_path>/obs/run_manifest.json`` when a completed run
left one there (``run_timings_gen``), after Geospatial, as in the JAX
renderer.  Two parts of the JAX renderer read layers the port does not
have yet and are left out: the Perf Ledger tab and the Run Diff tab
(ROADMAP.md Queue A item 3).  In a fresh run directory the JAX renderer
shows neither (``workflow.run`` refuses ``ANOVOS_PERF_LEDGER`` and
``ANOVOS_RUN_DIFF_BASELINE``).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import threading
from html import escape
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from anovos_tpu_torch.shared.utils import ends_with

logger = logging.getLogger("anovos_tpu_torch.report_generation")

# stats files per tab (reference report_generation.py:4111-4136 tab lists)
_SG_FILES = [
    "global_summary",
    "measures_of_counts",
    "measures_of_centralTendency",
    "measures_of_cardinality",
    "measures_of_dispersion",
    "measures_of_percentiles",
    "measures_of_shape",
]
_QC_FILES = [
    "duplicate_detection",
    "nullRows_detection",
    "nullColumns_detection",
    "outlier_detection",
    "IDness_detection",
    "biasedness_detection",
    "invalidEntries_detection",
]
_AE_FILES = ["correlation_matrix", "IV_calculation", "IG_calculation", "variable_clustering"]

_PLOTLY_CDN = "https://cdn.plot.ly/plotly-2.35.2.min.js"


def _plotly_script_tag() -> str:
    """Self-contained-report support (reference report_generation.py:4387-4413
    bundles datapane's JS runtime): embed plotly.min.js INLINE when a copy is
    available — ``ANOVOS_PLOTLY_JS=<path>`` or the installed plotly package's
    bundled copy — so charts render with networking disabled.  Falls back to
    the CDN tag otherwise (the inline SVG renderer in ``_JS`` still keeps the
    report readable fully offline either way)."""
    candidates = [os.environ.get("ANOVOS_PLOTLY_JS")]
    try:
        import plotly  # noqa: F401 — optional; provides a vendorable bundle

        candidates.append(
            os.path.join(os.path.dirname(plotly.__file__), "package_data", "plotly.min.js")
        )
    except ImportError:
        pass
    for p in candidates:
        if p and os.path.isfile(p):
            try:
                with open(p, encoding="utf-8") as fh:
                    src = fh.read()
                return f"<script>{src}</script>"
            except OSError:
                continue
    return f"<script src='{_PLOTLY_CDN}'></script>"

_STABILITY_INTERPRETATION = pd.DataFrame(
    {
        "StabilityIndex": ["3.5 - 4.0", "3.0 - 3.5", "2.0 - 3.0", "1.0 - 2.0", "0.0 - 1.0"],
        "Order": ["Very Stable", "Stable", "Marginally Stable", "Unstable", "Very Unstable"],
    }
)


def _si_category(v: float) -> str:
    if v >= 3.5:
        return "Very Stable"
    if v >= 3:
        return "Stable"
    if v >= 2:
        return "Marginally Stable"
    if v >= 1:
        return "Unstable"
    if v >= 0:
        return "Very Unstable"
    return "Out of Range"


def _json_for_script(obj) -> str:
    """JSON safe for embedding inside a <script> element: '</' would
    terminate the script tag (stored-XSS vector via data values)."""
    return json.dumps(obj).replace("</", "<\\/")


def _read_csv(master_path: str, name: str) -> Optional[pd.DataFrame]:
    p = ends_with(master_path) + name + ".csv"
    if os.path.exists(p):
        try:
            return pd.read_csv(p)
        except Exception:
            return None
    return None


def _load_fig(path: str) -> Optional[dict]:
    """Chart JSON from disk, None when absent/corrupt (one policy for every
    chart-loading site)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            return json.load(fh)
    except Exception:
        return None


# table-id sequence for the client-side pager; report tabs can render from
# a scheduler worker thread while the basic report runs elsewhere, so the
# counter bump is lock-guarded (graftcheck GC005)
_table_seq = [0]
_table_seq_lock = threading.Lock()


def _table_html(df: pd.DataFrame, title: str, page: int = 200) -> str:
    """Client-paged table: the FULL frame ships in the page (no silent
    head() truncation — round-1 Weak #7); rows beyond ``page`` hide behind
    a pager."""
    with _table_seq_lock:
        _table_seq[0] += 1
        tid = f"tbl{_table_seq[0]}"
    n = len(df)
    body = df.to_html(index=False, classes="stats", border=0, na_rep="", table_id=tid)
    pager = ""
    if n > page:
        pager = (
            f"<div class='pager' data-t='{tid}' data-n='{n}' data-p='{page}'>"
            f"<button onclick=\"pgStep('{tid}',-1)\">&laquo; prev</button>"
            f"<span id='{tid}_lbl'></span>"
            f"<button onclick=\"pgStep('{tid}',1)\">next &raquo;</button>"
            f"<button onclick=\"pgAll('{tid}')\">show all {n}</button></div>"
        )
    return f"<h3>{escape(title)}</h3>" + body + pager


def _fig_div(fig: dict, div_id: str, height: int = 320) -> str:
    # anPlot uses plotly.js when the CDN loaded, else the inline SVG
    # fallback renderer — the report stays readable with zero egress
    return (
        f"<div class='chart' id='{div_id}' style='height:{height}px'></div>"
        f"<script>anPlot('{div_id}', {_json_for_script(fig.get('data', []))}, "
        f"{_json_for_script(fig.get('layout', {}))});</script>"
    )


def _charts_html(
    master_path: str,
    prefix: str,
    title: str,
    limit: int = 60,
    height: int = 320,
    exclude=frozenset(),
) -> str:
    """Chart grid for every ``prefix``-named JSON, minus attributes already
    rendered elsewhere (``exclude``)."""
    files = sorted(glob.glob(ends_with(master_path) + prefix + "*"))
    files = [
        f
        for f in files
        if not f.endswith(".csv") and os.path.basename(f)[len(prefix):] not in exclude
    ]
    if not files:
        return ""
    out = [f"<h3>{escape(title)}</h3><div class='chartgrid'>"]
    for i, f in enumerate(files[:limit]):
        if (fig := _load_fig(f)) is not None:
            out.append(_fig_div(fig, f"{prefix.rstrip('_')}{i}", height))
    out.append("</div>")
    return "".join(out)


def _line_fig(x, series: Dict[str, list], title: str, ytitle: str = "") -> dict:
    return {
        "data": [
            {"type": "scatter", "mode": "lines+markers", "x": list(x), "y": list(y), "name": name}
            for name, y in series.items()
        ],
        "layout": {
            "title": {"text": title},
            "template": "plotly_white",
            "yaxis": {"title": {"text": ytitle}},
            "margin": {"t": 40, "b": 30},
        },
    }


def _bar_fig(x, y, title: str) -> dict:
    return {
        "data": [{"type": "bar", "x": list(x), "y": list(y), "marker": {"color": "#45526c"}}],
        "layout": {"title": {"text": title}, "template": "plotly_white", "margin": {"t": 40, "b": 30}},
    }


# ----------------------------------------------------------------------
# executive summary (reference :524-906)
# ----------------------------------------------------------------------
def _flag_list(df: Optional[pd.DataFrame], query: str, metric: str) -> tuple:
    if df is None:
        return (metric, None)
    try:
        vals = list(df.query(query)["attribute"].values)
        return (metric, vals or None)
    except Exception:
        return (metric, None)


def _executive_summary(
    master_path: str, id_col: str, label_col: str, corr_threshold: float, iv_threshold: float
) -> str:
    gs = _read_csv(master_path, "global_summary")
    if gs is None:
        return ""  # let the caller's "no global summary found" fallback show
    html = ["<h3>Key Report Highlights</h3>"]
    kv: Dict[str, str] = dict(zip(gs["metric"].astype(str), gs["value"].astype(str)))
    rows_count = int(float(kv.get("rows_count", 0) or 0))
    num_n = int(float(kv.get("numcols_count", 0) or 0))
    cat_n = int(float(kv.get("catcols_count", 0) or 0))
    html.append(
        f"<p>The dataset contains <b>{rows_count:,}</b> records and "
        f"<b>{num_n + cat_n}</b> attributes (<b>{num_n}</b> numerical + "
        f"<b>{cat_n}</b> categorical).</p>"
    )
    if label_col:
        html.append(f"<p>Target variable is <b>{escape(label_col)}</b>.</p>")
        # label distribution pie from the freqDist chart json (reference :560)
        fig = _load_fig(ends_with(master_path) + "freqDist_" + str(label_col))
        if fig is not None and isinstance(fig.get("data"), list) and fig["data"] and isinstance(fig["data"][0], dict):
            trace = fig["data"][0]
            pie = {
                "data": [
                    {
                        "type": "pie",
                        "labels": trace.get("x", []),
                        "values": trace.get("y", []),
                        "textinfo": "label+percent",
                        "pull": [0, 0.1],
                    }
                ],
                "layout": {"title": {"text": f"{label_col} distribution"}, "template": "plotly_white"},
            }
            html.append(_fig_div(pie, "label_pie", 300))
    else:
        html.append("<p>There is <b>no</b> target variable in the dataset.</p>")

    # --- the 10 diagnosis flags (reference :613-760) ---
    disp = _read_csv(master_path, "measures_of_dispersion")
    shape = _read_csv(master_path, "measures_of_shape")
    counts = _read_csv(master_path, "measures_of_counts")
    bias = _read_csv(master_path, "biasedness_detection")
    outl = _read_csv(master_path, "outlier_detection")
    iv = _read_csv(master_path, "IV_calculation")
    corr = _read_csv(master_path, "correlation_matrix")
    flags = [
        _flag_list(disp, "cov > 1", "High Variance"),
        _flag_list(shape, "skewness > 0", "Positive Skewness"),
        _flag_list(shape, "skewness < 0", "Negative Skewness"),
        _flag_list(shape, "kurtosis > 0", "High Kurtosis"),
        _flag_list(shape, "kurtosis < 0", "Low Kurtosis"),
        _flag_list(counts, "fill_pct < 0.7", "Low Fill Rates"),
        _flag_list(bias, ("treated > 0" if bias is not None and "treated" in bias else "flagged > 0"), "High Biasedness"),
        ("Outliers", list(outl["attribute"].values) if outl is not None and len(outl) else None),
        ("High Correlation", _correlated_cols(corr, corr_threshold)),
        _flag_list(iv, f"iv > {iv_threshold}", "Significant Attributes"),
    ]
    pairs = []
    for metric, attrs in flags:
        for a in attrs or []:
            pairs.append((metric, a))
    all_attrs = sorted({a for _, a in pairs})
    metrics_order = [
        "Outliers", "Significant Attributes", "Positive Skewness", "Negative Skewness",
        "High Variance", "High Correlation", "High Kurtosis", "Low Kurtosis",
        "Low Fill Rates", "High Biasedness",
    ]
    if all_attrs:
        piv = pd.DataFrame("✘", index=all_attrs, columns=metrics_order)
        for metric, a in pairs:
            if metric in piv.columns:
                piv.loc[a, metric] = "✔"
        piv.index.name = "Attribute"
        html.append("<p>Data Diagnosis:</p>")
        html.append(_table_html(piv.reset_index(), "attribute diagnosis matrix"))

    # --- drift / stability big numbers (reference :793-886) ---
    drift = _read_csv(master_path, "drift_statistics")
    stab = _read_csv(master_path, "stability_index")
    cards = []
    if drift is not None and len(drift) and "flagged" in drift:
        drifted = int((drift["flagged"] > 0).sum())
        total = len(drift)
        cards += [
            ("# Drifted Attributes", f"{drifted} out of {total}"),
            ("% Drifted Attributes", f"{100 * drifted / max(total, 1):.2f}%"),
        ]
    if stab is not None and len(stab) and "flagged" in stab:
        unstable = int((stab["flagged"] > 0).sum())
        total = len(stab)
        cards += [
            ("# Unstable Attributes", f"{unstable} out of {total}"),
            ("% Unstable Attributes", f"{100 * unstable / max(total, 1):.2f}%"),
        ]
    if cards:
        html.append("<p>Data Health based on Drift Metrics &amp; Stability Index:</p>")
        html.append(
            "".join(
                f"<div class='card'><div class='cardval'>{escape(v)}</div>"
                f"<div class='cardlbl'>{escape(k)}</div></div>"
                for k, v in cards
            )
        )
    if gs is not None:
        html.append(_table_html(gs, "global summary"))
    if id_col:
        html.append(f"<p>id column: <b>{escape(id_col)}</b></p>")
    return "".join(html)


def _correlated_cols(corr: Optional[pd.DataFrame], threshold: float) -> Optional[list]:
    """Upper-triangle scan for attributes correlated beyond the threshold
    (reference :711-728)."""
    if corr is None or "attribute" not in corr:
        return None
    attrs = [a for a in corr["attribute"].values if a in corr.columns]
    if not attrs:
        return None
    m = corr.set_index("attribute")[attrs]
    tri = m.where(np.triu(np.ones(m.shape), k=1).astype(bool))
    out = [c for c in tri.columns if (tri[c] > threshold).any()]
    return out or None


# ----------------------------------------------------------------------
# per-attribute drill-down (reference data_analyzer_output :233-440)
# ----------------------------------------------------------------------
def _attribute_profiles(
    master_path: str, label_col: str, sg_frames: Dict[str, pd.DataFrame], limit: int = 60
) -> tuple:
    """Collapsible per-attribute panel: every stat the SG files carry for the
    attribute, its frequency distribution, and (when a label exists) its
    event-rate chart.  ``sg_frames`` are the already-loaded stats frames.
    Returns (html, attributes whose charts were embedded) so callers can
    render plain grids for anything not covered here."""
    covered: set = set()
    profiles: Dict[str, Dict[str, str]] = {}
    for name in _SG_FILES[1:]:  # global_summary has no attribute axis
        df = sg_frames.get(name)
        if df is None or "attribute" not in df:
            continue
        for _, row in df.iterrows():
            d = profiles.setdefault(str(row["attribute"]), {})
            for col in df.columns:
                if col != "attribute":
                    d[col] = row[col]
    if not profiles:
        return "", covered
    mp = ends_with(master_path)
    out = ["<h3>attribute profiles</h3>"]
    for i, (attr, stats) in enumerate(sorted(profiles.items())):
        if i >= limit:
            out.append(f"<p>… {len(profiles) - limit} more attributes (see tables above)</p>")
            break
        covered.add(attr)
        kv = pd.DataFrame(
            {"metric": list(stats.keys()), "value": [str(v) for v in stats.values()]}
        )
        charts = []
        if (fig := _load_fig(mp + "freqDist_" + attr)) is not None:
            charts.append(_fig_div(fig, f"prof_f_{i}", 280))
        if label_col and (fig := _load_fig(mp + "eventDist_" + attr)) is not None:
            charts.append(_fig_div(fig, f"prof_e_{i}", 280))
        out.append(
            f"<details><summary><b>{escape(attr)}</b></summary>"
            f"<div style='display:flex;gap:18px;flex-wrap:wrap;align-items:flex-start'>"
            f"<div>{_table_html(kv, '')}</div><div class='chartgrid' style='flex:1;min-width:440px'>"
            f"{''.join(charts)}</div></div></details>"
        )
    return "".join(out), covered


# ----------------------------------------------------------------------
# drift & stability tab (reference :99-231, :1434-1936)
# ----------------------------------------------------------------------
def _stability_charts(master_path: str, limit: int = 12) -> str:
    stab = _read_csv(master_path, "stability_index")
    hist = _read_csv(master_path, "stabilityIndex_metrics")
    if stab is None or not len(stab):
        return ""
    html = ["<h3>stability deep-dive</h3>"]
    html.append(_table_html(_STABILITY_INTERPRETATION, "stability index interpretation"))
    # most interesting first: flagged, then lowest SI
    stab = stab.sort_values(["flagged", "stability_index"], ascending=[False, True])
    shown = 0
    for _, row in stab.iterrows():
        if shown >= limit:
            break
        col = row["attribute"]
        si = float(row["stability_index"]) if row["stability_index"] == row["stability_index"] else 0.0
        gauge = {
            "data": [
                {
                    "type": "indicator",
                    "mode": "gauge+number",
                    "value": si,
                    "gauge": {
                        "axis": {"range": [None, 4]},
                        "steps": [
                            {"range": [0, 1], "color": "#b2182b"},
                            {"range": [1, 2], "color": "#ef8a62"},
                            {"range": [2, 3], "color": "#fddbc7"},
                            {"range": [3, 3.5], "color": "#a1d99b"},
                            {"range": [3.5, 4], "color": "#41ab5d"},
                        ],
                        "bar": {"color": "#16213e"},
                    },
                    "title": {"text": f"{col}: {_si_category(si)}"},
                }
            ],
            "layout": {"template": "plotly_white", "margin": {"t": 60, "b": 10}},
        }
        html.append(f"<h4>Stability Index for {escape(str(col).upper())}</h4><div class='chartgrid'>")
        html.append(_fig_div(gauge, f"sig_{shown}", 280))
        if hist is not None and "attribute" in hist:
            sub = hist[hist["attribute"] == col].sort_values("idx")
            if len(sub):
                for metric in ("mean", "stddev", "kurtosis"):
                    if metric in sub:
                        cv = row.get(f"{metric}_cv")
                        html.append(
                            _fig_div(
                                _line_fig(
                                    sub["idx"], {metric: sub[metric].tolist()},
                                    f"CV of {metric} is {cv}", metric,
                                ),
                                f"sil_{shown}_{metric}", 280,
                            )
                        )
        html.append("</div>")
        shown += 1
    return "".join(html)


# ----------------------------------------------------------------------
# time-series tab (reference :1942-3208)
# ----------------------------------------------------------------------
def _ts_tab(master_path: str) -> str:
    mp = ends_with(master_path)
    stats = _read_csv(master_path, "ts_stats")
    if stats is None or not len(stats):
        return ""
    html = [_table_html(stats, "timestamp column eligibility")]
    land = _read_csv(master_path, "ts_landscape")
    if land is not None and len(land):
        html.append(_table_html(land, "time-series landscape"))
    ts_cols = [str(a) for a in stats.loc[stats.get("eligible", 0) == 1, "attribute"]]
    for i, c in enumerate(ts_cols):
        html.append(f"<h3>‣ {escape(c)}</h3><div class='chartgrid'>")
        daily = _read_csv(master_path, f"ts_daily_{c}")
        if daily is not None and len(daily):
            html.append(
                _fig_div(
                    _line_fig(daily.iloc[:, 0], {"records": daily["count"].tolist()},
                              f"daily volume — {c}", "count"),
                    f"tsd_{i}",
                )
            )
        hourly = _read_csv(master_path, f"ts_daypart_{c}")
        if hourly is not None and len(hourly):
            html.append(_fig_div(_bar_fig(hourly.iloc[:, 0], hourly["count"], f"daypart volume — {c}"), f"tsh_{i}"))
        weekly = _read_csv(master_path, f"ts_weekly_{c}")
        if weekly is not None and len(weekly):
            dows = ["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"]
            x = [dows[int(v)] if str(v).isdigit() and int(v) < 7 else v for v in weekly.iloc[:, 0]]
            html.append(_fig_div(_bar_fig(x, weekly["count"], f"weekday volume — {c}"), f"tsw_{i}"))
        html.append("</div>")
        # numeric attribute trends per grain
        numd = _read_csv(master_path, f"ts_num_daily_{c}")
        if numd is not None and len(numd):
            html.append("<h4>attribute trends (daily)</h4><div class='chartgrid'>")
            for j, (attr, sub) in enumerate(numd.groupby("attribute")):
                html.append(
                    _fig_div(
                        _line_fig(
                            sub["date"],
                            {"mean": sub["mean"].tolist(), "median": sub["median"].tolist()},
                            f"{attr} over time", attr,
                        ),
                        f"tsnd_{i}_{j}", 280,
                    )
                )
            html.append("</div>")
        for grain, gname in [("hourly", "daypart"), ("weekly", "weekday")]:
            numg = _read_csv(master_path, f"ts_num_{grain}_{c}")
            if numg is not None and len(numg):
                html.append(f"<h4>attribute means by {gname}</h4><div class='chartgrid'>")
                for j, (attr, sub) in enumerate(numg.groupby("attribute")):
                    html.append(
                        _fig_div(_bar_fig(sub["bucket"], sub["mean"], f"{attr} mean by {gname}"),
                                 f"tsn{grain[0]}_{i}_{j}", 260)
                    )
                html.append("</div>")
        catd = _read_csv(master_path, f"ts_cat_daily_{c}")
        if catd is not None and len(catd):
            html.append("<h4>categorical mix over time</h4><div class='chartgrid'>")
            for j, (attr, sub) in enumerate(catd.groupby("attribute")):
                piv = sub.pivot_table(index="date", columns="category", values="count", fill_value=0)
                fig = {
                    "data": [
                        {"type": "scatter", "mode": "lines", "stackgroup": "one",
                         "x": list(piv.index), "y": piv[cat].tolist(), "name": str(cat)}
                        for cat in piv.columns
                    ],
                    "layout": {"title": {"text": f"{attr} mix"}, "template": "plotly_white",
                               "margin": {"t": 40, "b": 30}},
                }
                html.append(_fig_div(fig, f"tscat_{i}_{j}", 280))
            html.append("</div>")
        dec = _read_csv(master_path, f"ts_decompose_{c}")
        if dec is not None and len(dec):
            html.append("<h4>seasonal decomposition (daily volume)</h4><div class='chartgrid'>")
            for j, part in enumerate(["observed", "trend", "seasonal", "residual"]):
                if part in dec:
                    html.append(
                        _fig_div(_line_fig(dec["date"], {part: dec[part].tolist()}, part),
                                 f"tsdec_{i}_{j}", 240)
                    )
            html.append("</div>")
        stat = _read_csv(master_path, f"ts_stationarity_{c}")
        if stat is not None and len(stat):
            html.append(_table_html(stat, f"stationarity tests (ADF + KPSS) — {c}"))
    return "".join(html)


# ----------------------------------------------------------------------
# geospatial tab (reference :3210-3982)
# ----------------------------------------------------------------------
def _geo_tab(master_path: str) -> str:
    stats = _read_csv(master_path, "geospatial_stats")
    if stats is None or not len(stats):
        return ""
    html = [_table_html(stats, "geospatial field summary")]
    mp = ends_with(master_path)
    for f in sorted(glob.glob(mp + "geospatial_overall_*.csv")):
        name = os.path.basename(f)[:-4]
        df = _read_csv(master_path, name)
        if df is not None and len(df):
            html.append(_table_html(df, name.replace("geospatial_overall_", "overall stats — ")))
    html.append(_charts_html(master_path, "geo_scatter_", "location scatter maps", height=420))
    html.append(_charts_html(master_path, "geo_heat_", "location density", height=420))
    for prefix, title in [
        ("geospatial_top_", "top locations — "),
        ("geospatial_kmeans_", "kmeans clusters — "),
        ("geospatial_dbscan_", "dbscan grid — "),
    ]:
        for f in sorted(glob.glob(mp + prefix + "*.csv")):
            name = os.path.basename(f)[:-4]
            df = _read_csv(master_path, name)
            if df is not None and len(df):
                html.append(_table_html(df, title + name.replace(prefix, "")))
    return "".join(html)


_CSS = """
body { font-family: -apple-system, Segoe UI, Helvetica, sans-serif; margin: 0; background: #fafafa; }
header { background: #1a1a2e; color: white; padding: 18px 28px; }
nav { display: flex; gap: 4px; background: #16213e; padding: 0 20px; flex-wrap: wrap; }
nav button { background: none; border: none; color: #bbb; padding: 12px 18px; cursor: pointer; font-size: 14px; }
nav button.active { color: white; border-bottom: 3px solid #e94560; }
section { display: none; padding: 24px 32px; }
section.active { display: block; }
table.stats { border-collapse: collapse; font-size: 13px; margin-bottom: 6px; background: white; }
table.stats th { background: #16213e; color: white; padding: 6px 10px; text-align: left; }
table.stats td { padding: 5px 10px; border-bottom: 1px solid #eee; }
.chartgrid { display: grid; grid-template-columns: repeat(auto-fill, minmax(420px, 1fr)); gap: 14px; }
.chart { background: white; border: 1px solid #eee; }
.card { display: inline-block; background: white; border: 1px solid #eee; padding: 14px 22px; margin: 6px; border-radius: 6px; }
.cardval { font-size: 22px; font-weight: 600; }
.cardlbl { color: #777; }
.pager { margin: 4px 0 16px; }
.pager button { margin-right: 6px; padding: 3px 10px; }
"""

_JS = """
function showTab(i) {
  document.querySelectorAll('nav button').forEach((b, j) => b.classList.toggle('active', i === j));
  document.querySelectorAll('main section').forEach((s, j) => {
    s.classList.toggle('active', i === j);
    if (i === j) _anFlush(s);
  });
}
// ---- chart dispatch: plotly.js when the CDN loaded, SVG fallback when not.
// Charts inside collapsed <details> (attribute profiles) defer until opened
// — rendering into a zero-size hidden container produces blank plots.
var _anQueue = [];
var _anPending = {};
function anPlot(id, data, layout) { _anQueue.push([id, data, layout]); }
function _anRender(id, data, layout) {
  var el = document.getElementById(id);
  if (!el) return;
  if (window.Plotly) { Plotly.newPlot(id, data, layout, {displayModeBar: false}); return; }
  try { anFallback(el, data, layout); } catch (e) { el.textContent = 'chart unavailable offline'; }
}
function _anFlush(root) {
  root.querySelectorAll('.chart').forEach(el => {
    if (_anPending[el.id] && el.offsetParent !== null) {
      var [d, l] = _anPending[el.id];
      delete _anPending[el.id];
      _anRender(el.id, d, l);
    }
  });
}
window.addEventListener('load', () => {
  _anQueue.forEach(([id, data, layout]) => {
    var el = document.getElementById(id);
    if (el && el.offsetParent === null) { _anPending[id] = [data, layout]; return; }
    _anRender(id, data, layout);
  });
});
document.addEventListener('toggle', (e) => { if (e.target.open) _anFlush(e.target); }, true);
var _anPal = ['#45526c','#e94560','#0f9b8e','#f2a154','#5c7aea','#9b5de5','#00bbf9','#fee440'];
function anFallback(el, data, layout) {
  var W = el.clientWidth || 420, H = el.clientHeight || 320, P = 44;
  var ns = 'http://www.w3.org/2000/svg';
  var svg = document.createElementNS(ns, 'svg');
  svg.setAttribute('width', W); svg.setAttribute('height', H);
  function add(tag, attrs, text) {
    var n = document.createElementNS(ns, tag);
    for (var k in attrs) n.setAttribute(k, attrs[k]);
    if (text !== undefined) n.textContent = text;
    svg.appendChild(n); return n;
  }
  var title = (layout && layout.title && (layout.title.text || layout.title)) || '';
  if (title) add('text', {x: W/2, y: 16, 'text-anchor': 'middle', 'font-size': 13, 'font-weight': 600}, title);
  var t0 = data && data[0] ? data[0] : {};
  if (t0.type === 'pie') {
    var vals = t0.values || [], labels = t0.labels || [];
    var tot = vals.reduce((a,b)=>a+(+b||0), 0) || 1, ang = -Math.PI/2;
    var cx = W/2, cy = H/2 + 8, r = Math.min(W, H)/2 - 40;
    vals.forEach((v, i) => {
      var a2 = ang + 2*Math.PI*(+v||0)/tot;
      var x1 = cx+r*Math.cos(ang), y1 = cy+r*Math.sin(ang), x2 = cx+r*Math.cos(a2), y2 = cy+r*Math.sin(a2);
      add('path', {d: 'M'+cx+','+cy+' L'+x1+','+y1+' A'+r+','+r+' 0 '+((a2-ang)>Math.PI?1:0)+',1 '+x2+','+y2+' Z',
                   fill: _anPal[i % _anPal.length]});
      var mid = (ang+a2)/2;
      add('text', {x: cx+(r+14)*Math.cos(mid), y: cy+(r+14)*Math.sin(mid), 'font-size': 10,
                   'text-anchor': 'middle'}, labels[i] + ' ' + Math.round(100*(+v||0)/tot) + '%');
      ang = a2;
    });
    el.appendChild(svg); return;
  }
  if (t0.type === 'indicator') {
    add('text', {x: W/2, y: H/2, 'text-anchor': 'middle', 'font-size': 34, 'font-weight': 700},
        (+t0.value).toFixed(2));
    if (t0.title) add('text', {x: W/2, y: H/2 + 26, 'text-anchor': 'middle', 'font-size': 12},
        t0.title.text || '');
    el.appendChild(svg); return;
  }
  if (t0.type === 'heatmap' && t0.z) {
    var z = t0.z, nr = z.length, nc = (z[0]||[]).length;
    var zmin = Infinity, zmax = -Infinity;
    z.forEach(row => row.forEach(v => { if (v==null) return; zmin = Math.min(zmin,v); zmax = Math.max(zmax,v); }));
    var cw = (W-2*P)/Math.max(nc,1), ch = (H-2*P)/Math.max(nr,1);
    z.forEach((row, i) => row.forEach((v, j) => {
      var t = (v - zmin)/Math.max(zmax - zmin, 1e-9);
      add('rect', {x: P+j*cw, y: P+i*ch, width: cw, height: ch,
                   fill: 'rgb('+Math.round(255*t)+','+Math.round(80+80*(1-Math.abs(t-0.5)*2))+','+Math.round(255*(1-t))+')'});
    }));
    el.appendChild(svg); return;
  }
  // bar / scatter / line traces on shared axes
  var xs = [], ys = [];
  data.forEach(tr => {
    (tr.x || tr.lon || []).forEach(v => xs.push(v));
    (tr.y || tr.lat || []).forEach(v => { if (v != null && isFinite(v)) ys.push(+v); });
  });
  if (!ys.length) { el.textContent = 'chart unavailable offline'; return; }
  var numericX = xs.every(v => v != null && isFinite(v));
  var cats = null, xmin, xmax;
  if (numericX) { xmin = Math.min(...xs.map(Number)); xmax = Math.max(...xs.map(Number)); }
  else { cats = [...new Set(xs.map(String))]; xmin = 0; xmax = Math.max(cats.length - 1, 1); }
  var ymin = Math.min(0, Math.min(...ys)), ymax = Math.max(...ys);
  if (ymax === ymin) ymax = ymin + 1;
  function X(v) { var t = numericX ? (Number(v)-xmin)/Math.max(xmax-xmin,1e-9) : cats.indexOf(String(v))/xmax; return P + t*(W-2*P); }
  function Y(v) { return H - P - (v-ymin)/(ymax-ymin)*(H-2*P-10); }
  add('line', {x1: P, y1: H-P, x2: W-P, y2: H-P, stroke: '#999'});
  add('line', {x1: P, y1: 24, x2: P, y2: H-P, stroke: '#999'});
  add('text', {x: 4, y: 28, 'font-size': 10}, (+ymax).toPrecision(4));
  add('text', {x: 4, y: H-P, 'font-size': 10}, (+ymin).toPrecision(3));
  data.forEach((tr, ti) => {
    var color = _anPal[ti % _anPal.length];
    var tx = tr.x || tr.lon || [], ty = tr.y || tr.lat || [];
    if (tr.type === 'bar') {
      var bw = Math.max((W-2*P)/Math.max(tx.length,1) - 2, 1);
      tx.forEach((xv, i) => { if (ty[i] == null) return;
        add('rect', {x: X(xv)-bw/2, y: Y(+ty[i]), width: bw, height: Math.max(H-P-Y(+ty[i]),0), fill: color}); });
    } else {
      var pts = [];
      tx.forEach((xv, i) => { if (ty[i] != null && isFinite(ty[i])) pts.push(X(xv)+','+Y(+ty[i])); });
      if ((tr.mode||'lines').includes('lines') && pts.length > 1)
        add('polyline', {points: pts.join(' '), fill: 'none', stroke: color, 'stroke-width': 1.5});
      else pts.forEach(p => { var c = p.split(','); add('circle', {cx: c[0], cy: c[1], r: 2.4, fill: color}); });
    }
    if (tr.name) add('text', {x: W-P, y: 28+12*ti, 'text-anchor': 'end', 'font-size': 10, fill: color}, tr.name);
  });
  if (!numericX && cats.length <= 14) cats.forEach((c, i) =>
    add('text', {x: X(c), y: H-P+12, 'font-size': 9, 'text-anchor': 'middle'}, String(c).slice(0, 10)));
  el.appendChild(svg);
}
var pgState = {};
function pgShow(t) {
  var st = pgState[t];
  var rows = document.querySelectorAll('#' + t + ' tbody tr');
  rows.forEach((r, i) => {
    r.style.display = (st.all || (i >= st.page * st.p && i < (st.page + 1) * st.p)) ? '' : 'none';
  });
  var lbl = document.getElementById(t + '_lbl');
  if (lbl) lbl.textContent = st.all ? 'all ' + rows.length :
    (st.page * st.p + 1) + '-' + Math.min((st.page + 1) * st.p, rows.length) + ' of ' + rows.length;
}
function pgStep(t, d) {
  var st = pgState[t];
  st.all = false;
  var max = Math.ceil(st.n / st.p) - 1;
  st.page = Math.min(Math.max(st.page + d, 0), max);
  pgShow(t);
}
function pgAll(t) { pgState[t].all = true; pgShow(t); }
document.addEventListener('DOMContentLoaded', () => {
  document.querySelectorAll('.pager').forEach(p => {
    var t = p.dataset.t;
    pgState[t] = { page: 0, p: parseInt(p.dataset.p), n: parseInt(p.dataset.n), all: false };
    pgShow(t);
  });
});
"""


# ----------------------------------------------------------------------
# reference-named public section generators.  The reference returns
# datapane objects from these (report_generation.py:78-3982); the analogue
# here is the section's HTML fragment — or plotly fig dicts / pandas
# frames for the chart and stats helpers — which anovos_report assembles
# into the final document.
# ----------------------------------------------------------------------
def remove_u_score(col: str) -> str:
    """Underscored file/stat name → display title (reference :78-97)."""
    out = []
    for part in str(col).split("_"):
        if part in ("nullColumns", "nullRows"):
            out.append("Null")
        elif part:
            out.append(part[0].upper() + part[1:])
    return " ".join(out)


def lambda_cat(val: float) -> str:
    """Box-Cox λ → transformation label (reference :2734-2765)."""
    if val < -1:
        return "Reciprocal Square Transform"
    if val < -0.5:
        return "Reciprocal Transform"
    if val < 0:
        return "Receiprocal Square Root Transform"
    if val < 0.5:
        return "Log Transform"
    if val < 1:
        return "Square Root Transform"
    if val < 2:
        return "No Transform"
    return "Square Transform"


def list_ts_remove_append(l: list, opt) -> list:
    """Strip (opt==1) or append (else) the ``_ts`` suffix (reference :2308-2343)."""
    if opt == 1:
        return [i[:-3] if str(i).endswith("_ts") else i for i in l]
    return [i if str(i).endswith("_ts") else i + "_ts" for i in l]


def drift_stability_ind(missing_recs_drift, drift_tab, missing_recs_stability, stability_tab):
    """(drift_ind, stability_ind) from the missing-file lists (reference :440-473)."""
    drift_ind = 0 if len(missing_recs_drift) == len(drift_tab) else 1
    if len(missing_recs_stability) == len(stability_tab):
        stability_ind = 0
    elif "stabilityIndex_metrics" in missing_recs_stability and "stability_index" not in missing_recs_stability:
        stability_ind = 0.5
    else:
        stability_ind = 1
    return drift_ind, stability_ind


def chart_gen_list(master_path: str, chart_type: str, type_col=None) -> List[dict]:
    """Plotly fig dicts for every ``<chart_type>*`` dump (reference :475-521);
    ``type_col`` restricts to the named attributes."""
    figs = []
    for f in sorted(glob.glob(ends_with(master_path) + chart_type + "*")):
        attr = os.path.basename(f)[len(chart_type):]
        attr = attr[:-5] if attr.endswith(".json") else attr
        if type_col is not None and attr not in set(map(str, type_col)):
            continue
        fig = _load_fig(f)
        if fig is not None:
            figs.append(fig)
    return figs


def line_chart_gen_stability(df1: pd.DataFrame, df2: pd.DataFrame, col: str) -> List[dict]:
    """Per-attribute stability charts (reference :99-230): metric lines over
    the history frame ``df2`` plus the SI gauge from the summary frame ``df1``."""
    figs = []
    hist = df2[df2["attribute"].astype(str) == str(col)] if df2 is not None and "attribute" in df2 else None
    if hist is not None and len(hist):
        x = list(range(1, len(hist) + 1))
        for metric in ("mean", "stddev", "kurtosis"):
            if metric in hist:
                figs.append(_line_fig(x, {metric: hist[metric].tolist()}, f"{metric} across idx — {col}", metric))
    if df1 is not None and "attribute" in df1:
        row = df1[df1["attribute"].astype(str) == str(col)]
        if len(row):
            si = float(row["stability_index"].iloc[0])
            figs.append(
                {
                    "data": [{
                        "type": "indicator", "mode": "gauge+number", "value": si,
                        "title": {"text": f"{col} — {_si_category(si)}"},
                        "gauge": {"axis": {"range": [0, 4]}},
                    }],
                    "layout": {"template": "plotly_white"},
                }
            )
    return figs


def executive_summary_gen(
    master_path: str,
    label_col: str = "",
    ds_ind=None,
    id_col: str = "",
    iv_threshold: float = 0.02,
    corr_threshold: float = 0.4,
    print_report: bool = False,
) -> str:
    """Executive-summary tab (reference :524-906)."""
    return _executive_summary(master_path, id_col, label_col, corr_threshold, iv_threshold)


def wiki_generator(
    master_path: str, dataDict_path=None, metricDict_path=None, print_report: bool = False
) -> str:
    """Wiki tab: data dictionary + metric dictionary + observed datatypes
    (reference :909-991)."""
    html = ""
    dt = _read_csv(master_path, "data_type")
    if dt is not None and len(dt):
        html += _table_html(dt, "observed data types")
    for path, title in [(dataDict_path, "data dictionary"), (metricDict_path, "metric dictionary")]:
        if path and path != "NA" and os.path.exists(str(path)):
            try:
                html += _table_html(pd.read_csv(path), title)
            except Exception:
                pass
    return html


def data_analyzer_output(master_path: str, avl_recs_tab, tab_name: str) -> str:
    """Tables for one analyzer tab's available stat files (reference :233-438)."""
    html = ""
    for name in avl_recs_tab or []:
        df = _read_csv(master_path, str(name))
        if df is not None:
            html += _table_html(df, str(name))
    return html


def descriptive_statistics(
    master_path: str,
    SG_tabs=tuple(_SG_FILES),
    avl_recs_SG=None,
    missing_recs_SG=None,
    all_charts_num_1_=None,
    all_charts_cat_1_=None,
    print_report: bool = False,
    label_col: str = "",
) -> str:
    """Descriptive-stats tab with per-attribute drill-downs (reference :994-1151)."""
    sg_frames = {name: df for name in SG_tabs if (df := _read_csv(master_path, name)) is not None}
    html = "".join(_table_html(df, name) for name, df in sg_frames.items())
    profiles_html, covered = _attribute_profiles(master_path, label_col, sg_frames)
    html += profiles_html
    html += _charts_html(master_path, "freqDist_", "frequency distributions", exclude=covered)
    if label_col:
        html += _charts_html(master_path, "eventDist_", f"event rates vs {label_col}", exclude=covered)
    return html


def quality_check(
    master_path: str,
    QC_tabs=tuple(_QC_FILES),
    avl_recs_QC=None,
    missing_recs_QC=None,
    all_charts_num_3_=None,
    print_report: bool = False,
) -> str:
    """Quality-check tab (reference :1154-1288)."""
    html = "".join(
        _table_html(df, name) for name in QC_tabs if (df := _read_csv(master_path, name)) is not None
    )
    return html + _charts_html(master_path, "outlier_", "outlier distributions")


def attribute_associations(
    master_path: str,
    AE_tabs=tuple(_AE_FILES),
    avl_recs_AE=None,
    missing_recs_AE=None,
    label_col: str = "",
    all_charts_num_2_=None,
    all_charts_cat_2_=None,
    print_report: bool = False,
) -> str:
    """Attribute-associations tab: correlation heatmap + IV/IG/varclus tables
    (reference :1291-1431)."""
    html = ""
    corr = _read_csv(master_path, "correlation_matrix")
    if corr is not None:
        attrs = list(corr["attribute"])
        z = corr.drop(columns=["attribute"]).to_numpy(dtype=float).tolist()
        fig = {
            "data": [{"type": "heatmap", "z": z, "x": list(corr.columns[1:]), "y": attrs, "colorscale": "RdBu", "zmid": 0}],
            "layout": {"title": {"text": "correlation matrix"}, "template": "plotly_white"},
        }
        html += _fig_div(fig, "corrheat", 480)
    for name in AE_tabs:
        if name == "correlation_matrix":
            continue
        df = _read_csv(master_path, name)
        if df is not None:
            html += _table_html(df, name)
    return html


def data_drift_stability(
    master_path: str,
    ds_ind=None,
    id_col: str = "",
    drift_threshold_model: float = 0.1,
    all_drift_charts_=None,
    print_report: bool = False,
) -> str:
    """Drift & stability tab with SI gauges and metric lines (reference :1434-1939)."""
    html = ""
    drift = _read_csv(master_path, "drift_statistics")
    if drift is not None:
        if "flagged" in drift:
            drifted = int((drift["flagged"] > 0).sum())
            html += (
                f"<p><b>{drifted}</b> of <b>{len(drift)}</b> attributes drifted beyond the "
                f"{drift_threshold_model} threshold.</p>"
            )
        html += _table_html(drift, "drift_statistics")
    stab = _read_csv(master_path, "stability_index")
    if stab is not None:
        html += _table_html(stab, "stability_index")
    html += _stability_charts(master_path)
    html += _charts_html(master_path, "drift_", "source vs target distributions")
    return html


def ts_stats(base_path: str) -> Optional[pd.DataFrame]:
    """Timestamp-eligibility frame the ts tab leads with (reference :3051-3089)."""
    return _read_csv(base_path, "ts_stats")


def ts_landscape(base_path: str, ts_cols=None, id_col=None) -> Optional[pd.DataFrame]:
    """Time-series landscape frame (reference :2636-2732)."""
    land = _read_csv(base_path, "ts_landscape")
    if land is not None and ts_cols:
        keep = set(map(str, ts_cols))
        name_col = land.columns[0]
        land = land[land[name_col].astype(str).isin(keep)] if len(land) else land
    return land


_TS_GRAIN_FILES = {"daily": "ts_daily_", "hourly": "ts_daypart_", "weekly": "ts_weekly_"}


def gen_time_series_plots(base_path: str, x_col: str, y_col: str, time_cat: str) -> Optional[dict]:
    """One volume/trend fig at the requested grain (reference :2054-2305).
    ``x_col`` is the timestamp column; ``y_col`` is ``count`` for volume or a
    numeric attribute for its per-grain trend."""
    grain = str(time_cat).lower()
    prefix = _TS_GRAIN_FILES.get(grain)
    if prefix is None:
        return None
    if y_col in ("count", "", None):
        df = _read_csv(base_path, f"{prefix}{x_col}".replace(".csv", ""))
        if df is None or not len(df):
            return None
        if grain == "daily":
            return _line_fig(df.iloc[:, 0], {"records": df["count"].tolist()}, f"daily volume — {x_col}", "count")
        return _bar_fig(df.iloc[:, 0], df["count"], f"{grain} volume — {x_col}")
    num = _read_csv(base_path, f"ts_num_{grain}_{x_col}")
    if num is None or "attribute" not in num:
        return None
    sub = num[num["attribute"].astype(str) == str(y_col)]
    if not len(sub):
        return None
    if grain == "daily":
        return _line_fig(sub["date"], {"mean": sub["mean"].tolist(), "median": sub["median"].tolist()},
                         f"{y_col} over time", y_col)
    return _bar_fig(sub["bucket"], sub["mean"], f"{y_col} mean by {grain}")


def plotSeasonalDecompose(
    base_path: str, x_col: str, y_col: str = "count", metric_col: str = "median",
    title: str = "Seasonal Decomposition",
) -> List[dict]:
    """Observed/trend/seasonal/residual figs from the decomposition dump
    (reference :1942-2051)."""
    dec = _read_csv(base_path, f"ts_decompose_{x_col}")
    if dec is None or not len(dec):
        return []
    return [
        _line_fig(dec["date"], {part: dec[part].tolist()}, f"{title} — {part}")
        for part in ("observed", "trend", "seasonal", "residual")
        if part in dec
    ]


def _ts_viz(base_path, ts_col, col_list, grain):
    """Shared body of the nine ``ts_viz_<grain>_<view>`` builders: the
    reference repeats one figure loop per (grain, view) pair (:2345-3049);
    here each named entry delegates with its grain and column list."""
    cols = col_list if isinstance(col_list, (list, tuple)) else [col_list]
    figs = [gen_time_series_plots(base_path, ts_col, "count", grain)]
    figs += [gen_time_series_plots(base_path, ts_col, c, grain) for c in cols if c]
    return [f for f in figs if f is not None]


def ts_viz_1_1(base_path, x_col, y_col, output_type=None):
    """Daily volume + one attribute trend (reference :2345)."""
    return _ts_viz(base_path, x_col, y_col, "daily")


def ts_viz_1_2(base_path, ts_col, col_list, output_type=None):
    """Daily trends across attributes (reference :2370)."""
    return _ts_viz(base_path, ts_col, col_list, "daily")


def ts_viz_1_3(base_path, ts_col, num_cols, cat_cols=None, output_type=None):
    """Daily trends, numeric + categorical mix (reference :2402)."""
    return _ts_viz(base_path, ts_col, list(num_cols or []) + list(cat_cols or []), "daily")


def ts_viz_2_1(base_path, x_col, y_col):
    """Hourly/daypart volume + one attribute (reference :2497)."""
    return _ts_viz(base_path, x_col, y_col, "hourly")


def ts_viz_2_2(base_path, ts_col, col_list):
    """Hourly trends across attributes (reference :2529)."""
    return _ts_viz(base_path, ts_col, col_list, "hourly")


def ts_viz_2_3(base_path, ts_col, num_cols):
    """Hourly numeric trends (reference :2559)."""
    return _ts_viz(base_path, ts_col, num_cols, "hourly")


def ts_viz_3_1(base_path, x_col, y_col):
    """Weekly volume + one attribute (reference :2767)."""
    return _ts_viz(base_path, x_col, y_col, "weekly")


def ts_viz_3_2(base_path, ts_col, col_list):
    """Weekly trends across attributes (reference :2955)."""
    return _ts_viz(base_path, ts_col, col_list, "weekly")


def ts_viz_3_3(base_path, ts_col, num_cols):
    """Weekly numeric trends (reference :2985)."""
    return _ts_viz(base_path, ts_col, num_cols, "weekly")


def ts_viz_generate(master_path: str, id_col: str = "", print_report: bool = False, output_type=None) -> str:
    """Full time-series tab HTML (reference :3091-3207)."""
    return _ts_tab(master_path)


def overall_stats_gen(lat_col_list, long_col_list, geohash_col_list):
    """(field-name dict, #lat-long pairs, #geohash cols) (reference :3210-3248)."""
    d = {}
    for key, cols in [
        ("Latitude Col", lat_col_list),
        ("Longitude Col", long_col_list),
        ("Geohash Col", geohash_col_list),
    ]:
        d[key] = ",".join(str(c) for c in (cols or []))
    return d, len(lat_col_list or []), len(geohash_col_list or [])


def loc_field_stats(lat_col_list, long_col_list, geohash_col_list, max_records) -> pd.DataFrame:
    """Identified-fields summary frame (reference :3250-3296)."""
    d, n_ll, n_gh = overall_stats_gen(lat_col_list, long_col_list, geohash_col_list)
    rows = [{"stats": k, "value": v} for k, v in d.items()]
    rows += [
        {"stats": "Lat-Long Pairs", "value": n_ll},
        {"stats": "Geohash Columns", "value": n_gh},
        {"stats": "Max Records Analyzed", "value": max_records},
    ]
    return pd.DataFrame(rows)


def read_stats_ll_geo(lat_col, long_col, geohash_col, master_path: str, top_geo_records) -> Dict[str, pd.DataFrame]:
    """Overall-summary + top-location frames per field (reference :3298-3533)."""
    out: Dict[str, pd.DataFrame] = {}
    names = [f"{a}_{b}" for a, b in zip(lat_col or [], long_col or [])] + list(geohash_col or [])
    for name in names:
        for prefix in ("geospatial_overall_", "geospatial_top_"):
            df = _read_csv(master_path, f"{prefix}{name}")
            if df is not None:
                out[f"{prefix}{name}"] = df.head(int(top_geo_records)) if prefix.endswith("top_") else df
    return out


def read_cluster_stats_ll_geo(lat_col, long_col, geohash_col, master_path: str) -> Dict[str, pd.DataFrame]:
    """KMeans/DBSCAN cluster frames per field (reference :3535-3810)."""
    out: Dict[str, pd.DataFrame] = {}
    names = [f"{a}_{b}" for a, b in zip(lat_col or [], long_col or [])] + list(geohash_col or [])
    for name in names:
        for algo in ("kmeans", "dbscan"):
            df = _read_csv(master_path, f"geospatial_{algo}_{name}")
            if df is not None:
                out[f"{algo}_{name}"] = df
    return out


def read_loc_charts(master_path: str) -> List[dict]:
    """Location scatter/density fig dicts (reference :3812-3900)."""
    return chart_gen_list(master_path, "geo_scatter_") + chart_gen_list(master_path, "geo_heat_")


def loc_report_gen(
    lat_cols=None,
    long_cols=None,
    geohash_cols=None,
    master_path: str = ".",
    max_records: int = 100000,
    top_geo_records: int = 100,
    print_report: bool = False,
) -> str:
    """Full geospatial tab HTML (reference :3902-3981)."""
    return _geo_tab(master_path)



def run_timings_gen(master_path: str = ".") -> str:
    """"Run Timings" tab: the node-timing table from the obs run manifest.

    Reads ``<master_path>/obs/run_manifest.json`` — the machine-readable
    record the workflow writes AFTER a run completes.  A report generated
    mid-run against a fresh output directory (the normal in-pipeline
    ``report_generation`` node) finds no manifest yet and the tab is
    omitted — which is what keeps the HTML byte-identical across executor
    modes in the golden parity suite's fresh-directory setup.  When a
    manifest IS present (a report re-generated over an earlier job's
    master_path — the split-job flow — or an in-pipeline re-run into the
    same directory), the tab surfaces THAT completed run's executor mode,
    critical path, per-node walls and queue waits, stamped with the
    manifest's generation time so a reader can tell it describes the
    previous completed run, not necessarily the run that rendered this
    report.
    """
    path = os.path.join(master_path, "obs", "run_manifest.json")
    if not os.path.exists(path):
        return ""
    try:
        with open(path) as f:
            man = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        logger.warning("run manifest at %s unreadable (%s); omitting timings tab", path, e)
        return ""
    sched = man.get("scheduler") or {}
    html = ["<h3>Workflow Run Timings</h3>"]
    import time as _time

    gen = man.get("generated_unix")
    gen_iso = (
        _time.strftime("%Y-%m-%dT%H:%M:%SZ", _time.gmtime(gen))
        if isinstance(gen, (int, float)) else "unknown"
    )
    html.append(
        "<p>From <code>obs/run_manifest.json</code> — the most recent completed "
        f"run at this master path, generated <b>{escape(gen_iso)}</b> "
        f"(executor <b>{escape(str(man.get('executor', {}).get('mode')))}</b>, "
        f"config <code>{escape(str(man.get('config_hash', ''))[:12])}</code>, "
        f"backend <b>{escape(str(man.get('backend')))}</b>).</p>"
    )
    kv = pd.DataFrame(
        {
            "metric": ["wall_s", "serial_s", "critical_path_s", "parallel_speedup", "workers"],
            "value": [sched.get("wall_s"), sched.get("serial_s"),
                      sched.get("critical_path_s"), sched.get("parallel_speedup"),
                      sched.get("workers")],
        }
    )
    html.append(_table_html(kv, "scheduler summary"))
    nodes = sched.get("nodes") or {}
    if nodes:
        rows = [
            {
                "node": name,
                "state": nd.get("state"),
                "dur_s": nd.get("dur_s"),
                "queue_wait_s": nd.get("queue_wait_s"),
                "worker": nd.get("thread"),
                "deps": ", ".join(nd.get("deps") or []),
            }
            for name, nd in nodes.items()
        ]
        node_df = pd.DataFrame(rows).sort_values(
            "dur_s", ascending=False, na_position="last")
        html.append(_table_html(node_df, "per-node execution"))
    cp = man.get("critical_path") or []
    if cp:
        html.append("<p>Critical path: <code>"
                    + escape(" → ".join(cp)) + "</code></p>")
    blocks = man.get("block_seconds") or {}
    if blocks:
        blk = pd.DataFrame(
            sorted(blocks.items(), key=lambda kv: -kv[1]),
            columns=["block", "wall_s"],
        )
        html.append(_table_html(blk, "per-block wall time"))
    html.append(_devprof_split_html(man.get("devprof") or {}))
    return "".join(html)


# devprof stacked-bar segment colors: categorical slots 1-3 of the
# validated default palette (all-pairs CVD-clean on a light surface) for
# the three attributed categories, neutral gray for the host remainder;
# identity never rides color alone — the legend + per-segment tooltips
# carry it, and the numbers are in the adjacent table
_DEVPROF_SEGMENTS = (
    ("device", "device_time_s", "#2a78d6"),
    ("dispatch", "dispatch_s", "#eb6834"),
    ("transfer", "transfer_s", "#1baf7a"),
    ("host", "host_s", "#b4b2ab"),
)


def _devprof_split_html(dev: dict) -> str:
    """Per-node device/dispatch/transfer/host stacked split from the
    manifest's ``devprof`` section (obs.devprof); empty string when the
    manifest predates the section."""
    rows = [(name, e) for name, e in dev.items()
            if isinstance(e, dict) and (e.get("wall_s") or 0) > 0]
    if not rows:
        return ""
    rows.sort(key=lambda kv: -(kv[1].get("wall_s") or 0))
    max_wall = max(e.get("wall_s") or 0 for _, e in rows) or 1.0
    html = ["<h4>Device-time attribution (obs.devprof)</h4>",
            "<p>Each node's wall split into <b>device</b> (device-queue "
            "drain), <b>dispatch</b> (host wall inside jitted ops), "
            "<b>transfer</b> (host&harr;device materialization) and "
            "<b>host</b> (the remainder). Bar lengths are scaled to the "
            "slowest node.</p>"]
    legend = "".join(
        f"<span style='display:inline-block;margin-right:14px'>"
        f"<span style='display:inline-block;width:10px;height:10px;"
        f"background:{color};border-radius:2px;margin-right:4px'></span>"
        f"{escape(label)}</span>"
        for label, _, color in _DEVPROF_SEGMENTS)
    html.append(f"<div style='margin:4px 0 8px 0'>{legend}</div>")
    for name, e in rows:
        wall = e.get("wall_s") or 0.0
        width_pct = wall / max_wall * 100.0
        segs = []
        for label, key, color in _DEVPROF_SEGMENTS:
            v = float(e.get(key) or 0.0)
            if v <= 0:
                continue
            seg_pct = v / wall * 100.0
            segs.append(
                f"<span title='{escape(label)} {v:.4f}s "
                f"({seg_pct:.0f}%)' style='display:inline-block;"
                f"height:12px;background:{color};width:{seg_pct:.2f}%;"
                # 2px surface gap between stacked segments
                f"border-right:2px solid #fff;box-sizing:border-box'>"
                "</span>")
        xfer = (e.get("h2d_bytes") or 0) + (e.get("d2h_bytes") or 0)
        html.append(
            "<div style='margin:3px 0;font-size:12px'>"
            f"<code>{escape(name)}</code> — {wall:.3f}s"
            + (f", {xfer / 1e6:.1f} MB moved" if xfer else "")
            + f"<div style='width:{width_pct:.1f}%;min-width:40px;"
              f"white-space:nowrap;font-size:0'>{''.join(segs)}</div></div>")
    tbl = pd.DataFrame([
        {"node": name,
         "wall_s": e.get("wall_s"),
         "device_s": e.get("device_time_s"),
         "dispatch_s": e.get("dispatch_s"),
         "transfer_s": e.get("transfer_s"),
         "host_s": e.get("host_s"),
         "h2d_bytes": e.get("h2d_bytes"),
         "d2h_bytes": e.get("d2h_bytes"),
         "last_op": e.get("last_op")}
        for name, e in rows
    ])
    html.append(_table_html(tbl, "devprof per node"))
    return "".join(html)


def degraded_tab() -> Optional[tuple]:
    """("Degraded Sections", html) when this run degraded a section or
    quarantined an input part, else None (a clean run's HTML is unchanged).

    The analytics nodes that exhausted their retries did not abort the
    run: their CSVs are absent (each tab's reader already tolerates that)
    and the report leads with a placeholder naming each one, and the parts
    the ingest guard set aside with the rows they held."""
    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.resilience.policy import degraded_sections

    degraded = degraded_sections()
    quarantine = guard.records()
    if not (degraded or quarantine):
        return None
    items = "".join(
        f"<li><b>{escape(node)}</b> — {escape(reason)}</li>"
        for node, reason in sorted(degraded.items())
    )
    qrows = ""
    if quarantine:
        body = "".join(
            "<tr><td>{f}</td><td>{ec}</td><td>{rows}</td></tr>".format(
                f=escape(os.path.basename(r.file)),
                ec=escape(r.error_class),
                rows=("unknown" if r.rows_lost is None
                      else f"{r.rows_lost}{' (est.)' if r.rows_estimated else ''}"),
            )
            for r in sorted(quarantine, key=lambda r: r.file)
        )
        lost = sum(r.rows_lost or 0 for r in quarantine)
        qrows = (
            f"<p><b>{len(quarantine)} input part(s) QUARANTINED</b> "
            f"({lost} row(s) lost where measurable): every statistic "
            "below was computed WITHOUT these rows — see "
            "<code>obs/quarantine_manifest.json</code>.</p>"
            "<table class='anv-degraded-q'><tr><th>part</th>"
            "<th>error</th><th>rows lost</th></tr>"
            f"{body}</table>"
        )
    return (
        "Degraded Sections",
        "<div class='anv-degraded'><p><b>"
        f"{len(degraded)} analytics section(s) DEGRADED this run"
        "</b>: the nodes below exhausted their retry budget and were "
        "skipped rather than aborting the pipeline (see the run "
        "manifest's <code>resilience</code> section and "
        "<code>obs/run_journal.jsonl</code> for the failure record). "
        "Their statistics are missing from the tabs that follow.</p>"
        f"<ul>{items}</ul>{qrows}</div>",
    )


def anovos_report(
    master_path: str = ".",
    id_col: str = "",
    label_col: str = "",
    corr_threshold: float = 0.4,
    iv_threshold: float = 0.02,
    drift_threshold_model: float = 0.1,
    dataDict_path: str = "NA",
    metricDict_path: str = "NA",
    final_report_path: str = ".",
    run_type: str = "local",
    auth_key: str = "NA",
    **_ignored,
) -> str:
    """Assemble ``ml_anovos_report.html`` from the master_path contract.

    Remote ``run_type`` paths resolve through the artifact store: stats are
    READ from the store's local staging of ``master_path`` (where
    save_stats/charts_to_objects staged them) and the finished HTML is
    pushed to the configured ``final_report_path``."""
    from anovos_tpu_torch.shared.artifact_store import for_run_type

    store = for_run_type(run_type, auth_key)
    configured_master = master_path
    master_path = store.staging_dir(master_path)
    # A standalone report run over stats produced by an EARLIER job finds an
    # empty staging dir — pull the remote master_path contents down first
    # (reference report_generation.py:4053-4080 'aws s3 cp --recursive').
    if master_path != configured_master and not (
        os.path.isdir(master_path) and os.listdir(master_path)
    ):
        try:
            master_path = store.pull_dir(configured_master, master_path)
        except Exception as e:  # nothing remote: the tabs degrade per-section
            logger.warning("stats pull from %s failed (%s); using staging", configured_master, e)
    report_dest, final_report_path = final_report_path, store.staging_dir(final_report_path)
    Path(final_report_path).mkdir(parents=True, exist_ok=True)
    # remote dictionary CSVs are fetched before the wiki tab reads them
    if dataDict_path != "NA":
        dataDict_path = store.pull(dataDict_path, os.path.join(final_report_path, "_data_dictionary.csv"))
    if metricDict_path != "NA":
        metricDict_path = store.pull(metricDict_path, os.path.join(final_report_path, "_metric_dictionary.csv"))
    with _table_seq_lock:
        _table_seq[0] = 0
    tabs: List[tuple] = []
    degraded = degraded_tab()
    if degraded is not None:
        tabs.append(degraded)

    tabs.append(
        (
            "Executive Summary",
            executive_summary_gen(master_path, label_col, None, id_col, iv_threshold, corr_threshold)
            or "<p>no global summary found</p>",
        )
    )
    tabs.append(
        ("Wiki", wiki_generator(master_path, dataDict_path, metricDict_path) or "<p>no dictionaries configured</p>")
    )
    tabs.append(
        (
            "Descriptive Statistics",
            descriptive_statistics(master_path, label_col=label_col) or "<p>no stats found</p>",
        )
    )
    tabs.append(("Quality Check", quality_check(master_path) or "<p>no quality stats found</p>"))
    tabs.append(
        ("Attribute Associations", attribute_associations(master_path, label_col=label_col) or "<p>no association stats found</p>")
    )
    tabs.append(
        (
            "Drift & Stability",
            data_drift_stability(master_path, None, id_col, drift_threshold_model) or "<p>no drift stats found</p>",
        )
    )

    ts_html = ts_viz_generate(master_path, id_col)
    if ts_html:
        tabs.append(("Time Series", ts_html))
    geo_html = loc_report_gen(master_path=master_path)
    if geo_html:
        tabs.append(("Geospatial", geo_html))
    timings_html = run_timings_gen(master_path)
    if timings_html:
        tabs.append(("Run Timings", timings_html))

    nav = "".join(
        f"<button class=\"{'active' if i == 0 else ''}\" onclick='showTab({i})'>{escape(t)}</button>"
        for i, (t, _) in enumerate(tabs)
    )
    sections = "".join(
        f"<section class=\"{'active' if i == 0 else ''}\">{body}</section>"
        for i, (_, body) in enumerate(tabs)
    )
    html = (
        "<!DOCTYPE html><html><head><meta charset='utf-8'><title>Anovos-TPU Report</title>"
        f"{_plotly_script_tag()}<style>{_CSS}</style><script>{_JS}</script></head>"
        "<body><header><h2>Anovos-TPU — Data Report</h2></header>"
        f"<nav>{nav}</nav><main>{sections}</main></body></html>"
    )
    out = ends_with(final_report_path) + "ml_anovos_report.html"
    with open(out, "w") as f:
        f.write(html)
    store.push(out, report_dest)
    return out
