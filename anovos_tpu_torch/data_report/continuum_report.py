"""Incremental section renderer for the continuum feed report
(counterpart of ``anovos_tpu/data_report/continuum_report.py``; given the
same artifact frames it writes the same bytes).

``anovos_report`` rebuilds every tab from the whole master_path on each
call — correct for a one-shot batch run, wasteful for a service that
re-finalizes after every partition arrival where usually ONE artifact
moved.  This renderer keys each section's HTML fragment on a digest of
its input artifact: unchanged inputs reuse the cached fragment byte-for-
byte (``sections/`` under the state dir), so a drift-only day re-renders
the drift section and splices the rest.

The assembled ``continuum_report.html`` is DETERMINISTIC — no
timestamps, content ordered by artifact frames alone — so an incremental
feed and a from-scratch step over the same partitions write the same
bytes.  A quarantined partition renders an explicit table naming the part
and its error class (the facts the degradation registry holds).
"""

from __future__ import annotations

import hashlib
import json
import os
from html import escape
from typing import Dict, List, Optional, Tuple

import pandas as pd

__all__ = ["render_report"]

REPORT_NAME = "continuum_report.html"

_STYLE = """
body { font-family: sans-serif; margin: 1.5em; color: #222; }
h2 { border-bottom: 2px solid #48a; padding-bottom: 0.2em; }
table { border-collapse: collapse; margin: 0.6em 0; }
th, td { border: 1px solid #bbb; padding: 3px 9px; text-align: right; }
th { background: #eef; }
td:first-child, th:first-child { text-align: left; }
.anv-degraded { background: #fff3f0; border: 1px solid #d66; padding: 0.7em; }
.anv-flagged { color: #b00; font-weight: bold; }
"""


def _df_table(df: pd.DataFrame, max_rows: int = 200) -> str:
    if df is None or not len(df):
        return "<p>no rows</p>"
    shown = df.head(max_rows)
    head = "".join(f"<th>{escape(str(c))}</th>" for c in shown.columns)
    body = []
    for _, r in shown.iterrows():
        cells = []
        for c in shown.columns:
            v = r[c]
            txt = "" if v is None or (isinstance(v, float) and v != v) else str(v)
            cls = " class='anv-flagged'" if (c == "flagged" and txt == "1") else ""
            cells.append(f"<td{cls}>{escape(txt)}</td>")
        body.append("<tr>" + "".join(cells) + "</tr>")
    more = (f"<p>… {len(df) - max_rows} more row(s) in the CSV</p>"
            if len(df) > max_rows else "")
    return f"<table><tr>{head}</tr>{''.join(body)}</table>{more}"


def _digest(payload) -> str:
    return hashlib.sha256(payload).hexdigest()[:24]


def _frame_bytes(df: Optional[pd.DataFrame]) -> bytes:
    if df is None:
        return b"<absent>"
    return df.to_csv(index=False).encode()


def _sanitize_quarantine(quarantined: dict) -> Dict[str, str]:
    """{part key: error class} — the report must stay byte-identical
    between an incremental and a from-scratch leg, and the raw reason
    string embeds run-local absolute paths; the error CLASS is the
    portable fact (exact accounting lives in the quarantine manifest)."""
    out = {}
    for k, e in sorted((quarantined or {}).items()):
        reason = str(e.get("reason", "")) if isinstance(e, dict) else str(e)
        out[k] = reason.split(":", 1)[0] or "quarantined"
    return out


def _section_inputs(arts: Dict[str, pd.DataFrame], quarantined: dict,
                    feed: dict) -> List[Tuple[str, str, bytes]]:
    """(section title, slug, input bytes) in render order."""
    out = [
        ("Feed Summary", "summary",
         json.dumps({"feed": feed,
                     "quarantined": sorted(quarantined)}, sort_keys=True).encode()),
    ]
    if quarantined:
        out.append(("Degraded / Quarantined", "degraded",
                    json.dumps(_sanitize_quarantine(quarantined),
                               sort_keys=True).encode()))
    for title, slug, key in (
            ("Descriptive Statistics", "stats", "stats"),
            ("Missing Values", "missing", "missing"),
            ("Categorical Summary", "categorical", "categorical"),
            ("Outliers", "outlier", "outlier"),
            ("Drift", "drift", "drift"),
            ("Stability", "stability", "stability")):
        if key in arts:
            out.append((title, slug, _frame_bytes(arts[key])))
    return out


def _render_section(slug: str, title: str, arts: Dict[str, pd.DataFrame],
                    quarantined: dict, feed: dict) -> str:
    if slug == "summary":
        rows = "".join(
            f"<tr><td>{escape(str(k))}</td><td>{escape(str(v))}</td></tr>"
            for k, v in sorted(feed.items()))
        note = (f"<p class='anv-degraded'><b>{len(quarantined)} partition(s) "
                "quarantined</b> — see the Degraded section.</p>"
                if quarantined else "")
        return (f"<table><tr><th>field</th><th>value</th></tr>{rows}</table>"
                "<p>alerts stream to <code>obs/continuum_alerts.jsonl</code>; "
                "the WAL is <code>continuum_journal.jsonl</code>.</p>" + note)
    if slug == "degraded":
        body = "".join(
            "<tr><td>{p}</td><td>{r}</td></tr>".format(p=escape(k), r=escape(r))
            for k, r in sorted(_sanitize_quarantine(quarantined).items()))
        return ("<div class='anv-degraded'><p><b>Every statistic in this "
                "report was computed WITHOUT the partitions below</b> — the "
                "ingest guard set them aside (exact accounting in "
                "<code>obs/quarantine_manifest.json</code> when run inside a "
                "workflow).</p><table><tr><th>partition</th><th>reason</th>"
                f"</tr>{body}</table></div>")
    key = {"stats": "stats", "missing": "missing", "categorical": "categorical",
           "outlier": "outlier", "drift": "drift", "stability": "stability"}[slug]
    return _df_table(arts.get(key))


def render_report(out_dir: str, arts: Dict[str, pd.DataFrame],
                  quarantined: Optional[dict] = None,
                  feed: Optional[dict] = None,
                  cache_dir: Optional[str] = None) -> dict:
    """Assemble ``continuum_report.html`` in ``out_dir``, re-rendering
    only sections whose input digest moved.  Returns ``{"path",
    "rendered": [slugs], "reused": [slugs]}``."""
    quarantined = quarantined or {}
    feed = feed or {}
    cache_dir = cache_dir or os.path.join(out_dir, "sections")
    os.makedirs(cache_dir, exist_ok=True)
    rendered: List[str] = []
    reused: List[str] = []
    fragments: List[str] = []
    for title, slug, payload in _section_inputs(arts, quarantined, feed):
        dig = _digest(payload)
        frag_path = os.path.join(cache_dir, f"{slug}.html")
        dig_path = os.path.join(cache_dir, f"{slug}.digest")
        frag = None
        try:
            if os.path.exists(dig_path) and os.path.exists(frag_path):
                with open(dig_path) as f:
                    if f.read().strip() == dig:
                        with open(frag_path) as f2:
                            frag = f2.read()
        except OSError:
            frag = None
        if frag is None:
            frag = (f"<section id='{escape(slug)}'><h2>{escape(title)}</h2>"
                    + _render_section(slug, title, arts, quarantined, feed)
                    + "</section>")
            tmp = frag_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(frag)
            os.replace(tmp, frag_path)
            tmp = dig_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(dig)
            os.replace(tmp, dig_path)
            rendered.append(slug)
        else:
            reused.append(slug)
        fragments.append(frag)
    html = ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            "<title>anovos continuum report</title>"
            f"<style>{_STYLE}</style></head><body>"
            "<h1>Continuous feature-engineering report</h1>"
            + "".join(fragments) + "</body></html>")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, REPORT_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(html)
    os.replace(tmp, path)
    return {"path": path, "rendered": rendered, "reused": reused}
