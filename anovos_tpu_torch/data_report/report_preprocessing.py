"""Stats persistence + chart-object generation (counterpart of
``anovos_tpu/data_report/report_preprocessing.py``).

``save_stats`` → ``<master_path>/<function_name>.csv``.
``charts_to_objects`` → plotly-JSON chart files per column:
``freqDist_<col>``, ``eventDist_<col>`` (binary label), ``drift_<col>``
(source vs target frequencies, reusing the drift binning model + persisted
source frequency CSVs), ``outlier_<col>`` (numeric distribution), plus
``data_type.csv``.  The files are the JAX package's, value for value: the
numeric frequency charts bin through the histogram kernel
(``ops/drift_kernels.binned_histograms``), the event-rate bins through
``ops/histogram.digitize`` and two masked bincounts, the categorical charts
through code counts; every count reaches the host as f32, as the JAX
package's do.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.data_transformer.model_io import load_model_df
from anovos_tpu_torch.data_transformer.transformers import _event_vector
from anovos_tpu_torch.ops.drift_kernels import binned_histograms, fit_cutoffs
from anovos_tpu_torch.ops.histogram import digitize, masked_bincount
from anovos_tpu_torch.ops.segment import code_counts, code_label_counts
from anovos_tpu_torch.shared.artifact_store import for_run_type
from anovos_tpu_torch.shared.table import Column, Table
from anovos_tpu_torch.shared.utils import ends_with, parse_cols

global_theme = "#8000ff"
global_theme_r = "#ff0055"


def save_stats(
    idf: pd.DataFrame,
    master_path: str,
    function_name: str,
    reread: bool = False,
    run_type: str = "local",
    mlflow_config=None,
    auth_key: str = "NA",
) -> pd.DataFrame:
    """Persist a stats frame as ``<master_path>/<function_name>.csv``.  The
    ``run_type`` axis routes through the artifact store: the CSV lands in
    the store's local staging dir and is pushed to the configured (possibly
    remote) ``master_path``."""
    store = for_run_type(run_type, auth_key)
    local_dir = store.staging_dir(master_path)
    Path(local_dir).mkdir(parents=True, exist_ok=True)
    local_file = ends_with(local_dir) + function_name + ".csv"
    idf.to_csv(local_file, index=False)
    store.push(local_file, master_path)
    if mlflow_config is not None:
        try:  # pragma: no cover - optional dependency
            import mlflow

            mlflow.log_artifact(local_dir)
        except ImportError:
            pass
    if reread:
        return pd.read_csv(local_file)
    return idf


def _bar_fig(x, y, name: str, color: str = global_theme) -> dict:
    return {
        "data": [{"type": "bar", "x": list(x), "y": list(y), "name": name, "marker": {"color": color}}],
        "layout": {"title": {"text": name}, "template": "plotly_white"},
    }


def _grouped_fig(x, series: dict, title: str) -> dict:
    data = [
        {"type": "bar", "x": list(x), "y": list(np.asarray(v, dtype=float)), "name": k}
        for k, v in series.items()
    ]
    return {"data": data, "layout": {"title": {"text": title}, "barmode": "group", "template": "plotly_white"}}


def _violin_fig(values: np.ndarray, name: str) -> dict:
    return {
        "data": [
            {
                "type": "violin",
                "y": [float(v) for v in values],
                "name": name,
                "box": {"visible": True},
                "line": {"color": global_theme},
            }
        ],
        "layout": {"title": {"text": f"outlier distribution: {name}"}, "template": "plotly_white"},
    }


def _write_json(fig: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(fig, f)


def _host_f32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).cpu().numpy()


def _with_bounds(cutoffs: torch.Tensor, device) -> torch.Tensor:
    """Interior cutoffs (k, nb-1) → the (k, nb+1) f32 edges with ±inf
    bounds that ``ops/histogram.digitize`` takes."""
    cuts = cutoffs.to(device=device, dtype=torch.float32)
    inf = torch.full((cuts.shape[0], 1), float("inf"), device=device)
    return torch.cat([-inf, cuts, inf], dim=1)


def _binned_label_counts(X: torch.Tensor, M: torch.Tensor, cutoffs: torch.Tensor,
                         ym: torch.Tensor, y: torch.Tensor, nbins: int):
    """Per-column (total, event) bin counts (k, nbins) f32 for the
    event-rate charts: digitize against the interior cutoffs, then two
    masked bincounts over the rows whose label is valid."""
    bins = digitize(X.to(torch.float32), _with_bounds(cutoffs, X.device))
    Mv = M & ym[:, None]
    return (masked_bincount(bins, Mv, nbins),
            masked_bincount(bins, Mv & (y[:, None] > 0), nbins))


def _label_code_counts(col: Column, y: torch.Tensor, ym: torch.Tensor, vsize: int):
    """(total, event) counts per category code of the rows whose label is
    valid, as host f32."""
    m_eff = col.mask & ym
    tot = code_label_counts(col.data, m_eff, torch.ones_like(y), vsize)
    evs = code_label_counts(col.data, m_eff, y, vsize)
    return _host_f32(tot), _host_f32(evs)


_BIN_RANGE = re.compile(r"^(-?\d+(?:\.\d+)?)-(-?\d+(?:\.\d+)?)$")


def edit_binRange(col):
    """Collapse degenerate "x-x" bin-range labels to "x".  The split keys
    on the separator hyphen, not a leading minus sign, so negative-bound
    ranges like "-10--5" survive intact."""
    m = _BIN_RANGE.match(str(col))
    if m and m.group(1) == m.group(2):
        return m.group(1)
    return col


def _load_cut_map(cutoffs_path: Optional[str]) -> dict:
    """{attribute: cutoff array} from a persisted attribute_binning model;
    {} when the path holds no model."""
    if not cutoffs_path:
        return {}
    try:
        dfm = load_model_df(cutoffs_path, "attribute_binning")
    except (FileNotFoundError, ValueError):
        return {}
    return {r["attribute"]: np.asarray(list(r["parameters"]), float) for _, r in dfm.iterrows()}


def _cuts_tensor(cuts: np.ndarray, device) -> torch.Tensor:
    """Host cutoffs (k, nb-1) → f32 on ``device`` (cast on the host)."""
    return torch.as_tensor(np.asarray(cuts, np.float64).astype(np.float32), device=device)


def binRange_to_binIdx(idf: Table, col: str, cutoffs_path: str) -> Table:
    """Map a column's values to 1-based bin indices using a persisted binning
    model: the report-side re-binning primitive."""
    cut_map = _load_cut_map(cutoffs_path)
    if col not in cut_map:
        raise ValueError(f"no binning model for column {col} under {cutoffs_path}")
    c = idf.columns[col]
    cuts = _with_bounds(_cuts_tensor(cut_map[col][None, :], c.data.device), c.data.device)
    bins = digitize(c.data[:, None].to(torch.float32), cuts)[:, 0] + 1
    return idf.with_column(
        col + "_binIdx", Column("num", bins.to(torch.float32), c.mask, dtype_name="double")
    )


def plot_frequency(idf: Table, col: str, cutoffs_path: Optional[str] = None, bin_size: int = 10) -> dict:
    """Frequency-distribution figure for one column.  Numeric columns bin
    against the persisted model when given, else fresh equal-frequency
    cutoffs; categoricals count by dictionary code."""
    c = idf.columns[col]
    if c.kind == "cat":
        vsize = max(len(c.vocab), 1)
        cnts = _host_f32(code_counts(c.data, c.mask, vsize))
        order = np.argsort(-cnts)
        return _bar_fig(
            [str(c.vocab[j]) for j in order if cnts[j] > 0],
            [float(cnts[j]) for j in order if cnts[j] > 0],
            col,
        )
    cuts = _col_cutoffs(idf, col, cutoffs_path, bin_size)
    bin_size = len(cuts) + 1  # a persisted model may have been fit with another bin count
    counts = _host_f32(binned_histograms(c.data[:, None], c.mask[:, None],
                                         _cuts_tensor(cuts[None, :], c.data.device), bin_size))[0]
    return _bar_fig([f"{j + 1}" for j in range(bin_size)], counts.tolist(), col)


def plot_outlier(idf: Table, col: str, split_var: Optional[str] = None, sample_size: int = 500000) -> dict:
    """Violin figure of a numeric column on a ≤sample_size sample; with
    ``split_var`` one violin trace per category of that column."""
    vals = idf.columns[col].data.cpu().numpy()[: idf.nrows].astype(float)
    mask = idf.columns[col].mask.cpu().numpy()[: idf.nrows]
    if split_var is None:
        sample = vals[mask]
        if len(sample) > sample_size:
            sample = np.random.default_rng(0).choice(sample, sample_size, replace=False)
        return _violin_fig(sample, col)
    sc = idf.columns[split_var]
    if sc.kind != "cat":
        raise ValueError(f"split_var must be a categorical column, got {sc.kind!r} ({split_var})")
    codes = sc.data.cpu().numpy()[: idf.nrows]
    smask = mask & sc.mask.cpu().numpy()[: idf.nrows] & (codes >= 0)
    fig = None
    for code, name in enumerate(sc.vocab):
        sample = vals[smask & (codes == code)]
        if not len(sample):
            continue
        if len(sample) > sample_size:
            sample = np.random.default_rng(code).choice(sample, sample_size, replace=False)
        part = _violin_fig(sample, str(name))
        if fig is None:
            fig = part
            fig["layout"]["title"] = {"text": f"{col} by {split_var}"}
        else:
            fig["data"].extend(part["data"])
    return fig if fig is not None else _violin_fig(vals[mask], col)


def plot_eventRate(
    idf: Table, col: str, label_col: str, event_label, cutoffs_path: Optional[str] = None, bin_size: int = 10
) -> dict:
    """Per-bin / per-category event-rate figure."""
    y, ym = _event_vector(idf, label_col, event_label)
    c = idf.columns[col]
    if c.kind == "cat":
        vsize = max(len(c.vocab), 1)
        tot, evs = _label_code_counts(c, y, ym, vsize)
        with np.errstate(invalid="ignore", divide="ignore"):
            rate = np.where(tot > 0, evs / np.maximum(tot, 1), 0.0)
        order = np.argsort(-tot)
        return _bar_fig(
            [str(c.vocab[j]) for j in order if tot[j] > 0],
            [float(rate[j]) for j in order if tot[j] > 0],
            f"event rate: {col}",
            global_theme_r,
        )
    cuts = _col_cutoffs(idf, col, cutoffs_path, bin_size)
    bin_size = len(cuts) + 1  # a persisted model may have been fit with another bin count
    tot_d, evs_d = _binned_label_counts(c.data[:, None], c.mask[:, None],
                                        _cuts_tensor(cuts[None, :], c.data.device), ym, y, bin_size)
    tot, evs = _host_f32(tot_d)[0], _host_f32(evs_d)[0]
    with np.errstate(invalid="ignore", divide="ignore"):
        rate = np.where(tot > 0, evs / np.maximum(tot, 1), 0.0)
    return _bar_fig([f"{j + 1}" for j in range(bin_size)], rate.tolist(), f"event rate: {col}", global_theme_r)


def plot_comparative_drift(idf: Table, source_path: str, col: str, model_directory: str = "drift_statistics") -> dict:
    """Source-vs-target frequency figure from the persisted drift model CSVs."""
    fpath = os.path.join(source_path, model_directory, "frequency_counts", col, "part-00000.csv")
    if not os.path.exists(fpath):
        raise FileNotFoundError(f"no persisted source frequencies for {col} under {source_path}")
    fdf = pd.read_csv(fpath, dtype=str)
    skeys = fdf.iloc[:, 0].astype(str).tolist()
    sfreq = fdf["p"].astype(float).to_numpy()
    fig_t = plot_frequency(idf, col, cutoffs_path=os.path.join(source_path, model_directory))
    t_x = [str(v) for v in fig_t["data"][0]["x"]]
    t_y = np.asarray(fig_t["data"][0]["y"], float)
    t_y = t_y / max(t_y.sum(), 1)
    tmap = dict(zip(t_x, t_y))
    return _grouped_fig(skeys, {"source": sfreq, "target": [tmap.get(k, 0.0) for k in skeys]}, f"drift: {col}")


def _col_cutoffs(idf: Table, col: str, cutoffs_path: Optional[str], bin_size: int) -> np.ndarray:
    """Cutoffs from a persisted binning model when available, else a fresh fit."""
    cut_map = _load_cut_map(cutoffs_path)
    if col in cut_map:
        return cut_map[col]
    c = idf.columns[col]
    return fit_cutoffs([c.data], [c.mask], bin_size, "equal_frequency").cpu().numpy()[0]


def charts_to_objects(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    label_col=None,
    event_label=None,
    bin_method: str = "equal_frequency",
    bin_size: int = 10,
    coverage: float = 1.0,
    drift_detector: bool = False,
    source_path: str = "NA",
    model_directory: str = "drift_statistics",
    outlier_charts: bool = False,
    stats_unique: dict = {},
    master_path: str = ".",
    run_type: str = "local",
    auth_key: str = "NA",
    chart_sample: int = 500000,
    **_ignored,
) -> None:
    """Write per-column chart JSONs + data_type.csv into ``master_path``
    and publish them through the ``run_type`` store."""
    store = for_run_type(run_type, auth_key)
    dest_path, master_path = master_path, store.staging_dir(master_path)
    Path(master_path).mkdir(parents=True, exist_ok=True)
    num_all, cat_all, _ = idf.attribute_type_segregation()
    cols = parse_cols(
        list_of_cols if list_of_cols != "all" else num_all + cat_all, idf.col_names, drop_cols
    )
    cols = [c for c in cols if c != label_col]
    num_cols = [c for c in cols if idf.columns[c].kind == "num"]
    cat_cols = [c for c in cols if idf.columns[c].kind == "cat"]

    # label event vector (for eventDist charts)
    y = ym = None
    if label_col and label_col in idf.columns:
        y, ym = _event_vector(idf, label_col, event_label)

    # drift source frequencies (reuse the persisted drift model when present;
    # "NA" falls back to the drift detector's default dir)
    drift_freqs = {}
    drift_model_dir = os.path.join(
        source_path if source_path != "NA" else "intermediate_data", model_directory
    )
    if drift_detector and drift_model_dir and os.path.isdir(os.path.join(drift_model_dir, "frequency_counts")):
        for c in cols:
            fpath = os.path.join(drift_model_dir, "frequency_counts", c, "part-00000.csv")
            if os.path.exists(fpath):
                fdf = pd.read_csv(fpath, dtype=str)
                drift_freqs[c] = (fdf.iloc[:, 0].astype(str).tolist(), fdf["p"].astype(float).to_numpy())

    # ---- numeric columns: bin once (reuse drift cutoffs when available) ----
    if num_cols:
        cut_map = _load_cut_map(drift_model_dir)
        fit_cols = [c for c in num_cols if c not in cut_map]
        if fit_cols:
            cuts = fit_cutoffs([idf.columns[c].data for c in fit_cols],
                               [idf.columns[c].mask for c in fit_cols], bin_size, bin_method)
            for c, row in zip(fit_cols, cuts.cpu().numpy()):
                cut_map[c] = row
        X, M = idf.numeric_block(num_cols)
        cutoffs = _cuts_tensor(np.stack([cut_map[c] for c in num_cols]), X.device)
        counts = _host_f32(binned_histograms(X, M, cutoffs, bin_size))
        ev_counts = None
        if y is not None:
            tot_d, evs_d = _binned_label_counts(X, M, cutoffs, ym, y, bin_size)
            ev_counts = (_host_f32(tot_d), _host_f32(evs_d))
        for i, c in enumerate(num_cols):
            labels = [f"{j + 1}" for j in range(bin_size)]
            _write_json(_bar_fig(labels, counts[i].tolist(), c), ends_with(master_path) + "freqDist_" + c)
            if ev_counts is not None:
                tot, evs = ev_counts
                with np.errstate(invalid="ignore", divide="ignore"):
                    rate = np.where(tot[i] > 0, evs[i] / np.maximum(tot[i], 1), 0.0)
                _write_json(
                    _bar_fig(labels, rate.tolist(), f"event rate: {c}", global_theme_r),
                    ends_with(master_path) + "eventDist_" + c,
                )
            if c in drift_freqs:
                skeys, sfreq = drift_freqs[c]
                tfreq = counts[i] / max(counts[i].sum(), 1)
                _write_json(
                    _grouped_fig(skeys, {"source": sfreq, "target": tfreq[: len(skeys)]}, f"drift: {c}"),
                    ends_with(master_path) + "drift_" + c,
                )
            if outlier_charts:
                vals = idf.columns[c].data.cpu().numpy()[: idf.nrows].astype(float)
                mask = idf.columns[c].mask.cpu().numpy()[: idf.nrows]
                sample = vals[mask]
                if len(sample) > chart_sample:
                    sample = np.random.default_rng(0).choice(sample, chart_sample, replace=False)
                _write_json(_violin_fig(sample, c), ends_with(master_path) + "outlier_" + c)

    # ---- categorical columns ------------------------------------------------
    for c in cat_cols:
        col = idf.columns[c]
        vsize = max(len(col.vocab), 1)
        cnts = _host_f32(code_counts(col.data, col.mask, vsize))
        order = np.argsort(-cnts)
        cats = [str(col.vocab[j]) for j in order if cnts[j] > 0]
        vals = [float(cnts[j]) for j in order if cnts[j] > 0]
        _write_json(_bar_fig(cats, vals, c), ends_with(master_path) + "freqDist_" + c)
        if y is not None:
            tot, evs = _label_code_counts(col, y, ym, vsize)
            with np.errstate(invalid="ignore", divide="ignore"):
                rate = np.where(tot > 0, evs / np.maximum(tot, 1), 0.0)
            _write_json(
                _bar_fig([str(col.vocab[j]) for j in order if cnts[j] > 0],
                         [float(rate[j]) for j in order if cnts[j] > 0],
                         f"event rate: {c}", global_theme_r),
                ends_with(master_path) + "eventDist_" + c,
            )
        if c in drift_freqs:
            skeys, sfreq = drift_freqs[c]
            tmap = {str(col.vocab[j]): cnts[j] / max(cnts.sum(), 1) for j in range(vsize)}
            _write_json(
                _grouped_fig(skeys, {"source": sfreq, "target": [tmap.get(k, 0.0) for k in skeys]}, f"drift: {c}"),
                ends_with(master_path) + "drift_" + c,
            )

    # ---- label distribution chart (exec-summary pie source) ----------------
    # the label is excluded from the per-attribute loops above, but its own
    # frequency chart must exist for the report's label pie
    if label_col and label_col in idf.columns:
        _write_json(plot_frequency(idf, label_col), ends_with(master_path) + "freqDist_" + label_col)

    # ---- dtype manifest -----------------------------------------------------
    pd.DataFrame(idf.dtypes(), columns=["attribute", "data_type"]).to_csv(
        ends_with(master_path) + "data_type.csv", index=False
    )

    # publish the staged chart/manifest files to the configured destination
    # (no-op for local; aws/azcopy per file for emr/ak8s)
    for fname in sorted(os.listdir(master_path)):
        fpath = os.path.join(master_path, fname)
        if os.path.isfile(fpath):
            store.push(fpath, dest_path)
