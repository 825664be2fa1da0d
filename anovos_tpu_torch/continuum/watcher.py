"""The partition-arrival loop: poll → decode new parts → fold → re-
finalize → re-render → alert → snapshot (counterpart of
``anovos_tpu/continuum/watcher.py``).

One :func:`step` is the unit of work (the CLI's ``step`` command, the
``continuous_analysis`` workflow block, and each iteration of ``run``):

1. **scan**: the dataset directory's part files classified against the
   folded state by stat signature (new / changed / retracted / unchanged
   / still quarantined);
2. **decode**: only the new and changed parts, through the prefetch pool
   (``data_ingest/prefetch.DecodePool``) and the ingest guard: a corrupt
   day is quarantined, named in the degradation registry, and remembered
   by signature so it is not tried again every poll;
3. **fold**: each decoded partition's partials are computed on the card
   as its frame arrives (the frame is then dropped), and once every part
   of the batch is decoded they commit one by one in part-key order (the
   journal's ``fold_commit``: a crash mid-fold loses at most the
   uncommitted partitions, never a committed one);
4. **finalize**: the artifacts re-derive from the keyed partial maps
   (O(partitions · k), never O(history rows)), and only the report
   sections whose inputs changed re-render
   (``data_report/continuum_report.py``);
5. **alert**: per-arrival drift and quality crossings emit structured
   JSON with the flight recorder's tail (``continuum/alerts.py``);
6. **snapshot**: the new fold frontier commits content-addressed into
   the :class:`~anovos_tpu_torch.cache.store.CacheStore` (``snapshot_commit``).

Drift rides the persisted model (``DriftSpec.model_dir``, the streaming
drift model's layout).  With no model on disk yet, the watcher fits one
from the configured ``baseline`` partitions as soon as they are folded:
cutoffs from the baseline's merged moments (``cutoffs_from_bounds`` on
the runtime's device, as the streaming fit computes them), categorical
source frequencies from the baseline's counters (no decode), numeric
source frequencies from ONE re-decode of the baseline partitions, binned
by the histogram kernel (journaled ``model_fitted``).  Partitions folded
before the model existed fold again once it lands, so arrival order
never changes the final state.

The step summary has the JAX package's keys plus ``walls_s``: the
step's wall split into decode, fold, fit, refold, finalize, render,
alerts and snapshot seconds.  :func:`step` is ``@timed`` under the JAX
label ``continuum.step``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.cache.fingerprint import canonical, digest
from anovos_tpu_torch.continuum import alerts as alerts_mod
from anovos_tpu_torch.continuum.state import ContinuumState, part_signature
from anovos_tpu_torch.continuum.sufficient import (
    ACCUMULATORS,
    CategoricalAccumulator,
    DriftSpec,
    FoldContext,
    MomentsAccumulator,
    PartFrame,
    _cols_of,
    active_families,
    binned_counts,
)
from anovos_tpu_torch.obs import flight, telemetry
from anovos_tpu_torch.obs.metrics import get_metrics
from anovos_tpu_torch.obs.timed import timed

logger = logging.getLogger(__name__)

__all__ = ["ContinuumConfig", "step", "run", "status", "poll_seconds"]

HEARTBEAT = "continuum_watcher"


def poll_seconds(default: float = 30.0) -> float:
    """``ANOVOS_CONTINUUM_POLL_S`` overrides the config's poll interval (a
    value that is not a number is ignored)."""
    raw = os.environ.get("ANOVOS_CONTINUUM_POLL_S", "")
    if raw:
        try:
            return max(0.0, float(raw))
        except ValueError:
            pass
    return default


@dataclasses.dataclass
class ContinuumConfig:
    """The ``continuous_analysis`` config section, resolved."""

    dataset_path: str
    file_type: str = "parquet"
    state_dir: str = "continuum_state"
    output_path: str = "continuum_artifacts"
    file_configs: Optional[dict] = None
    list_of_cols: object = "all"
    drop_cols: Tuple[str, ...] = ()
    hll_rsd: float = 0.05
    outlier_model_path: str = ""
    drift: Optional[dict] = None          # model_path/bin_size/method_type/threshold/baseline
    stability: Optional[dict] = None      # metric_weightages/threshold/binary_cols
    alert_thresholds: Optional[dict] = None
    poll_s: float = 30.0
    cache_dir: str = ""                   # snapshot store root ("" = <state_dir>/cache)

    @classmethod
    def from_dict(cls, d: dict, base_dir: str = ".") -> "ContinuumConfig":
        d = dict(d or {})
        path = d.get("dataset_path") or d.get("file_path")
        if not path:
            raise TypeError("continuous_analysis requires dataset_path")

        def _resolve(p, default):
            p = p or default
            return p if os.path.isabs(p) else os.path.join(base_dir, p)

        return cls(
            dataset_path=path if os.path.isabs(path) else os.path.join(base_dir, path),
            file_type=d.get("file_type", "parquet") or "parquet",
            state_dir=_resolve(d.get("state_dir"), "continuum_state"),
            output_path=_resolve(d.get("output_path"), "continuum_artifacts"),
            file_configs=d.get("file_configs"),
            list_of_cols=d.get("list_of_cols", "all") or "all",
            drop_cols=tuple(d.get("drop_cols") or ()),
            hll_rsd=float(d.get("hll_rsd", 0.05) or 0.05),
            outlier_model_path=d.get("outlier_model_path", "") or "",
            drift=d.get("drift"),
            stability=d.get("stability"),
            alert_thresholds=d.get("alerts"),
            poll_s=float(d.get("poll_s", 30.0) or 30.0),
            cache_dir=d.get("cache_dir", "") or "",
        )

    def config_sig(self) -> str:
        """Feed identity: everything that changes partials or artifacts
        (the JAX package's string for the same config).  Paths stay out,
        so a feed moved to another directory keeps its state; the drift
        model's content is covered by the family basis, not the key."""
        return digest(canonical({
            "file_type": self.file_type,
            "list_of_cols": self.list_of_cols,
            "drop_cols": list(self.drop_cols),
            "hll_rsd": self.hll_rsd,
            "outlier": bool(self.outlier_model_path),
            "drift": {k: (self.drift or {}).get(k)
                      for k in ("bin_size", "method_type", "threshold", "baseline")}
            if self.drift else None,
            "stability": self.stability,
        }))

    def drift_spec(self) -> Optional[DriftSpec]:
        if not self.drift:
            return None
        d = dict(self.drift)
        model_dir = d.get("model_path") or os.path.join(self.state_dir, "drift_model")
        if not os.path.isabs(model_dir):
            model_dir = os.path.join(os.path.dirname(self.state_dir) or ".", model_dir)
        return DriftSpec(
            model_dir=model_dir,
            bin_size=int(d.get("bin_size", 10) or 10),
            method_type=d.get("method_type", "PSI") or "PSI",
            threshold=float(d.get("threshold", 0.1) or 0.1),
            baseline=d.get("baseline", "") or "",
        )

    def fold_context(self) -> FoldContext:
        from anovos_tpu_torch.ops.hll import precision_for_rsd

        bounds = None
        if self.outlier_model_path:
            from anovos_tpu_torch.data_analyzer.quality_checker import _load_outlier_model

            bounds = {c: tuple(b) for c, b in _load_outlier_model(self.outlier_model_path)[0].items()}
        spec = self.drift_spec()
        return FoldContext(
            list_of_cols=self.list_of_cols,
            drop_cols=tuple(self.drop_cols),
            hll_p=precision_for_rsd(self.hll_rsd),
            outlier_bounds=bounds,
            drift=spec,
            drift_cutoffs=_load_cutoffs(spec) if spec else None,
        )


def _load_cutoffs(spec: DriftSpec) -> Optional[Dict[str, np.ndarray]]:
    """The persisted binning model's interior cutoffs, or None when no
    model exists yet (the watcher may fit one from the baseline).  An
    unreadable model leaves drift inactive and is named in the
    degradation registry (``continuum/drift_model``)."""
    from anovos_tpu_torch.data_transformer.model_io import load_model_df

    path = os.path.join(spec.model_dir, "attribute_binning")
    if not os.path.isdir(path) and not os.path.isfile(path):
        return None
    try:
        dfm = load_model_df(spec.model_dir, "attribute_binning")
    except Exception as e:
        logger.exception("drift model at %s unreadable; drift inactive", spec.model_dir)
        from anovos_tpu_torch.resilience.policy import record_degraded

        record_degraded("continuum/drift_model", f"unreadable drift model: {type(e).__name__}: {e}")
        return None
    return {str(r["attribute"]): np.asarray(list(r["parameters"]), np.float64)
            for _, r in dfm.iterrows()}


def _open_state(cfg: ContinuumConfig, ctx: FoldContext):
    """(state, snapshot store).  A missing state dir restores from the
    newest committed snapshot of this feed config when the store has one."""
    from anovos_tpu_torch.cache.store import CacheStore

    store = CacheStore(cfg.cache_dir or os.path.join(cfg.state_dir, "cache"))
    sig = cfg.config_sig()
    if not os.path.exists(os.path.join(cfg.state_dir, "state_manifest.json")):
        restored = ContinuumState.restore_from_store(store, cfg.state_dir, sig, ctx)
        if restored is not None:
            logger.info("continuum state restored from the snapshot store (%d parts)",
                        len(restored.parts))
            return restored, store
    return ContinuumState(cfg.state_dir, sig, ctx), store


def _decode_parts(cfg: ContinuumConfig, state: ContinuumState, keys: List[str],
                  on_frame: Callable[[str, pd.DataFrame], object],
                  walls: Optional[Dict[str, float]] = None) -> Tuple[Dict[str, object], List[str]]:
    """Decode ``keys`` (part keys) through the prefetch pool and hand each
    frame to ``on_frame(key, frame)`` as it arrives; the frame is not
    kept.  Returns ({key: on_frame's result}, quarantined keys).  The
    quarantine and schema semantics are the guarded reader's.  ``walls``
    gains the seconds spent waiting on decodes (``decode``) and in
    ``on_frame`` (``fold``)."""
    from anovos_tpu_torch.data_ingest.guard import IngestError, policy_from_env
    from anovos_tpu_torch.data_ingest.prefetch import DecodePool, StreamController, StreamStats

    out: Dict[str, object] = {}
    bad: List[str] = []
    if not keys:
        return out, bad
    walls = walls if walls is not None else {}
    root = os.path.abspath(cfg.dataset_path)
    files = [os.path.join(root, k) for k in keys]
    ctl, stats = StreamController(), StreamStats()
    cfg_files = dict(cfg.file_configs or {})
    pool = (DecodePool(files, cfg.file_type, cfg_files, ctl, stats=stats, journal=state.journal)
            if ctl.workers > 0 else None)
    try:
        for fi, (key, f) in enumerate(zip(keys, files)):
            sig = part_signature(f)
            # keep a registered service beat fresh through a long catch-up
            telemetry.refresh_heartbeat(HEARTBEAT)
            t0 = time.perf_counter()
            try:
                if pool is not None:
                    frame = pool.fetch(fi, f)
                else:
                    # late bind: tests count decodes by patching read_host_frame
                    from anovos_tpu_torch.data_ingest import data_ingest as di

                    frame = di.read_host_frame([f], cfg.file_type, cfg_files)
            except IngestError as e:
                if policy_from_env().on_corrupt == "raise":
                    raise
                # the guard quarantined the part and named it in the
                # degradation registry; the state remembers its signature
                state.mark_quarantined(key, f, sig or "gone", f"{type(e).__name__}: {e}")
                bad.append(key)
                continue
            finally:
                walls["decode"] = walls.get("decode", 0.0) + time.perf_counter() - t0
            t0 = time.perf_counter()
            out[key] = on_frame(key, frame)
            del frame
            walls["fold"] = walls.get("fold", 0.0) + time.perf_counter() - t0
    finally:
        if pool is not None:
            pool.close()
    return out, bad


def _fold_keys(cfg: ContinuumConfig, state: ContinuumState, keys: List[str],
               walls: Dict[str, float]) -> Tuple[List[str], List[str]]:
    """Decode and fold ``keys``: each frame's partials are computed as it
    arrives, then they commit in part-key order once every part of the
    batch is decoded (the JAX package's journal order).  Returns (folded
    keys, quarantined keys)."""
    root = os.path.abspath(cfg.dataset_path)
    computed, bad = _decode_parts(
        cfg, state, keys, lambda key, frame: (state.part_partials(key, frame), len(frame)), walls)
    folded = []
    t0 = time.perf_counter()
    for key in sorted(computed):
        partials, rows = computed[key]
        path = os.path.join(root, key)
        state.commit_part(key, path, partials, rows, part_signature(path) or "gone")
        folded.append(key)
        # keepalive of the service loop's beat (one-shot steps register none)
        telemetry.refresh_heartbeat(HEARTBEAT)
    walls["fold"] = walls.get("fold", 0.0) + time.perf_counter() - t0
    return folded, bad


def _fit_drift_model(cfg: ContinuumConfig, state: ContinuumState, ctx: FoldContext) -> bool:
    """Fit and persist the drift source model from the folded baseline
    partitions (no model on disk yet).  Cutoffs come from the baseline's
    merged moments, with no decode; numeric source frequencies need the
    baseline binned over those cutoffs: ONE re-decode of the baseline
    partitions, journaled.  Returns True when a model landed."""
    from anovos_tpu_torch.data_transformer.model_io import save_model_df
    from anovos_tpu_torch.drift_stability.drift_detector import _drop_allnan_cutoffs, save_frequency_map
    from anovos_tpu_torch.ops.drift_kernels import cutoffs_from_bounds
    from anovos_tpu_torch.shared.runtime import get_runtime

    spec = ctx.drift
    if spec is None or not spec.baseline:
        return False
    base_keys = [k for k in state.folded_keys() if spec.is_baseline(k)]
    if not base_keys:
        return False
    mom = ACCUMULATORS["moments"].reduce(state.family_state("moments", base_keys))
    if mom is None:
        return False
    num_cols = _cols_of(mom)
    cut_rows: List[Tuple[str, np.ndarray]] = []
    if num_cols:
        # on the runtime's device, as the streaming and in-memory fits
        # compute them (the card divides by the bin count as a reciprocal
        # product)
        dev = get_runtime().device
        cuts = cutoffs_from_bounds(
            *(torch.from_numpy(np.asarray(mom[f], np.float32)).to(dev) for f in ("min", "max", "n")),
            spec.bin_size).cpu().numpy()
        cuts64, kept_cols = _drop_allnan_cutoffs(cuts[: len(num_cols)], num_cols)
        cut_rows = list(zip(kept_cols, cuts64))
    cut_map = {c: np.asarray(v, np.float64) for c, v in cut_rows}
    src_rows = sum(int(state.parts[k]["rows"]) for k in base_keys)

    # numeric source histograms: the one re-decode (baseline only, once)
    num_counts: Dict[str, np.ndarray] = {c: np.zeros(spec.bin_size, np.int64) for c in cut_map}

    def _bin(key: str, frame: pd.DataFrame) -> None:
        part = PartFrame(frame, ctx)
        if not any(c in cut_map for c in part.num_cols):
            return None
        hist = binned_counts(part, cut_map, spec.bin_size)
        for j, c in enumerate(part.num_cols):
            if c in cut_map:
                num_counts[c] += hist[j]
        return True

    redecoded = 0
    if cut_map:
        binned, _bad = _decode_parts(cfg, state, base_keys, _bin)
        redecoded = sum(1 for v in binned.values() if v)

    os.makedirs(spec.model_dir, exist_ok=True)
    if cut_map:
        save_model_df(
            pd.DataFrame({"attribute": [c for c, _ in cut_rows],
                          "parameters": [list(map(float, v)) for _, v in cut_rows]}),
            spec.model_dir, "attribute_binning")
    # categorical source frequencies: straight from the baseline counters
    cat_agg = ACCUMULATORS["categorical"].reduce(state.family_state("categorical", base_keys))
    cat_counts = CategoricalAccumulator.counters(cat_agg) if cat_agg else {}
    denom = max(src_rows, 1)
    for c in sorted(set(cut_map) | set(cat_counts)):
        if c in cut_map:
            keys = list(range(1, spec.bin_size + 1))
            p = (num_counts[c] / denom).tolist()
        else:
            keys = sorted(cat_counts[c])
            p = [cat_counts[c][k] / denom for k in keys]
        save_frequency_map(spec.model_dir, c, keys, p)
    state.journal.append("model_fitted", baseline_parts=len(base_keys),
                         source_rows=src_rows, redecoded_parts=redecoded,
                         num_cols=len(cut_map), cat_cols=len(cat_counts))
    ctx.drift_cutoffs = cut_map
    return True


def _finalize_artifacts(cfg: ContinuumConfig, state: ContinuumState,
                        ctx: FoldContext) -> Dict[str, pd.DataFrame]:
    """Every artifact frame re-derived from the current partial maps."""
    from anovos_tpu_torch.drift_stability.stability import stability_frame_from_history

    arts: Dict[str, pd.DataFrame] = {}
    stats = ACCUMULATORS["moments"].finalize(state.family_state("moments"), ctx)
    hll = ACCUMULATORS["hll"].finalize(state.family_state("hll"), ctx)
    if len(stats) and len(hll):
        stats = stats.merge(hll, on="attribute", how="left")
    arts["stats"] = stats
    arts["missing"] = ACCUMULATORS["missing"].finalize(state.family_state("missing"), ctx)
    arts["categorical"] = ACCUMULATORS["categorical"].finalize(state.family_state("categorical"), ctx)
    if ctx.outlier_bounds:
        arts["outlier"] = ACCUMULATORS["outlier"].finalize(state.family_state("outlier"), ctx)
    if ctx.drift is not None and ctx.drift_cutoffs is not None:
        arts["drift"] = ACCUMULATORS["drift_target"].finalize(state.family_state("drift_target"), ctx)
    hist = _stability_history(state)
    if len(hist):
        arts["stability_history"] = hist
        stab_cfg = dict(cfg.stability or {})
        arts["stability"] = stability_frame_from_history(
            hist,
            metric_weightages=stab_cfg.get("metric_weightages",
                                           {"mean": 0.5, "stddev": 0.3, "kurtosis": 0.2}),
            threshold=float(stab_cfg.get("threshold", 1)),
            binary_cols=stab_cfg.get("binary_cols", []),
        )
    return arts


def _stability_history(state: ContinuumState) -> pd.DataFrame:
    """Per-partition metric history: each folded partition is one run
    index, numbered in canonical (sorted part key) order."""
    rows = []
    mom_state = state.family_state("moments")
    for idx, key in enumerate(sorted(mom_state), start=1):
        pm = MomentsAccumulator.part_metrics(mom_state[key])
        pm.insert(0, "idx", idx)
        pm.insert(1, "partition", key)
        rows.append(pm)
    if not rows:
        return pd.DataFrame(columns=["idx", "partition", "attribute", "mean", "stddev", "kurtosis"])
    return pd.concat(rows, ignore_index=True)


_ARTIFACT_FILES = {
    "stats": "continuum_stats.csv",
    "missing": "continuum_missing.csv",
    "categorical": "continuum_categorical.csv",
    "outlier": "continuum_outlier.csv",
    "drift": "continuum_drift.csv",
    "stability": "continuum_stability.csv",
    "stability_history": "continuum_stability_history.csv",
}


def _write_artifacts(out_dir: str, arts: Dict[str, pd.DataFrame]) -> Dict[str, str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, df in arts.items():
        path = os.path.join(out_dir, _ARTIFACT_FILES[name])
        tmp = path + ".tmp"
        df.to_csv(tmp, index=False)
        os.replace(tmp, path)
        paths[name] = path
    return paths


@timed("continuum.step")
def step(cfg: ContinuumConfig) -> dict:
    """One arrival-loop iteration; returns the step summary (also
    journaled as ``step_end``)."""
    from anovos_tpu_torch.data_ingest.data_ingest import _resolve_files
    from anovos_tpu_torch.resilience import chaos

    t0 = time.monotonic()
    walls: Dict[str, float] = {}
    ctx = cfg.fold_context()
    # arm the flight recorder when nothing else did, so alerts carry the
    # events that led up to them; honour ANOVOS_TPU_CHAOS when no plan is
    # installed yet (inside a workflow run, main() installed it)
    obs_dir = os.path.join(cfg.output_path, "obs")
    if not flight.enabled():
        flight.configure(obs_dir)
    if chaos.plan() is None:
        chaos.install_from_env()
    state, store = _open_state(cfg, ctx)
    state.journal.append("step_begin", dataset=os.path.abspath(cfg.dataset_path))

    try:
        files = _resolve_files(cfg.dataset_path, cfg.file_type)
    except (OSError, ValueError):
        files = []
    scan = state.scan(files, cfg.dataset_path)
    for key in scan.new:
        state.journal.append("partition_seen", part=key, status="new")
    for key in scan.changed:
        state.journal.append("partition_seen", part=key, status="changed")
    for key in scan.retracted:
        state.retract(key)

    # decode + fold the arrivals (a changed part's new partial replaces the
    # old one).  With a drift baseline and no model on disk yet, baseline
    # partitions fold FIRST and the model fits before the rest fold, so a
    # catch-up bins every target partition on its one decode.
    to_fold = sorted(scan.new) + sorted(scan.changed)
    folded: List[str] = []
    quarantined: List[str] = []
    model_fitted = False
    backlog_gauge = get_metrics().gauge(
        "continuum_fold_backlog", "arrived partitions not yet folded into the continuum state")
    backlog_gauge.set(float(len(to_fold)))

    def _fold_batch(keys: List[str]) -> None:
        ok, bad = _fold_keys(cfg, state, keys, walls)
        folded.extend(ok)
        quarantined.extend(bad)

    t_fold0 = time.monotonic()
    if ctx.drift is not None and ctx.drift_cutoffs is None and ctx.drift.baseline:
        _fold_batch([k for k in to_fold if ctx.drift.is_baseline(k)])
        t1 = time.perf_counter()
        model_fitted = _fit_drift_model(cfg, state, ctx)
        walls["fit"] = time.perf_counter() - t1
        _fold_batch([k for k in to_fold if not ctx.drift.is_baseline(k)])
    else:
        _fold_batch(to_fold)

    # basis guard: drift histograms merge only under ONE cutoff matrix and
    # outlier counts under ONE bounds vector; a swapped persisted model
    # strips the family from every folded partition (family_invalidated)
    # and the catch-up below folds them again under the new basis
    invalidated = 0
    if ctx.drift is not None and ctx.drift_cutoffs is not None:
        invalidated += state.check_family_basis(
            "drift_target", digest(canonical(
                {c: [float(v) for v in ctx.drift_cutoffs[c]] for c in sorted(ctx.drift_cutoffs)}),
                str(ctx.drift.bin_size)))
    if ctx.outlier_bounds:
        invalidated += state.check_family_basis(
            "outlier", digest(canonical(
                {c: [None if v is None else float(v) for v in b]
                 for c, b in sorted(ctx.outlier_bounds.items())})))

    # fold again any partition missing a family it should carry: one that
    # predates the drift model, or whose family basis was just invalidated
    refolded: List[str] = []
    pending = sorted(k for k in state.folded_keys()
                     if not set(active_families(ctx, k)) <= set(state.parts[k].get("families", [])))
    if pending:
        t1 = time.perf_counter()
        refold_walls: Dict[str, float] = {}
        refolded, _bad = _fold_keys(cfg, state, pending, refold_walls)
        walls["refold"] = time.perf_counter() - t1

    fold_wall_s = round(time.monotonic() - t_fold0, 4)
    backlog_gauge.set(float(max(len(to_fold) - len(folded) - len(quarantined), 0)))

    # re-finalize + re-render only when something moved
    render = {"rendered": [], "reused": [], "path": None}
    changed_state = bool(folded or refolded or quarantined or scan.retracted
                         or model_fitted or invalidated)
    if changed_state or not os.path.exists(os.path.join(cfg.output_path, "continuum_report.html")):
        from anovos_tpu_torch.data_report.continuum_report import render_report

        t1 = time.perf_counter()
        arts = _finalize_artifacts(cfg, state, ctx)
        _write_artifacts(cfg.output_path, arts)
        walls["finalize"] = time.perf_counter() - t1
        if folded or refolded:
            # arrival→artifact lag: scan detection of this step's arrivals
            # through the re-finalized artifacts on disk
            get_metrics().gauge(
                "continuum_arrival_artifact_lag_seconds",
                "wall from arrival detection to re-finalized artifacts for the last folding step"
            ).set(round(time.monotonic() - t0, 4))
        t1 = time.perf_counter()
        render = render_report(
            cfg.output_path, arts,
            quarantined=state.quarantined_parts(),
            # path-free: an incremental feed and a from-scratch step in
            # other directories render the same bytes
            feed={"partitions": len(state.folded_keys()), "rows": state.total_rows()},
            cache_dir=os.path.join(cfg.state_dir, "sections"))
        walls["render"] = time.perf_counter() - t1

    # per-arrival alerts (the shift DAY fires, not the diluted cumulative)
    t1 = time.perf_counter()
    emitted = []
    for key in folded + refolded:
        emitted.extend(alerts_mod.evaluate_part(key, state.partials(key), ctx,
                                                thresholds=cfg.alert_thresholds))
    for key in quarantined:
        emitted.append(alerts_mod.quarantine_alert(key, state.parts.get(key, {}).get("reason", "")))
    emitted = alerts_mod.emit(emitted, obs_dir, state.journal)
    walls["alerts"] = time.perf_counter() - t1

    snapshot_fp = None
    if changed_state:
        t1 = time.perf_counter()
        snapshot_fp = state.snapshot(store)
        walls["snapshot"] = time.perf_counter() - t1

    summary = {
        "scan": scan.to_json(),
        "folded": folded,
        "refolded": refolded,
        "quarantined": quarantined,
        "model_fitted": model_fitted,
        "alerts": len(emitted),
        "fold_wall_s": fold_wall_s,
        "wall_s": round(time.monotonic() - t0, 4),
        "snapshot_fp": snapshot_fp,
        "partitions": len(state.folded_keys()),
        "rows": state.total_rows(),
        "sections_rendered": render["rendered"],
        "sections_reused": render["reused"],
        "walls_s": {k: round(v, 4) for k, v in walls.items()},
    }
    state.journal.append("step_end", folded=len(folded), refolded=len(refolded),
                         quarantined=len(quarantined), alerts=len(emitted),
                         fold_wall_s=fold_wall_s, wall_s=summary["wall_s"])
    get_metrics().counter(
        "continuum_partitions_folded_total",
        "partitions folded by the continuum arrival loop").inc(len(folded) + len(refolded))
    return summary


def run(cfg: ContinuumConfig, max_iterations: Optional[int] = None,
        stop_file: Optional[str] = None) -> List[dict]:
    """The long-running service loop: a :func:`step` every poll interval
    (``ANOVOS_CONTINUUM_POLL_S`` overrides the config) until
    ``max_iterations`` or the ``stop_file`` appears.  A set
    ``ANOVOS_TPU_TELEMETRY`` or ``ANOVOS_TPU_TRACE_ROTATE`` raises: the
    telemetry plane and trace rotation are not ported."""
    telemetry.check_unported_knobs(telemetry.SERVICE_KNOBS)
    interval = poll_seconds(cfg.poll_s)
    out = []
    i = 0
    clean_exit = False
    try:
        while True:
            # the heartbeat belongs to THIS loop, not step(): beat before
            # the step (the fold refreshes it per committed partition) and
            # after; a loop that dies keeps a beat that goes stale
            telemetry.beat(HEARTBEAT, interval_s=interval)
            out.append(step(cfg))
            telemetry.beat(HEARTBEAT, interval_s=interval)
            i += 1
            if max_iterations is not None and i >= max_iterations:
                clean_exit = True
                break
            if stop_file and os.path.exists(stop_file):
                logger.info("stop file %s present; continuum loop exiting", stop_file)
                clean_exit = True
                break
            time.sleep(interval)
    finally:
        if clean_exit:
            # a loop stopped on purpose leaves no beat to go stale
            telemetry.clear_heartbeat(HEARTBEAT)
    return out


def status(cfg: ContinuumConfig) -> dict:
    """Feed status from the on-disk state: partitions, rows, quarantine,
    the journal's length, and the last step and snapshot."""
    from anovos_tpu_torch.cache.journal import read_journal

    manifest_path = os.path.join(cfg.state_dir, "state_manifest.json")
    parts: Dict[str, dict] = {}
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path) as f:
                parts = (json.load(f) or {}).get("parts", {})
        except (OSError, ValueError):
            parts = {}
    records = read_journal(os.path.join(cfg.state_dir, "continuum_journal.jsonl"))
    last_step = next((r for r in reversed(records) if r.get("event") == "step_end"), None)
    last_snap = next((r for r in reversed(records) if r.get("event") == "snapshot_commit"), None)
    return {
        "state_dir": os.path.abspath(cfg.state_dir),
        "partitions": sum(1 for e in parts.values() if not e.get("quarantined")),
        "quarantined": sorted(k for k, e in parts.items() if e.get("quarantined")),
        "rows": sum(int(e.get("rows", 0)) for e in parts.values() if not e.get("quarantined")),
        "journal_events": len(records),
        "alerts_emitted": sum(1 for r in records if r.get("event") == "alert_emitted"),
        "last_step": last_step,
        "last_snapshot": (last_snap or {}).get("fp"),
    }
