"""Model-based imputation (counterpart of
``anovos_tpu/data_transformer/imputers.py``).

- ``imputation_sklearn`` (the name kept): method_type "KNN" → nan-euclidean
  5-NN against a ≤ ``sample_size`` fit sample (``ops/knn.py``);
  "regression" → round-robin ridge, IterativeImputer style.
- ``imputation_matrixFactorization`` → masked ALS (``ops/als.py``), 20
  rounds, reg 0.01, on the standardized block.
- ``auto_imputation`` → hold out ``null_pct`` of the observed cells, impute
  them with each method, keep the one of least Σ RMSE / |mean|.

As in the JAX package, every numeric column informs the fit and only the
selected columns are imputed; imputed columns are f32 ("double") and valid
in every row.  The model of ``imputation_sklearn`` is the JAX package's
npz (``imputation_sklearn_<method>.npz``: feat_cols and the fit sample Xs,
Ms, or the ridge means and coefs), so each package applies the other's.
"""

from __future__ import annotations

import logging
import os
import warnings
from typing import Dict, List

import numpy as np
import torch

from anovos_tpu_torch.cache import capture
from anovos_tpu_torch.ops.als import als_impute
from anovos_tpu_torch.ops.knn import knn_impute_tile
from anovos_tpu_torch.ops.mxu import true_f32
from anovos_tpu_torch.ops.reductions import masked_moments
from anovos_tpu_torch.shared.artifact_store import for_run_type
from anovos_tpu_torch.shared.table import Column, Table
from anovos_tpu_torch.shared.utils import parse_cols

logger = logging.getLogger(__name__)

_KNN_TILE = 4096


def _missing_num_cols(idf: Table, list_of_cols, drop_cols, stats_missing: dict) -> List[str]:
    """The numeric columns to impute: "missing" (those with a null, from
    ``stats_missing`` when given), "all", or a list that must be numeric."""
    num_all, _, _ = idf.attribute_type_segregation()
    if list_of_cols == "missing":
        if stats_missing:
            from anovos_tpu_torch.data_ingest.data_ingest import read_dataset

            miss = read_dataset(**stats_missing).to_pandas()
            cand = list(miss.loc[miss["missing_count"].astype(float) > 0, "attribute"])
        else:
            cand = [c for c in num_all if int(idf.columns[c].mask.sum()) < idf.nrows]
        cols = [c for c in cand if c in num_all]
    elif list_of_cols == "all":
        cols = list(num_all)
    else:
        cols = parse_cols(list_of_cols, idf.col_names, [])
        bad = [c for c in cols if c not in num_all]
        if bad:
            raise TypeError(f"Invalid input for Column(s): non-numerical {bad}")
    dropset = set(drop_cols.split("|") if isinstance(drop_cols, str) else drop_cols)
    return [c for c in cols if c not in dropset]


def _emit_imputed(idf: Table, cols: List[str], filled: torch.Tensor, output_mode: str) -> Table:
    """filled: (rows, len(cols)) values; observed cells keep their own."""
    odf = idf
    everywhere = torch.ones(idf.nrows, dtype=torch.bool, device=filled.device)
    for i, c in enumerate(cols):
        col = idf.columns[c]
        data = torch.where(col.mask, col.data.to(torch.float32), filled[:, i])
        odf = odf.with_column(c if output_mode == "replace" else c + "_imputed",
                              Column("num", data, everywhere, dtype_name="double"))
    return odf


def _knn_fill(X: torch.Tensor, M: torch.Tensor, Xs: torch.Tensor, Ms: torch.Tensor,
              tgt_idx: List[int]) -> torch.Tensor:
    """(rows, len(tgt_idx)) KNN values of the target features, computed
    for the rows that miss one of them (other rows keep 0: their cells are
    observed), tile by tile."""
    filled = torch.zeros((X.shape[0], len(tgt_idx)), dtype=torch.float32, device=X.device)
    need = torch.nonzero(~M[:, tgt_idx].all(dim=1)).flatten()
    for start in range(0, len(need), _KNN_TILE):
        rows = need[start:start + _KNN_TILE]
        filled[rows] = knn_impute_tile(X[rows], M[rows], Xs, Ms, features=tgt_idx)
    return filled


def _solve_pos(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A⁻¹ b by Cholesky; NaN where A is not positive definite (as
    ``jax.scipy.linalg.solve(..., assume_a="pos")`` gives)."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.where(info[..., None] == 0, x, float("nan"))


def _fit_iterative_ridge(X: torch.Tensor, M: torch.Tensor, reg: float = 1e-3, iters: int = 10):
    """Round-robin ridge (IterativeImputer semantics): ``iters`` sweeps in
    which each column j is regressed on all others (as currently filled,
    column j zeroed, plus an intercept) over the rows that observe it, and
    its missing cells are refreshed from the fit.  The normal equations
    are formed from the observed rows centred on their means, in true
    f32: the JAX package forms the same system as the raw Gram matrix less
    n·āāᵀ, which cancels away f32 bits at large means (ROADMAP.md Queue
    C).  An all-null column's mean is taken as 0, so it predicts
    nothing (the JAX package's NaN mean turns every prediction NaN;
    ROADMAP.md Queue C).  Returns (means (k,), coefs (k, k + 1), intercept
    last)."""
    k = X.shape[1]
    means = torch.nan_to_num(masked_moments(X, M)["mean"], nan=0.0)
    Xf = torch.where(M, X, means[None, :]).contiguous()
    Mf = M.to(torch.float32)
    coefs = torch.zeros((k, k + 1), dtype=torch.float32, device=X.device)
    eye = torch.eye(k, dtype=torch.float32, device=X.device)
    for _ in range(iters):
        for j in range(k):
            A = Xf * (1.0 - eye[j])[None, :]
            w = Mf[:, j]
            n = torch.clamp_min(w.sum(), 1.0)
            y = torch.where(M[:, j], X[:, j], 0.0)
            ybar = y.sum() / n
            abar = (A * w[:, None]).sum(dim=0) / n
            # the scatter of the observed rows about their means: the same
            # system as the raw Gram less n·āāᵀ, without its cancellation
            Ac = (A - abar[None, :]) * w[:, None]
            with true_f32():
                G = Ac.t() @ Ac + 2 * reg * eye
                b = Ac.t() @ (y - ybar)
            beta = _solve_pos(G, b)
            icept = ybar - abar @ beta
            with true_f32():
                pred = A @ beta + icept
            Xf[:, j] = torch.where(M[:, j], X[:, j], pred)
            coefs[j, :k] = beta
            coefs[j, k] = icept
    return means, coefs


def _apply_iterative_ridge(X: torch.Tensor, M: torch.Tensor, means: torch.Tensor,
                           coefs: torch.Tensor) -> torch.Tensor:
    """One round-robin pass of the fitted ridges from the mean fill."""
    k = X.shape[1]
    Xf = torch.where(M, X, means[None, :]).contiguous()
    eye = torch.eye(k, dtype=torch.float32, device=X.device)
    for j in range(k):
        with true_f32():
            pred = (Xf * (1.0 - eye[j])[None, :]) @ coefs[j, :k] + coefs[j, k]
        Xf[:, j] = torch.where(M[:, j], X[:, j], pred)
    return Xf


def imputation_sklearn(
    idf: Table,
    list_of_cols="missing",
    drop_cols=[],
    missing_threshold: float = 1.0,
    method_type: str = "regression",
    use_sampling: bool = True,
    sample_method: str = "random",
    strata_cols="all",
    stratified_type: str = "population",
    sample_size: int = 10000,
    sample_seed: int = 42,
    pre_existing_model: bool = False,
    model_path: str = "NA",
    output_mode: str = "replace",
    stats_missing: dict = {},
    run_type: str = "local",
    auth_key: str = "NA",
    print_impact: bool = False,
    **_ignored,
) -> Table:
    """KNN or iterative-ridge imputation.  The KNN fit set is
    ``sample_size`` rows drawn by ``numpy.random.default_rng(sample_seed)``
    (the JAX package's rows) when the table is larger and
    ``use_sampling``; the ridge fits on every row.  The model goes through
    the ``run_type`` artifact store."""
    if method_type not in ("KNN", "regression"):
        raise TypeError("Invalid input for method_type")
    cols = _missing_num_cols(idf, list_of_cols, drop_cols, stats_missing)
    if not cols:
        return idf
    num_all, _, _ = idf.attribute_type_segregation()
    feat_cols = list(dict.fromkeys(num_all))
    store = for_run_type(run_type, auth_key)
    local_model_dir = store.staging_dir(model_path) if model_path != "NA" else None
    model_name = f"imputation_sklearn_{method_type}.npz"
    model_file = os.path.join(local_model_dir, model_name) if local_model_dir else None
    if pre_existing_model:
        model_file = store.pull(str(model_path).rstrip("/") + "/" + model_name, model_file)
        blob = np.load(model_file, allow_pickle=True)
        feat_cols = [str(c) for c in blob["feat_cols"]]
        cols = [c for c in cols if c in feat_cols]
    X, M = idf.numeric_block(feat_cols)
    dev = X.device
    tgt_idx = [feat_cols.index(c) for c in cols]
    if pre_existing_model:
        if method_type == "KNN":
            Xs, Ms = torch.from_numpy(blob["Xs"]).to(dev), torch.from_numpy(blob["Ms"]).to(dev)
        else:
            means, coefs = torch.from_numpy(blob["means"]).to(dev), torch.from_numpy(blob["coefs"]).to(dev)
    elif method_type == "KNN":
        if use_sampling and idf.nrows > sample_size:
            pick = np.random.default_rng(sample_seed).choice(idf.nrows, size=sample_size, replace=False)
        else:
            pick = np.arange(idf.nrows)
        pick_d = torch.from_numpy(pick.astype(np.int64)).to(dev)
        Xs, Ms = X.index_select(0, pick_d).contiguous(), M.index_select(0, pick_d).contiguous()
        if model_file:
            os.makedirs(local_model_dir, exist_ok=True)
            np.savez(model_file, feat_cols=np.array(feat_cols), Xs=Xs.cpu().numpy(), Ms=Ms.cpu().numpy())
            capture.record_artifact(model_file)  # zipfile opens through io.open, past the hook
            store.push(model_file, model_path)
    else:
        means, coefs = _fit_iterative_ridge(X, M)
        if model_file:
            os.makedirs(local_model_dir, exist_ok=True)
            np.savez(model_file, feat_cols=np.array(feat_cols), means=means.cpu().numpy(),
                     coefs=coefs.cpu().numpy())
            capture.record_artifact(model_file)
            store.push(model_file, model_path)

    if method_type == "KNN":
        filled = _knn_fill(X, M, Xs, Ms, tgt_idx)
    else:
        filled = _apply_iterative_ridge(X, M, means, coefs)[:, tgt_idx]
    odf = _emit_imputed(idf, cols, filled, output_mode)
    if print_impact:
        logger.info(f"{method_type}-imputed: {cols}")
    return odf


def imputation_matrixFactorization(
    idf: Table,
    list_of_cols="missing",
    drop_cols=[],
    id_col: str = "",
    output_mode: str = "replace",
    stats_missing: dict = {},
    print_impact: bool = False,
    **_ignored,
) -> Table:
    """ALS completion of the numeric block (``id_col`` left out), each
    column standardized first (so the ridge term is scale-free) and the
    completion scaled back; rank min(10, max(2, k − 1))."""
    cols = _missing_num_cols(idf, list_of_cols, drop_cols, stats_missing)
    cols = [c for c in cols if c != id_col]
    if not cols:
        return idf
    num_all, _, _ = idf.attribute_type_segregation()
    feat_cols = [c for c in num_all if c != id_col]
    tgt_idx = [feat_cols.index(c) for c in cols]
    X, M = idf.numeric_block(feat_cols)
    mom = masked_moments(X, M)
    mean = mom["mean"]
    std = torch.where(mom["stddev"] > 0, mom["stddev"], 1.0)
    Z = torch.where(M, (X - mean[None, :]) / std[None, :], 0.0)
    rank = min(10, max(2, len(feat_cols) - 1))
    completed = als_impute(Z, M, rank=rank, iters=20, reg=0.01)
    filled = (completed * std[None, :] + mean[None, :])[:, tgt_idx]
    odf = _emit_imputed(idf, cols, filled, output_mode)
    if print_impact:
        logger.info(f"MF-imputed: {cols}")
    return odf


def _candidates(cols: List[str]) -> dict:
    from anovos_tpu_torch.data_transformer.transformers import imputation_MMM

    return {
        "MMM_mean": lambda t, om="replace": imputation_MMM(t, list_of_cols=cols, method_type="mean",
                                                            output_mode=om),
        "MMM_median": lambda t, om="replace": imputation_MMM(t, list_of_cols=cols, method_type="median",
                                                              output_mode=om),
        "KNN": lambda t, om="replace": imputation_sklearn(t, list_of_cols=cols, method_type="KNN",
                                                          output_mode=om),
        "regression": lambda t, om="replace": imputation_sklearn(t, list_of_cols=cols,
                                                                 method_type="regression", output_mode=om),
        "MF": lambda t, om="replace": imputation_matrixFactorization(t, list_of_cols=cols, output_mode=om),
    }


def auto_imputation_scores(idf: Table, cols: List[str], null_pct: float = 0.1) -> Dict[str, float]:
    """Each candidate's Σ over ``cols`` of RMSE / max(|mean|, 1e-9) on the
    held-out cells (f32 on the host, as in the JAX package); {} when
    nothing is held out.  The held-out cells are the observed ones where
    a uniform drawn by ``numpy.random.default_rng(0)`` over the (rows, k)
    block falls below ``null_pct``."""
    X, M = idf.numeric_block(cols)
    Mh, Xh = M.cpu().numpy(), X.cpu().numpy()
    holdout = Mh & (np.random.default_rng(0).random(Mh.shape) < null_pct)
    if holdout.sum() == 0:
        return {}
    M_train = torch.from_numpy(Mh & ~holdout).to(X.device)
    probe = idf
    for i, c in enumerate(cols):
        col = idf.columns[c]
        probe = probe.with_column(c, Column("num", col.data, M_train[:, i], dtype_name=col.dtype_name))
    col_mean = masked_moments(X, M)["mean"].cpu().numpy()
    scores: Dict[str, float] = {}
    for name, fn in _candidates(cols).items():
        try:
            Xi = fn(probe).numeric_block(cols)[0].cpu().numpy()
            err = 0.0
            for i in range(len(cols)):
                h = holdout[:, i]
                if h.sum() == 0:
                    continue
                rmse = float(np.sqrt(np.mean((Xi[h, i] - Xh[h, i]) ** 2)))
                err += rmse / max(abs(col_mean[i]), 1e-9)
            scores[name] = float(err)
        except Exception as e:  # pragma: no cover - defensive, as in the JAX package
            warnings.warn(f"auto_imputation: {name} failed: {e}")
    return scores


def auto_imputation(
    idf: Table,
    list_of_cols="missing",
    drop_cols=[],
    id_col: str = "",
    null_pct: float = 0.1,
    stats_missing: dict = {},
    output_mode: str = "replace",
    run_type: str = "local",
    print_impact: bool = True,
    **_ignored,
) -> Table:
    """Hold out ``null_pct`` of the observed cells, score MMM mean/median, KNN, regression and MF on them
    (``auto_imputation_scores``) and apply the best to the table; median
    MMM when nothing is held out."""
    from anovos_tpu_torch.data_transformer.transformers import imputation_MMM

    cols = _missing_num_cols(idf, list_of_cols, drop_cols, stats_missing)
    cols = [c for c in cols if c != id_col]
    if not cols:
        return idf
    scores = auto_imputation_scores(idf, cols, null_pct)
    if not scores:
        return imputation_MMM(idf, list_of_cols=cols, method_type="median", output_mode=output_mode)
    best = min(scores, key=scores.get)
    if print_impact:
        logger.info(f"auto_imputation scores (lower better): "
                    f"{({k: round(v, 4) for k, v in scores.items()})} → {best}")
    return _candidates(cols)[best](idf, output_mode)
