"""Latent-feature transformers (counterpart of
``anovos_tpu/data_transformer/latent_features.py``):
``autoencoder_latentFeatures`` trains the autoencoder of
``models/autoencoder.py`` on the card over the standardized, imputed
block and applies its encoder; ``PCA_latentFeatures`` takes the
eigenvectors of the covariance, keeping the fewest components that reach
the explained-variance cutoff.  Both write ``latent_<i>`` f32 columns,
valid in every row."""

from __future__ import annotations

import logging
import warnings
from typing import List

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.data_transformer.model_io import load_model_df, save_model_df
from anovos_tpu_torch.models.autoencoder import AutoEncoder
from anovos_tpu_torch.ops.mxu import bf16_sweep, mm
from anovos_tpu_torch.ops.quantiles import masked_median
from anovos_tpu_torch.ops.reductions import masked_moments
from anovos_tpu_torch.shared.table import Column, Table
from anovos_tpu_torch.shared.utils import parse_cols

logger = logging.getLogger(__name__)


def _prep_block(idf: Table, cols: List[str], standardization: bool, imputation: bool):
    """(X, mean, std): the (rows, k) block of ``cols`` with nulls filled by
    the column median (``imputation``) or mean, then, with
    ``standardization``, (x − mean) / std (std 1 where it is 0 or NaN).
    The mean and sample std come from the moments kernel over the valid
    values.  An all-null column has no median or mean: it is filled with
    0, so it adds nothing (the JAX package fills it with NaN, which turns
    every latent NaN; ROADMAP.md Queue C)."""
    X, M = idf.numeric_block(cols)
    mom = masked_moments(X, M)
    mean = torch.nan_to_num(mom["mean"], nan=0.0)
    fill = torch.nan_to_num(masked_median(X, M), nan=0.0) if imputation else mean
    std = torch.where(mom["stddev"] > 0, mom["stddev"], 1.0)
    Xd = torch.where(M, X, fill[None, :])
    if standardization:
        Xd = (Xd - mean[None, :]) / std[None, :]
    return Xd, mean, std


def _num_cols(idf: Table, list_of_cols, drop_cols) -> List[str]:
    num_all, _, _ = idf.attribute_type_segregation()
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all, idf.col_names, drop_cols)
    return [c for c in cols if c in num_all]


def _emit_latents(idf: Table, Z: torch.Tensor, cols: List[str], output_mode: str) -> Table:
    odf = idf
    everywhere = torch.ones(idf.nrows, dtype=torch.bool, device=Z.device)
    for i in range(Z.shape[1]):
        odf = odf.with_column(f"latent_{i}", Column("num", Z[:, i].to(torch.float32), everywhere,
                                                    dtype_name="float"))
    return odf.drop(cols) if output_mode == "replace" else odf


def autoencoder_latentFeatures(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    reduction_params: float = 0.5,
    sample_size: int = 500000,
    epochs: int = 100,
    batch_size: int = 256,
    pre_existing_model: bool = False,
    model_path: str = "NA",
    standardization: bool = True,
    standardization_configs: dict = {},
    imputation: bool = True,
    imputation_configs: dict = {},
    output_mode: str = "replace",
    print_impact: bool = False,
    **_ignored,
) -> Table:
    """``latent_<i>`` columns from the autoencoder's bottleneck.

    ``reduction_params`` < 1: k = round(r · n columns), else k = r.  The fit
    set is the first min(rows, ``sample_size``) rows: its first 80% train,
    the rest validate.  Model: ``<model_path>/autoencoders_latentFeatures/
    model.npz``."""
    cols = _num_cols(idf, list_of_cols, drop_cols)
    if len(cols) < 2:
        warnings.warn("No Autoencoder Computation - need ≥2 numerical columns")
        return idf
    n = len(cols)
    k = int(round(reduction_params * n)) if reduction_params < 1 else int(reduction_params)
    k = max(1, min(k, n))
    X, _, _ = _prep_block(idf, cols, standardization, imputation)

    if pre_existing_model:
        ae, params = AutoEncoder.load(model_path, X.device)
    else:
        n_fit = min(idf.nrows, sample_size)
        Xfit = X[:n_fit]
        split = int(n_fit * 0.8)
        ae = AutoEncoder(n, k)
        params = ae.fit(Xfit[:split], epochs=int(epochs), batch_size=int(min(batch_size, max(split, 1))),
                        validation_X=Xfit[split:] if split < n_fit else None, verbose=print_impact)
        if model_path != "NA":
            ae.save(params, model_path)
    odf = _emit_latents(idf, ae.latent(params, X), cols, output_mode)
    if print_impact:
        logger.info(f"autoencoder latent features: {ae.n_bottleneck} from {n} columns")
    return odf


def PCA_latentFeatures(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    explained_variance_cutoff: float = 0.95,
    pre_existing_model: bool = False,
    model_path: str = "NA",
    standardization: bool = False,
    standardization_configs: dict = {},
    imputation: bool = False,
    imputation_configs: dict = {},
    output_mode: str = "replace",
    print_impact: bool = False,
    **_ignored,
) -> Table:
    """``latent_<i>`` = the centred block (nulls filled with the median,
    whatever ``imputation`` says, as in the JAX package) projected on the
    top k eigenvectors of its covariance, k the fewest whose eigenvalues'
    cumulative share reaches ``explained_variance_cutoff``.  Model: parquet
    [component, loadings]."""
    cols = _num_cols(idf, list_of_cols, drop_cols)
    if len(cols) < 2:
        warnings.warn("No PCA Computation - need ≥2 numerical columns")
        return idf
    X, _, _ = _prep_block(idf, cols, standardization, imputation=True)
    Xc = X - X.mean(dim=0)
    if pre_existing_model:
        dfm = load_model_df(model_path, "PCA_latentFeatures")
        comp = np.stack([np.asarray(r, dtype=np.float32) for r in dfm["loadings"]])
        V = torch.from_numpy(comp.T.copy()).to(X.device)
    else:
        # the covariance in true f32 (TF32 off; bf16 inputs only under
        # ANOVOS_TPU_BF16=1), eigh in f32, eigenvalues descending
        eigval, eigvec = torch.linalg.eigh(mm(Xc.t(), Xc, bf16_sweep()) / max(idf.nrows - 1, 1))
        eigval, eigvec = torch.flip(eigval, [0]), torch.flip(eigvec, [1])
        ev = eigval.cpu().numpy()
        ratio = np.cumsum(ev) / max(float(ev.sum()), 1e-30)
        k = int(np.searchsorted(ratio, explained_variance_cutoff) + 1)
        k = max(1, min(k, len(cols)))
        V = eigvec[:, :k]
        if model_path != "NA":
            Vh = V.cpu().numpy().astype(float)
            save_model_df(pd.DataFrame({"component": [f"latent_{i}" for i in range(k)],
                                        "loadings": [Vh[:, i].tolist() for i in range(k)]}),
                          model_path, "PCA_latentFeatures")
    Z = mm(Xc, V, bf16_sweep())
    odf = _emit_latents(idf, Z, cols, output_mode)
    if print_impact:
        logger.info(f"PCA latent features: {Z.shape[1]} components (cutoff {explained_variance_cutoff})")
    return odf
