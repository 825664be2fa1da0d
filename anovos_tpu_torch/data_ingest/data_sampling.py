"""Random and stratified sampling (counterpart of
``anovos_tpu/data_ingest/data_sampling.py``).

Per-row Bernoulli keep masks from a seeded generator on the table's device
(``ops/sampling.py``), then one row compaction (``Table.filter_rows``).
Stratum ids come from a device ``torch.unique`` over the rows of the
strata columns' values.
"""

from __future__ import annotations

import warnings
from typing import List, Union

import numpy as np
import torch

from anovos_tpu_torch.ops.sampling import sample_mask, stratified_mask
from anovos_tpu_torch.ops.segment import masked_nunique
from anovos_tpu_torch.shared.table import Table


def data_sample(
    idf: Table,
    strata_cols: Union[str, List[str]] = "all",
    drop_cols: Union[str, List[str]] = [],
    fraction: float = 0.1,
    method_type: str = "random",
    stratified_type: str = "population",
    seed_value: int = 12,
    unique_threshold: Union[float, int] = 0.5,
) -> Table:
    """Sample rows.  "random": each row kept with probability ``fraction``.
    "stratified": per-stratum fractions, "population" keeps ``fraction``
    everywhere, "balanced" scales each stratum's by smallest_count/count.
    Strata columns with more distinct values than ``unique_threshold``
    (a share of the rows if ≤ 1, else a count) are skipped with a warning;
    rows with a null strata value are dropped."""
    if not isinstance(fraction, (int, float)) or isinstance(fraction, bool):
        raise TypeError("Invalid input for fraction")
    if fraction <= 0 or fraction > 1:
        raise TypeError("Invalid input for fraction: fraction value is between 0 and 1")
    if not isinstance(seed_value, int):
        raise TypeError("Invalid input for seed_value")
    if method_type not in ("stratified", "random"):
        raise TypeError("Invalid input for data_sample method_type")

    if method_type == "random":
        return idf.filter_rows(sample_mask(seed_value, idf.nrows, fraction, idf.device))

    if not isinstance(unique_threshold, (int, float)) or unique_threshold <= 0:
        raise TypeError("Invalid input for unique_threshold")
    if unique_threshold > 1 and not isinstance(unique_threshold, int):
        raise TypeError(
            "Invalid input for unique_threshold: unique_threshold can only be integer if larger than 1")
    if stratified_type not in ("population", "balanced"):
        raise TypeError("Invalid input for stratified_type")
    if strata_cols == "all":
        strata_cols = idf.col_names
    if isinstance(strata_cols, str):
        strata_cols = [x.strip() for x in strata_cols.split("|")]
    if isinstance(drop_cols, str):
        drop_cols = [x.strip() for x in drop_cols.split("|")]
    strata_cols = [c for c in dict.fromkeys(strata_cols) if c not in set(drop_cols)]
    if not strata_cols:
        raise TypeError("Missing strata_cols value")
    for col in strata_cols:
        if col not in idf.columns:
            raise TypeError(f"Invalid input for strata_cols: {col} does not exist")
    X = torch.stack([idf.columns[c].data.to(torch.float32) for c in strata_cols], 1)
    M = torch.stack([idf.columns[c].mask for c in strata_cols], 1)
    nu = masked_nunique(X, M).cpu().numpy()
    limit = unique_threshold * idf.nrows if unique_threshold <= 1 else unique_threshold
    skip = [c for c, u in zip(strata_cols, nu) if u > limit]
    if skip:
        warnings.warn("Columns dropped from strata due to high cardinality: " + ",".join(skip))
        strata_cols = [c for c in strata_cols if c not in skip]
    if not strata_cols:
        warnings.warn("No Stratified Sampling Computation - No strata column(s) to sample")
        return idf

    # stratum id: the distinct rows of the strata columns' stored values
    keys = torch.stack([idf.columns[c].data.to(torch.float64) for c in strata_cols], 1)
    valid = torch.stack([idf.columns[c].mask for c in strata_cols], 1).all(dim=1)
    _, inv = torch.unique(keys, dim=0, return_inverse=True)
    codes = torch.where(valid, inv, -1)
    if not bool(valid.any()):
        warnings.warn("No Stratified Sampling Computation - all strata values null")
        return idf
    counts = torch.bincount(inv[valid]).cpu().numpy()
    if stratified_type == "population":
        fracs = np.full(len(counts), fraction, dtype=np.float32)
    else:
        smallest = counts[counts > 0].min()
        fracs = (fraction * smallest / np.maximum(counts, 1)).astype(np.float32)
    return idf.filter_rows(stratified_mask(seed_value, codes, torch.from_numpy(fracs)))
