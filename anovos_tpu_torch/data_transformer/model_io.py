"""Model-artifact persistence (the port's copy of
``anovos_tpu/data_transformer/model_io.py`` ``save_model_df`` /
``load_model_df``): the same ``<model_path>/<name>/part-00000.parquet``
(or ``.csv``) layout, so either package reads the other's models."""

from __future__ import annotations

import glob
import os
import shutil

import pandas as pd


def save_model_df(df: pd.DataFrame, model_path: str, name: str, fmt: str = "parquet") -> None:
    path = os.path.join(model_path, name)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    if fmt == "parquet":
        df.to_parquet(os.path.join(path, "part-00000.parquet"), index=False)
    else:
        df.to_csv(os.path.join(path, "part-00000.csv"), index=False)


def load_model_df(model_path: str, name: str, fmt: str = "parquet") -> pd.DataFrame:
    path = os.path.join(model_path, name)
    ext = "parquet" if fmt == "parquet" else "csv"
    files = sorted(glob.glob(os.path.join(path, "*." + ext)))
    if not files and os.path.isfile(path):
        files = [path]
    if not files:
        raise FileNotFoundError(f"no {ext} model files under {path}")
    if fmt == "parquet":
        return pd.concat([pd.read_parquet(f) for f in files], ignore_index=True)
    # dtype=str: category values like "01" must round-trip verbatim
    return pd.concat([pd.read_csv(f, dtype=str) for f in files], ignore_index=True)
