"""Corpus exploration (counterpart of
``anovos_tpu/feature_recommender/feature_explorer.py``; reference:
feature_recommender/feature_explorer.py).

List/filter industries and use cases (fuzzy + semantic match :61-139) and
rank corpus features by similarity (:181-317).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from anovos_tpu_torch.feature_recommender.featrec_init import (
    cosine_sim_matrix,
    get_column_name,
    get_model,
    load_corpus,
)


def _corpus(corpus_path=None):
    df = load_corpus(corpus_path)
    name, desc, industry, usecase = get_column_name(df)
    return df, name, desc, industry, usecase


def list_all_industry(corpus_path=None) -> pd.DataFrame:
    df, _, _, industry, _ = _corpus(corpus_path)
    out = pd.DataFrame({"Industry": sorted(df[industry].dropna().str.lower().unique())})
    return out


def list_all_usecase(corpus_path=None) -> pd.DataFrame:
    df, _, _, _, usecase = _corpus(corpus_path)
    return pd.DataFrame({"Usecase": sorted(df[usecase].dropna().str.lower().unique())})


def list_all_pair(corpus_path=None) -> pd.DataFrame:
    df, _, _, industry, usecase = _corpus(corpus_path)
    pairs = (
        df[[industry, usecase]]
        .dropna()
        .apply(lambda r: (r[industry].lower(), r[usecase].lower()), axis=1)
        .unique()
    )
    return pd.DataFrame(sorted(pairs), columns=["Industry", "Usecase"])


def _semantic_pick(query: str, options: list, semantic: bool = True) -> str:
    """Fuzzy + embedding match of a user string to the known values
    (reference process_usecase/process_industry :61-139).  With
    ``semantic=False`` the reference only cleans the string — an unknown
    value then simply matches nothing downstream."""
    q = str(query).lower().strip()
    if q in options or not semantic:
        return q
    model = get_model()
    model.fit_corpus(options + [q])
    sims = cosine_sim_matrix(model.encode([q]), model.encode(options))[0]
    return options[int(np.argmax(sims))]


def process_industry(industry: str, semantic: bool = True, corpus_path=None) -> str:
    return _semantic_pick(industry, list(list_all_industry(corpus_path)["Industry"]), semantic)


def process_usecase(usecase: str, semantic: bool = True, corpus_path=None) -> str:
    return _semantic_pick(usecase, list(list_all_usecase(corpus_path)["Usecase"]), semantic)


def list_usecase_by_industry(industry: str, semantic: bool = True, corpus_path=None) -> pd.DataFrame:
    df, _, _, ind, uc = _corpus(corpus_path)
    industry = process_industry(industry, semantic, corpus_path)
    sub = df[df[ind].str.lower() == industry]
    return pd.DataFrame({"Usecase": sorted(sub[uc].dropna().str.lower().unique())})


def list_industry_by_usecase(usecase: str, semantic: bool = True, corpus_path=None) -> pd.DataFrame:
    df, _, _, ind, uc = _corpus(corpus_path)
    usecase = process_usecase(usecase, semantic, corpus_path)
    sub = df[df[uc].str.lower() == usecase]
    return pd.DataFrame({"Industry": sorted(sub[ind].dropna().str.lower().unique())})


def _feature_frame(sub: pd.DataFrame, name, desc, ind, uc) -> pd.DataFrame:
    return pd.DataFrame(
        {
            "Feature Name": sub[name],
            "Feature Description": sub[desc],
            "Industry": sub[ind],
            "Usecase": sub[uc],
        }
    ).reset_index(drop=True)


def list_feature_by_industry(industry: str, num_of_feat: int = 100, semantic: bool = True, corpus_path=None) -> pd.DataFrame:
    """Top-N features for an industry (reference :181-224)."""
    df, name, desc, ind, uc = _corpus(corpus_path)
    industry = process_industry(industry, semantic=semantic, corpus_path=corpus_path)
    sub = df[df[ind].str.lower() == industry]
    return _feature_frame(sub.head(num_of_feat), name, desc, ind, uc)


def list_feature_by_usecase(usecase: str, num_of_feat: int = 100, semantic: bool = True, corpus_path=None) -> pd.DataFrame:
    df, name, desc, ind, uc = _corpus(corpus_path)
    usecase = process_usecase(usecase, semantic=semantic, corpus_path=corpus_path)
    sub = df[df[uc].str.lower() == usecase]
    return _feature_frame(sub.head(num_of_feat), name, desc, ind, uc)


def list_feature_by_pair(industry: str, usecase: str, num_of_feat: int = 100, semantic: bool = True, corpus_path=None) -> pd.DataFrame:
    df, name, desc, ind, uc = _corpus(corpus_path)
    industry = process_industry(industry, semantic=semantic, corpus_path=corpus_path)
    usecase = process_usecase(usecase, semantic=semantic, corpus_path=corpus_path)
    sub = df[(df[ind].str.lower() == industry) & (df[uc].str.lower() == usecase)]
    return _feature_frame(sub.head(num_of_feat), name, desc, ind, uc)
