"""Attribute → corpus-feature mapping (counterpart of
``anovos_tpu/feature_recommender/feature_mapper.py``; reference:
feature_recommender/feature_mapper.py).

``feature_mapper`` (ref :35): embed the user's attribute names/descriptions
and the corpus, rank matches by cosine similarity.  ``find_attr_by_relevance``
(ref :322): the reverse direction — given target feature descriptions, find
the user attributes most relevant to each.  ``sankey_visualization`` (ref
:465) emits the plotly sankey JSON dict.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Union

import numpy as np
import pandas as pd

from anovos_tpu_torch.feature_recommender.featrec_init import (
    cosine_sim_matrix,
    get_column_name,
    get_model,
    group_corpus_features,
    load_corpus,
    recommendation_data_prep,
)

logger = logging.getLogger(__name__)


def _prep_user_frame(attr_names, attr_descriptions) -> pd.DataFrame:
    if isinstance(attr_names, dict):
        return pd.DataFrame(
            {"Attribute Name": list(attr_names.keys()), "Attribute Description": list(attr_names.values())}
        )
    if attr_descriptions is None:
        attr_descriptions = [""] * len(attr_names)
    return pd.DataFrame({"Attribute Name": attr_names, "Attribute Description": attr_descriptions})


def feature_mapper(
    attr_names: Union[dict, List[str]],
    attr_descriptions: Optional[List[str]] = None,
    industry: Optional[str] = None,
    usecase: Optional[str] = None,
    top_n: int = 2,
    threshold: float = 0.3,
    corpus_path: Optional[str] = None,
) -> pd.DataFrame:
    """[Attribute Name, Feature Name, Feature Description, Industry, Usecase,
    Similarity Score] — top_n corpus features per user attribute."""
    corpus = load_corpus(corpus_path)
    name, desc, ind, uc = get_column_name(corpus)
    if industry:
        corpus = corpus[corpus[ind].str.lower() == industry.lower()]
    if usecase:
        corpus = corpus[corpus[uc].str.lower() == usecase.lower()]
    # dedup features repeated across industries so they can't fill several
    # top_n slots with identical matches (reference feature_recommendation_prep)
    corpus = group_corpus_features(corpus, name, desc, ind, uc)
    user = _prep_user_frame(attr_names, attr_descriptions)
    corpus_texts = recommendation_data_prep(corpus, name, desc)
    user_texts = recommendation_data_prep(
        user.rename(columns={"Attribute Name": name, "Attribute Description": desc}), name, desc
    )
    model = get_model()
    model.fit_corpus(corpus_texts + user_texts)
    S = cosine_sim_matrix(model.encode(user_texts), model.encode(corpus_texts))
    rows = []
    for i, attr in enumerate(user["Attribute Name"]):
        order = np.argsort(-S[i])[:top_n]
        for j in order:
            score = float(S[i, j])
            if score < threshold:
                continue
            rows.append(
                {
                    "Attribute Name": attr,
                    "Feature Name": corpus.iloc[j][name],
                    "Feature Description": corpus.iloc[j][desc],
                    "Industry": corpus.iloc[j][ind],
                    "Usecase": corpus.iloc[j][uc],
                    "Similarity Score": round(score, 4),
                }
            )
    return pd.DataFrame(
        rows,
        columns=["Attribute Name", "Feature Name", "Feature Description", "Industry", "Usecase", "Similarity Score"],
    )


def find_attr_by_relevance(
    attr_names: Union[dict, List[str]],
    building_corpus: List[str],
    attr_descriptions: Optional[List[str]] = None,
    threshold: float = 0.3,
    corpus_path: Optional[str] = None,
) -> pd.DataFrame:
    """Rank user attributes against target feature descriptions (ref :322)."""
    user = _prep_user_frame(attr_names, attr_descriptions)
    user_texts = [
        f"{n} {d}".lower().strip()
        for n, d in zip(user["Attribute Name"], user["Attribute Description"])
    ]
    model = get_model()
    model.fit_corpus(user_texts + [str(b).lower() for b in building_corpus])
    S = cosine_sim_matrix(
        model.encode([str(b).lower() for b in building_corpus]), model.encode(user_texts)
    )
    rows = []
    for i, target in enumerate(building_corpus):
        for j in np.argsort(-S[i]):
            score = float(S[i, j])
            if score < threshold:
                continue
            rows.append(
                {
                    "Input Feature Desc": target,
                    "Recommended Input Attribute": user["Attribute Name"].iloc[j],
                    "Input Attribute Similarity Score": round(score, 4),
                }
            )
    return pd.DataFrame(
        rows, columns=["Input Feature Desc", "Recommended Input Attribute", "Input Attribute Similarity Score"]
    )


def _split_multi(values) -> List[str]:
    """Comma-joined industry/usecase strings → individual node labels
    (reference :548-560 splits on ", ")."""
    out: List[str] = []
    for v in values:
        for part in str(v).split(", "):
            if part and part not in out:
                out.append(part)
    return out


def sankey_visualization(
    mapping_df: pd.DataFrame,
    industry_included: bool = False,
    usecase_included: bool = False,
) -> dict:
    """Plotly sankey JSON of attribute→feature links (ref :465-560).

    ``industry_included``/``usecase_included`` append extra node layers:
    feature → usecase → industry, with comma-joined corpus values split into
    individual nodes like the reference.  ``find_attr_by_relevance`` output
    has no industry/usecase columns, so the flags are ignored for it
    (reference :516-526).
    """
    if "Recommended Input Attribute" in mapping_df.columns:
        if industry_included or usecase_included:
            logger.info(
                "Input is find_attr_by_relevance output DataFrame. "
                "There is no suggested Industry and/or Usecase."
            )
        attrs = list(dict.fromkeys(mapping_df["Input Feature Desc"]))
        feats = list(dict.fromkeys(mapping_df["Recommended Input Attribute"]))
        labels = attrs + feats
        src = [attrs.index(a) for a in mapping_df["Input Feature Desc"]]
        tgt = [len(attrs) + feats.index(f) for f in mapping_df["Recommended Input Attribute"]]
        val = [float(v) for v in mapping_df["Input Attribute Similarity Score"]]
        title = "feature description → attribute relevance"
    else:
        attrs = list(dict.fromkeys(mapping_df["Attribute Name"]))
        feats = list(dict.fromkeys(mapping_df["Feature Name"]))
        labels = attrs + feats
        src = [attrs.index(a) for a in mapping_df["Attribute Name"]]
        tgt = [len(attrs) + feats.index(f) for f in mapping_df["Feature Name"]]
        val = [float(v) for v in mapping_df["Similarity Score"]]
        title = "attribute → feature mapping"
        layers = []
        if usecase_included and "Usecase" in mapping_df.columns:
            layers.append("Usecase")
        if industry_included and "Industry" in mapping_df.columns:
            layers.append("Industry")
        prev_col, prev_labels, prev_base = "Feature Name", feats, len(attrs)
        for col in layers:
            nodes = _split_multi(mapping_df[col].dropna())
            base = len(labels)
            labels = labels + nodes
            for _, row in mapping_df.iterrows():
                # prev_col values are themselves comma-joined past the first layer
                prev_val = str(row[prev_col])
                srcs = (
                    [prev_val]
                    if prev_val in prev_labels
                    else [p for p in prev_val.split(", ") if p in prev_labels]
                )
                for part in str(row[col]).split(", "):
                    if not part or part not in nodes:  # NaN rows were dropped from nodes
                        continue
                    for s in srcs:
                        src.append(prev_base + prev_labels.index(s))
                        tgt.append(base + nodes.index(part))
                        val.append(float(row["Similarity Score"]))
            prev_col, prev_labels, prev_base = col, nodes, base
    return {
        "data": [
            {
                "type": "sankey",
                "node": {"label": labels, "pad": 12},
                "link": {"source": src, "target": tgt, "value": val},
            }
        ],
        "layout": {"title": {"text": title}},
    }
