"""Recommender bootstrap (counterpart of
``anovos_tpu/feature_recommender/featrec_init.py``).

Lazy embedding-model singleton with an offline fallback, corpus loading,
the shared text-prep helpers (camel-case splitting, column-name
cleanup) and the cosine similarity matrix.

The TF-IDF fallback is this module's own :class:`_TfidfCharWB`, which
computes what the JAX package's ``sklearn`` ``TfidfVectorizer(
analyzer="char_wb", ngram_range=(2, 4), min_df=1, sublinear_tf=True)``
computes, in the same float64 operations and order, so the port needs no
``scikit-learn``.  :func:`cosine_sim_matrix` runs on the runtime's device
in float64 (numpy's dtype for the TF-IDF vectors; the hashed and
sentence-transformers vectors are f32 and are widened), so no
reduced-precision product decides a ranking on a near tie.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

# the corpus ships with the package; FR_CORPUS_PATH overrides for custom
# corpora
_DEFAULT_CORPUS_PATHS = [
    os.environ.get("FR_CORPUS_PATH", ""),
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "corpus.jsonl"),
]

_MODEL = None


class _HashedProjectionEncoder:
    """Dense-embedding stand-in with no weight files: hashed word/char-n-gram
    features projected into a fixed-dim space by per-bucket seeded Gaussian
    vectors (Johnson–Lindenstrauss: cosine over the projections approximates
    cosine over the sparse n-gram space).  Deterministic across processes —
    the hash is FNV-1a, not Python's salted ``hash``.  This drives the SAME
    dense-vector code path as sentence-transformers (fixed-width float
    vectors straight into ``cosine_sim_matrix``, no corpus fit), so the
    semantic backend is exercisable in weightless environments."""

    def __init__(self, dim: int = 256, buckets: int = 1 << 16):
        self.dim = dim
        self.buckets = buckets
        rng = np.random.default_rng(1234567)
        self._proj = rng.standard_normal((buckets, dim)).astype(np.float32)

    @staticmethod
    def _fnv1a(s: str) -> int:
        h = 0xCBF29CE484222325
        for b in s.encode("utf-8"):
            h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        return h

    def _features(self, text: str) -> List[str]:
        t = re.sub(r"\s+", " ", str(text).lower().strip())
        words = t.split(" ")
        feats = [f"w:{w}" for w in words]
        padded = f" {t} "
        feats += [f"c3:{padded[i:i + 3]}" for i in range(len(padded) - 2)]
        feats += [f"c4:{padded[i:i + 4]}" for i in range(len(padded) - 3)]
        return feats

    def encode(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, t in enumerate(texts):
            feats = self._features(t)
            if not feats:
                continue
            idx = np.fromiter(
                (self._fnv1a(f) % self.buckets for f in feats), np.int64, len(feats)
            )
            # sublinear weighting of repeated n-grams
            uniq, cnt = np.unique(idx, return_counts=True)
            w = (1.0 + np.log(cnt)).astype(np.float32)
            out[i] = (self._proj[uniq] * w[:, None]).sum(axis=0)
        return out


class _TfidfCharWB:
    """TF-IDF over character 2- to 4-grams inside word boundaries.

    Lower-cased text, runs of whitespace collapsed, each word padded with
    a space on either side; a word shorter than n yields itself once.  The
    vocabulary is every n-gram of the fitted texts, in sorted order; the
    weight of a term is ``(1 + ln count) · (ln((1 + docs) / (1 + df)) + 1)``
    and each row is divided by its L2 norm, summed in vocabulary order."""

    _white_spaces = re.compile(r"\s\s+")

    def __init__(self, ngram_range=(2, 4)):
        self.ngram_range = ngram_range
        self.vocabulary_: Dict[str, int] = {}
        self.idf_: Optional[np.ndarray] = None

    def _ngrams(self, text: str) -> List[str]:
        text = self._white_spaces.sub(" ", str(text).lower())
        min_n, max_n = self.ngram_range
        out = []
        for w in text.split():
            w = " " + w + " "
            w_len = len(w)
            for n in range(min_n, max_n + 1):
                offset = 0
                out.append(w[offset:offset + n])
                while offset + n < w_len:
                    offset += 1
                    out.append(w[offset:offset + n])
                if offset == 0:  # count a short word (w_len < n) only once
                    break
        return out

    def fit(self, texts: List[str]) -> "_TfidfCharWB":
        df: Dict[str, int] = {}
        for t in texts:
            for g in set(self._ngrams(t)):
                df[g] = df.get(g, 0) + 1
        if not df:
            raise ValueError("empty vocabulary; perhaps the documents only contain stop words")
        terms = sorted(df)
        self.vocabulary_ = {g: i for i, g in enumerate(terms)}
        counts = np.array([df[g] for g in terms], dtype=np.float64)
        idf = np.full_like(counts, fill_value=len(texts) + 1, dtype=np.float64)
        idf /= counts + 1.0
        np.log(idf, out=idf)
        idf += 1.0
        self.idf_ = idf
        return self

    def transform(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), len(self.vocabulary_)), dtype=np.float64)
        for i, t in enumerate(texts):
            tf: Dict[int, int] = {}
            for g in self._ngrams(t):
                j = self.vocabulary_.get(g)
                if j is not None:
                    tf[j] = tf.get(j, 0) + 1
            if not tf:
                continue
            idx = np.array(sorted(tf), dtype=np.int64)
            vals = np.array([tf[j] for j in idx], dtype=np.float64)
            np.log(vals, vals)
            vals += 1.0
            vals *= self.idf_[idx]
            norm = 0.0
            for v in vals.tolist():
                norm += v * v
            if norm != 0.0:
                vals /= math.sqrt(norm)
            out[i, idx] = vals
        return out


class _EmbeddingModel:
    """sentence-transformers when available offline; else the hashed
    dense projection (``FR_BACKEND=hashed``) or TF-IDF (default fallback)."""

    def __init__(self):
        self.backend = "tfidf"
        self.model = None
        requested = os.environ.get("FR_BACKEND", "auto")
        if requested not in ("auto", "sentence-transformers", "hashed", "tfidf"):
            raise ValueError(
                f"FR_BACKEND={requested!r} unknown; use auto | sentence-transformers | hashed | tfidf"
            )
        if requested in ("auto", "sentence-transformers"):
            try:  # pragma: no cover - requires downloaded weights
                from sentence_transformers import SentenceTransformer

                # a bare model name loads cache-only: hub downloads would spend
                # minutes in connect retries in offline envs before failing
                path = detect_model_path()
                self.model = SentenceTransformer(path, local_files_only=not os.path.isdir(path))
                self.backend = "sentence-transformers"
                return
            except Exception as e:
                if requested == "sentence-transformers":
                    # explicitly requested: do NOT silently degrade
                    raise RuntimeError(
                        "FR_BACKEND=sentence-transformers requested but the model "
                        "could not be loaded (missing package or weights)"
                    ) from e
        if requested == "hashed":
            self.model = _HashedProjectionEncoder()
            self.backend = "hashed"
            return
        self.model = _TfidfCharWB()
        self._fitted = False

    def fit_corpus(self, texts: List[str]) -> None:
        if self.backend == "tfidf":
            self.model.fit(texts)
            self._fitted = True

    def encode(self, texts: List[str]) -> np.ndarray:
        if self.backend == "sentence-transformers":  # pragma: no cover
            return np.asarray(self.model.encode(texts))
        if self.backend == "hashed":
            return self.model.encode(texts)
        if not getattr(self, "_fitted", False):
            self.fit_corpus(texts)
        return self.model.transform(texts)


def detect_model_path() -> str:
    """Env override, else the default model name."""
    return os.environ.get("FR_MODEL_PATH", "all-mpnet-base-v2")


def model_download() -> None:  # pragma: no cover - network-dependent
    """Eager model fetch — the one path allowed to reach the model hub."""
    global _MODEL
    from sentence_transformers import SentenceTransformer

    m = _EmbeddingModel.__new__(_EmbeddingModel)
    m.model = SentenceTransformer(detect_model_path())
    m.backend = "sentence-transformers"
    _MODEL = m


def get_model() -> _EmbeddingModel:
    global _MODEL
    if _MODEL is None:
        _MODEL = _EmbeddingModel()
    return _MODEL


def reset_model() -> None:
    """Drop the cached singleton (backend switches honor FR_BACKEND again)."""
    global _MODEL
    _MODEL = None


def load_corpus(corpus_path: Optional[str] = None) -> pd.DataFrame:
    paths = [corpus_path] if corpus_path else _DEFAULT_CORPUS_PATHS
    for p in paths:
        if p and os.path.exists(p):
            df = pd.read_json(p, lines=True) if p.endswith(".jsonl") else pd.read_csv(p)
            df.columns = [c.strip() for c in df.columns]
            return df
    raise FileNotFoundError(
        "feature recommender corpus not found; pass corpus_path (csv or jsonl) or place corpus.jsonl under feature_recommender/data/"
    )


def init_input_fer(corpus_path: Optional[str] = None) -> pd.DataFrame:
    """Raw FER corpus frame."""
    return load_corpus(corpus_path)


def feature_exploration_prep(corpus_path: Optional[str] = None) -> pd.DataFrame:
    """Corpus with normalized column names for the explorer."""
    df = load_corpus(corpus_path)
    return df.rename(columns=lambda c: c.strip().replace(" ", "_"))


def group_corpus_features(df: pd.DataFrame, name: str, desc: str, ind: str, uc: str) -> pd.DataFrame:
    """One row per distinct (name, description) with industry/usecase sets
    joined — the embedding corpus' dedup."""
    joinset = lambda x: ", ".join(sorted(set(x.dropna().astype(str))))
    # NaN descriptions must not drop features from the embedding corpus
    return (
        df.assign(**{desc: df[desc].fillna("")})
        .groupby([name, desc])
        .agg({ind: joinset, uc: joinset})
        .reset_index()
    )


def feature_recommendation_prep(corpus_path: Optional[str] = None):
    """(cleaned corpus texts, deduped corpus frame) for the mapper."""
    df = load_corpus(corpus_path)
    name, desc, ind, uc = get_column_name(df)
    grouped = group_corpus_features(df, name, desc, ind, uc)
    texts = recommendation_data_prep(grouped, name, desc)
    return texts, grouped


class EmbeddingsTrainFer:
    """Lazy corpus-embedding holder: encodes ``list_train_fer`` once on
    first ``.get`` and caches the matrix."""

    def __init__(self, list_train_fer: List[str]):
        self.list_train_fer = list_train_fer
        self._embeddings = None

    @property
    def get(self) -> np.ndarray:
        if self._embeddings is None:
            self._embeddings = get_model().encode(self.list_train_fer)
        return self._embeddings


def camel_case_split(identifier: str) -> str:
    """CamelCase → spaced words."""
    matches = re.finditer(r".+?(?:(?<=[a-z])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])|$)", str(identifier))
    return " ".join(m.group(0) for m in matches)


def get_column_name(df: pd.DataFrame):
    """Resolve the corpus column names."""
    cols = list(df.columns)
    name = cols[0]
    desc = cols[1] if len(cols) > 1 else cols[0]
    industry = next((c for c in cols if c.lower() == "industry"), cols[-2])
    usecase = next((c for c in cols if c.lower() == "usecase"), cols[-1])
    return name, desc, industry, usecase


def recommendation_data_prep(df: pd.DataFrame, name_col: str, desc_col: Optional[str]) -> List[str]:
    """Cleaned text for embedding (name + description)."""
    texts = []
    for _, row in df.iterrows():
        name = camel_case_split(str(row[name_col])).replace("_", " ").replace("-", " ")
        if desc_col and desc_col in df.columns and pd.notna(row.get(desc_col)):
            texts.append((name + " " + str(row[desc_col])).lower().strip())
        else:
            texts.append(name.lower().strip())
    return texts


def cosine_sim_matrix(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Cosine similarity of every row of ``A`` with every row of ``B``: a
    float64 product on the runtime's device, returned as a host array."""
    import torch

    from anovos_tpu_torch.shared.runtime import get_runtime

    dev = get_runtime().device
    a = torch.as_tensor(np.asarray(A), device=dev).to(torch.float64)
    b = torch.as_tensor(np.asarray(B), device=dev).to(torch.float64)
    an = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-30)
    bn = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-30)
    return (an @ bn.T).cpu().numpy()
