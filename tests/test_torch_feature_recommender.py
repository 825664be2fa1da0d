"""The port's feature recommender (``anovos_tpu_torch/feature_recommender``)
against the JAX package's, on the shipped 1,684-row corpus, under
``FR_BACKEND=tfidf`` and ``FR_BACKEND=hashed``: every public function of
the explorer and the mapper and ``sankey_visualization``, the cases of
``tests/test_recommender_explorer_api.py`` and
``tests/test_aux_modules.py::test_feature_recommender*`` and
``::test_semantic_backend_hashed_projection``.

Tolerances: the TF-IDF vectors equal the JAX package's (sklearn's) bit
for bit; the cosine matrices agree within 1e-12 (the port's is a float64
torch product, numpy's a float64 BLAS product).  The hashed vectors are
equal bit for bit; the JAX package takes their cosine in f32 and the port
in float64, so those matrices agree within 1e-6.  Frames are equal,
similarity scores (rounded to 4 decimals) within one unit of the 4th.
"""

import os

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)

BACKENDS = ["tfidf", "hashed"]
ATTRS = {"cust_age": "age of the customer", "txn_amt": "transaction amount in dollars",
         "loan_default": "whether the borrower defaulted", "CreditScoreBand": ""}
SCORE_ATOL = 1e-4 + 1e-9


@pytest.fixture(params=BACKENDS)
def backend(request, monkeypatch):
    from anovos_tpu.feature_recommender import featrec_init as jf
    from anovos_tpu_torch.feature_recommender import featrec_init as pf

    monkeypatch.setenv("FR_BACKEND", request.param)
    jf.reset_model()
    pf.reset_model()
    yield request.param
    jf.reset_model()
    pf.reset_model()


def _mods():
    from anovos_tpu.feature_recommender import feature_explorer as je, feature_mapper as jm
    from anovos_tpu_torch.feature_recommender import feature_explorer as pe, feature_mapper as pm

    return (je, jm), (pe, pm)


def assert_frames_equal(got: pd.DataFrame, exp: pd.DataFrame, score_cols=()) -> None:
    assert list(got.columns) == list(exp.columns) and len(got) == len(exp)
    for c in exp.columns:
        if c in score_cols:
            np.testing.assert_allclose(got[c].to_numpy(np.float64), exp[c].to_numpy(np.float64),
                                       rtol=0, atol=SCORE_ATOL, err_msg=c)
        else:
            assert got[c].astype(str).tolist() == exp[c].astype(str).tolist(), c


def test_the_corpus_is_the_jax_packages():
    import filecmp

    from anovos_tpu.feature_recommender import featrec_init as jf
    from anovos_tpu_torch.feature_recommender import featrec_init as pf

    assert filecmp.cmp(jf._DEFAULT_CORPUS_PATHS[1], pf._DEFAULT_CORPUS_PATHS[1], shallow=False)
    pd.testing.assert_frame_equal(pf.init_input_fer(), jf.init_input_fer())
    pd.testing.assert_frame_equal(pf.feature_exploration_prep(), jf.feature_exploration_prep())
    p_texts, p_grouped = pf.feature_recommendation_prep()
    j_texts, j_grouped = jf.feature_recommendation_prep()
    assert p_texts == j_texts
    pd.testing.assert_frame_equal(p_grouped, j_grouped)
    assert len(pf.init_input_fer()) == 1684


@pytest.mark.parametrize("fn,args", [
    ("list_all_industry", ()), ("list_all_usecase", ()), ("list_all_pair", ()),
])
def test_listings_equal_jax(fn, args):
    (je, _), (pe, _) = _mods()
    pd.testing.assert_frame_equal(getattr(pe, fn)(*args), getattr(je, fn)(*args))


@pytest.mark.parametrize("semantic", [False, True])
def test_explorer_functions_equal_jax(backend, semantic):
    """Every explorer function on a known value and, with ``semantic``, on
    a misspelled one that the embedding match resolves."""
    (je, _), (pe, _) = _mods()
    ind = je.list_all_industry()["Industry"].iloc[0]
    uc = je.list_usecase_by_industry(ind, semantic=False)["Usecase"].iloc[0]
    queries = [(ind, uc)]
    if semantic:
        queries.append(("bankng and finance", "churn of customers"))
    for qi, qu in queries:
        assert pe.process_industry(qi, semantic) == je.process_industry(qi, semantic)
        assert pe.process_usecase(qu, semantic) == je.process_usecase(qu, semantic)
        for fn, a in (("list_usecase_by_industry", (qi,)), ("list_industry_by_usecase", (qu,)),
                      ("list_feature_by_industry", (qi, 7)), ("list_feature_by_usecase", (qu, 7)),
                      ("list_feature_by_pair", (qi, qu, 7))):
            pd.testing.assert_frame_equal(getattr(pe, fn)(*a, semantic=semantic),
                                          getattr(je, fn)(*a, semantic=semantic), obj=fn)


def test_process_industry_semantic_false_passes_the_string():
    (je, _), (pe, _) = _mods()
    assert pe.process_industry("NoSuchIndustryXYZ", semantic=False) == "nosuchindustryxyz"
    assert je.process_industry("NoSuchIndustryXYZ", semantic=False) == "nosuchindustryxyz"


@pytest.mark.parametrize("filters", [{}, {"industry": "banking financial service and insurance"},
                                     {"usecase": "fraud detection"}])
def test_feature_mapper_equals_jax(backend, filters):
    (_, jm), (_, pm) = _mods()
    kw = dict(top_n=3, threshold=0.0, **filters)
    got, exp = pm.feature_mapper(ATTRS, **kw), jm.feature_mapper(ATTRS, **kw)
    assert len(exp) == 3 * len(ATTRS)
    assert_frames_equal(got, exp, score_cols=("Similarity Score",))
    names = list(ATTRS)
    descs = list(ATTRS.values())
    assert_frames_equal(pm.feature_mapper(names, descs, threshold=0.3),
                        jm.feature_mapper(names, descs, threshold=0.3), score_cols=("Similarity Score",))


def test_find_attr_by_relevance_equals_jax(backend):
    (_, jm), (_, pm) = _mods()
    corpus = ["customer age in years", "number of logins", "amount of the transaction"]
    for threshold in (-1.0, 0.0, 0.3):  # -1 keeps every pair, negative scores too
        kw = dict(building_corpus=corpus, threshold=threshold)
        got, exp = pm.find_attr_by_relevance(ATTRS, **kw), jm.find_attr_by_relevance(ATTRS, **kw)
        assert threshold > -1.0 or len(exp) == len(corpus) * len(ATTRS)
        assert_frames_equal(got, exp, score_cols=("Input Attribute Similarity Score",))
    got = pm.find_attr_by_relevance(ATTRS, building_corpus=corpus, threshold=0.0)
    top = got[got["Input Feature Desc"] == "customer age in years"].iloc[0]
    assert top["Recommended Input Attribute"] == "cust_age"


_MAPPINGS = {}


@pytest.mark.parametrize("layers", [(False, False), (True, False), (False, True), (True, True)])
def test_sankey_equals_jax(backend, layers):
    """sankey_visualization of the port's mapping equals JAX's of its own,
    with every combination of the industry and usecase layers, and on
    find_attr_by_relevance's output."""
    (_, jm), (_, pm) = _mods()
    if backend not in _MAPPINGS:  # one mapping a backend for the four layer cases
        _MAPPINGS[backend] = (pm.feature_mapper(ATTRS, top_n=2, threshold=0.0),
                              jm.feature_mapper(ATTRS, top_n=2, threshold=0.0))
    got_map, exp_map = _MAPPINGS[backend]
    got = pm.sankey_visualization(got_map, industry_included=layers[0], usecase_included=layers[1])
    exp = jm.sankey_visualization(exp_map, industry_included=layers[0], usecase_included=layers[1])
    assert got["data"][0]["node"] == exp["data"][0]["node"] and got["layout"] == exp["layout"]
    for k in ("source", "target"):
        assert got["data"][0]["link"][k] == exp["data"][0]["link"][k]
    np.testing.assert_allclose(got["data"][0]["link"]["value"], exp["data"][0]["link"]["value"],
                               rtol=0, atol=SCORE_ATOL)
    rel = dict(building_corpus=["customer age"], threshold=0.0)
    assert pm.sankey_visualization(jm.find_attr_by_relevance(ATTRS, **rel), *layers) == \
        jm.sankey_visualization(jm.find_attr_by_relevance(ATTRS, **rel), *layers)
    assert pm.sankey_visualization(exp_map, *layers) == jm.sankey_visualization(exp_map, *layers)


def test_embeddings_and_cosine_equal_jax(backend):
    """The encoders' vectors equal JAX's bit for bit; the cosine matrix of
    the first 40 corpus texts against all 1,684 within the module's bands,
    and its ranking equal but for near ties (within the band)."""
    from anovos_tpu.feature_recommender import featrec_init as jf
    from anovos_tpu_torch.feature_recommender import featrec_init as pf

    texts, _ = pf.feature_recommendation_prep()
    jmod, pmod = jf.get_model(), pf.get_model()
    assert pmod.backend == jmod.backend == backend
    jmod.fit_corpus(texts)
    pmod.fit_corpus(texts)
    ja, pa = jmod.encode(texts), pmod.encode(texts)
    assert pa.dtype == ja.dtype and pa.shape == ja.shape
    np.testing.assert_array_equal(pa, ja)
    js, ps = jf.cosine_sim_matrix(ja[:40], ja), pf.cosine_sim_matrix(pa[:40], pa)
    assert ps.dtype == np.float64
    band = 1e-12 if backend == "tfidf" else 1e-6
    np.testing.assert_allclose(ps, js, rtol=0, atol=band)
    np.testing.assert_allclose(np.diag(ps[:, :40]), 1.0, rtol=0, atol=1e-12)
    top_p, top_j = ps.argmax(axis=1), js.argmax(axis=1)
    tie = np.abs(ps[np.arange(40), top_j] - ps[np.arange(40), top_p]) <= 2 * band
    assert ((top_p == top_j) | tie).all()


def test_tfidf_matches_sklearn_on_edge_texts():
    """The port's TF-IDF against sklearn's TfidfVectorizer (the JAX
    package's) on texts with runs of spaces, one-letter words, tabs, no
    known n-gram and a repeated n-gram: equal vocabulary order and values."""
    from sklearn.feature_extraction.text import TfidfVectorizer

    from anovos_tpu_torch.feature_recommender.featrec_init import _TfidfCharWB

    fit = ["Age  of the\tCustomer", "a b c", "amount amount amount", "x", "ÉLAN vital"]
    probe = fit + ["zzz qqq", "", "customer age"]
    ref = TfidfVectorizer(analyzer="char_wb", ngram_range=(2, 4), min_df=1, sublinear_tf=True).fit(fit)
    mine = _TfidfCharWB().fit(fit)
    assert list(mine.vocabulary_) == list(ref.get_feature_names_out())
    np.testing.assert_array_equal(mine.idf_, ref.idf_)
    np.testing.assert_array_equal(mine.transform(probe), np.asarray(ref.transform(probe).todense()))


def test_hashed_backend_self_retrieval_and_determinism(monkeypatch):
    """The hashed backend in the port: deterministic across calls, a
    corpus feature's own name maps to it, and the port's mapping equals
    JAX's (tests/test_aux_modules.py::test_semantic_backend_hashed_projection)."""
    from anovos_tpu.feature_recommender import featrec_init as jf, feature_mapper as jm
    from anovos_tpu_torch.feature_recommender import featrec_init as pf
    from anovos_tpu_torch.feature_recommender.feature_explorer import list_all_industry, list_feature_by_industry
    from anovos_tpu_torch.feature_recommender.feature_mapper import feature_mapper

    monkeypatch.setenv("FR_BACKEND", "hashed")
    pf.reset_model()
    jf.reset_model()
    try:
        assert pf.get_model().backend == "hashed"
        e1 = pf.get_model().encode(["transaction amount"])
        np.testing.assert_array_equal(e1, pf.get_model().encode(["transaction amount"]))
        ind = list_all_industry()["Industry"].iloc[0]
        target = str(list_feature_by_industry(ind, num_of_feat=5)["Feature Name"].iloc[0])
        m = feature_mapper({"myattr": target}, top_n=3, threshold=0.0)
        assert target in set(m["Feature Name"].astype(str))
        kw = dict(top_n=10, threshold=0.0)
        assert_frames_equal(feature_mapper({"cust_age": "age of the customer in years"}, **kw),
                            jm.feature_mapper({"cust_age": "age of the customer in years"}, **kw),
                            score_cols=("Similarity Score",))
    finally:
        pf.reset_model()
        jf.reset_model()


@pytest.mark.parametrize("value", ["sentence-transformers", "word2vec"])
def test_backends_without_weights_raise_in_both(monkeypatch, value):
    """No sentence-transformers weights here: the explicit backend raises
    RuntimeError in both packages (never a silent fallback); an unknown
    backend raises ValueError in both."""
    from anovos_tpu.feature_recommender import featrec_init as jf
    from anovos_tpu_torch.feature_recommender import featrec_init as pf

    monkeypatch.setenv("FR_BACKEND", value)
    monkeypatch.setenv("FR_MODEL_PATH", os.path.join(os.sep, "nonexistent", "model"))
    err = RuntimeError if value == "sentence-transformers" else ValueError
    for mod in (pf, jf):
        mod.reset_model()
        with pytest.raises(err):
            mod.get_model()
        mod.reset_model()


def test_embeddings_train_fer_caches():
    from anovos_tpu_torch.feature_recommender import featrec_init as pf

    pf.reset_model()
    e = pf.EmbeddingsTrainFer(["customer age", "loan amount"])
    first = e.get
    assert e.get is first and first.shape[0] == 2
    pf.reset_model()


def test_camel_case_and_column_names_equal_jax():
    from anovos_tpu.feature_recommender import featrec_init as jf
    from anovos_tpu_torch.feature_recommender import featrec_init as pf

    for s in ("CreditScoreBand", "HTTPRequestCount", "already spaced", "ABC", "x_y-z"):
        assert pf.camel_case_split(s) == jf.camel_case_split(s)
    df = pf.load_corpus()
    assert pf.get_column_name(df) == jf.get_column_name(df)
