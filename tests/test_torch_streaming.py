"""The port's out-of-core streaming passes (``anovos_tpu_torch/ops/streaming.py``,
``quality_checker.{missing,outlier}_stats_streaming``,
``drift_detector.statistics_streaming``) against the JAX package's, on
six parquet parts of 2,000-3,000 rows whose chunks straddle the parts.

Bands (stated per test): counts, min, max, nonzero, histograms and the
quantiles (bin centres from the same f32 arithmetic) are exact.  The
moments are JAX's f32 chunk sums against the port's moments kernel plus a
float64 merge: within 1e-4 absolute (one unit of the 4th decimal the
frame rounds to) + 1e-5 relative.  Drift metrics within 1e-4 and the
flags equal; the fitted cutoffs lo + j·width within j ulps of the width
plus one ulp of j·width and one of the cutoff (XLA turns the division by
the static bin count into a multiplication by its reciprocal, and may
contract the sum into an FMA); given the same cutoffs, equal counts.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)

ROWS = (2000, 2600, 3000, 2200, 2900, 2400)
CHUNK = 2500
MOMENTS = ("mean", "stddev", "variance", "skewness", "kurtosis")
EXACT = ("count", "min", "max", "nonzero", "1%", "5%", "10%", "25%", "50%", "75%", "90%", "95%", "99%")


def _frame(g, i, n, shift=0.0):
    a = g.normal(i + shift, 2.0, n)
    a[g.random(n) < 0.08] = np.nan
    return pd.DataFrame({
        "a": a,
        "b": g.exponential(5.0 + shift, n),
        "c": g.integers(0, 100, n).astype(float),
        "d": g.integers(-50, 50, n).astype("int64"),
        "z": np.where(g.random(n) < 0.3, 0.0, g.normal(0, 1, n)),
        "cat": g.choice(["x", "y", "z"] if shift == 0 else ["x", "y", "w"], n),
        "s": np.where(g.random(n) < 0.1, None, g.choice(["p", "q"], n)).astype(object),
    })


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """Target: six parts; source: three parts of the same schema, shifted."""
    root = tmp_path_factory.mktemp("stream")
    g = np.random.default_rng(5)
    tgt, src = root / "tgt", root / "src"
    tgt.mkdir()
    src.mkdir()
    frames = []
    for i, n in enumerate(ROWS):
        df = _frame(g, i, n)
        df.to_parquet(tgt / f"part-{i:05d}.parquet", index=False)
        frames.append(df)
    for i in range(3):
        _frame(g, i, 2500, shift=0.7).to_parquet(src / f"part-{i:05d}.parquet", index=False)
    return {"tgt": str(tgt), "src": str(src), "frame": pd.concat(frames, ignore_index=True)}


@pytest.fixture(autouse=True)
def _no_chaos(monkeypatch):
    from anovos_tpu.data_ingest import guard as jg
    from anovos_tpu.resilience import chaos as jc
    from anovos_tpu_torch.data_ingest import guard as pg
    from anovos_tpu_torch.resilience import chaos as pc

    monkeypatch.setenv("ANOVOS_INGEST_RETRIES", "0")
    for m in (jg, pg, jc, pc):
        m.reset()
    yield
    for m in (jg, pg, jc, pc):
        m.reset()


def _assert_describe_close(got, exp):
    assert list(got.columns) == list(exp.columns)
    assert list(got["attribute"]) == list(exp["attribute"])
    for c in EXACT:
        np.testing.assert_array_equal(got[c].to_numpy(np.float64), exp[c].to_numpy(np.float64), err_msg=c)
    for c in MOMENTS:
        np.testing.assert_allclose(got[c].to_numpy(np.float64), exp[c].to_numpy(np.float64),
                                   rtol=1e-5, atol=1e-4, equal_nan=True, err_msg=c)


@pytest.mark.parametrize("chunk_rows", [CHUNK, 7000])
def test_describe_streaming_matches_jax(parts, chunk_rows):
    from anovos_tpu.ops.streaming import describe_streaming as jds
    from anovos_tpu_torch.ops.streaming import describe_streaming

    got = describe_streaming(parts["tgt"], "parquet", chunk_rows=chunk_rows)
    exp = jds(parts["tgt"], "parquet", chunk_rows=chunk_rows)
    assert list(got["attribute"]) == ["a", "b", "c", "d", "z"]
    _assert_describe_close(got, exp)


def test_describe_streaming_against_float64(parts):
    """Counts, min, max and nonzero exact; mean within 1e-5·σ, stddev
    within 1e-5 relative, skewness and kurtosis within 1e-4 (after the
    frame's 4-decimal rounding); every quantile within one bin width
    (range / 2048) of numpy's."""
    from anovos_tpu_torch.ops.streaming import describe_streaming

    got = describe_streaming(parts["tgt"], "parquet", chunk_rows=CHUNK).set_index("attribute")
    full = parts["frame"]
    for c in got.index:
        v = full[c].dropna().to_numpy(np.float32).astype(np.float64)
        r = got.loc[c]
        assert int(r["count"]) == len(v) and int(r["nonzero"]) == int((v != 0).sum())
        assert r["min"] == v.min() and r["max"] == v.max()
        sd = v.std(ddof=1)
        assert abs(r["mean"] - v.mean()) <= 1e-5 * sd + 5e-5
        assert abs(r["stddev"] - sd) <= 1e-5 * sd + 5e-5
        s = pd.Series(v)
        assert abs(r["skewness"] - s.skew() * (len(v) - 2) / np.sqrt(len(v) * (len(v) - 1))) <= 1e-4
        width = (v.max() - v.min()) / 2048
        for q in (1, 5, 10, 25, 50, 75, 90, 95, 99):
            assert abs(r[f"{q}%"] - np.quantile(v, q / 100)) <= width + 1e-4, (c, q)


def test_chunk_count_invariance(parts):
    """1,024-, 2,500- and 50,000-row chunks (many, straddling, one): counts,
    extremes and quantiles equal, moments within 1e-4."""
    from anovos_tpu_torch.ops.streaming import describe_streaming

    base = describe_streaming(parts["tgt"], "parquet", chunk_rows=CHUNK)
    for chunk_rows in (1024, 50_000):
        _assert_describe_close(describe_streaming(parts["tgt"], "parquet", chunk_rows=chunk_rows), base)


def test_chunk_hist_matches_jax():
    """The quantile pass' binning: values on and next to the bin edges, a
    constant column (width 1e-30), masked values below lo; the counts
    equal the JAX package's f32 arithmetic."""
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops.streaming import _chunk_hist as jhist
    from anovos_tpu_torch.ops.streaming import _chunk_hist

    g = np.random.default_rng(2)
    rows, nbins = 4000, 64
    lo = np.array([-3.0, 10.0, 5.0], np.float32)
    hi = np.array([3.0, 11.0, 5.0], np.float32)
    X = np.stack([g.normal(0, 1, rows).clip(-3, 3), 10 + np.arange(rows) % (nbins + 1) / nbins,
                  np.full(rows, 5.0)], 1).astype(np.float32)
    M = g.random((rows, 3)) > 0.1
    X[~M] = -1e6
    exp = np.asarray(jhist(jnp.asarray(X), jnp.asarray(M), jnp.asarray(lo), jnp.asarray(hi), nbins))
    got = _chunk_hist(torch.from_numpy(X.T.copy()), torch.from_numpy(M.T.copy()), torch.from_numpy(lo),
                      torch.from_numpy(hi), nbins)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), exp.astype(np.int64))


def test_quantiles_from_histogram_matches_jax():
    from anovos_tpu.ops.quantiles import quantiles_from_histogram as jq
    from anovos_tpu_torch.ops.quantiles import quantiles_from_histogram

    g = np.random.default_rng(3)
    hist = g.integers(0, 50, (4, 2048))
    hist[1, :] = 0
    hist[2, 100] = 3000
    lo = g.normal(0, 5, 4).astype(np.float32)
    width = g.uniform(1e-3, 1, 4).astype(np.float32)
    qs = np.asarray((0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99), np.float32)
    np.testing.assert_array_equal(quantiles_from_histogram(hist, lo, width, qs),
                                  jq(hist.astype(np.float32), lo, width, qs))


def test_missing_stats_streaming_matches_jax(parts):
    from anovos_tpu.data_analyzer.quality_checker import missing_stats_streaming as jms
    from anovos_tpu_torch.data_analyzer.quality_checker import missing_stats_streaming

    for cols in ("all", "a|s|cat"):
        got = missing_stats_streaming(parts["tgt"], "parquet", list_of_cols=cols, chunk_rows=CHUNK)
        pd.testing.assert_frame_equal(got, jms(parts["tgt"], "parquet", list_of_cols=cols,
                                               chunk_rows=CHUNK))
    full = parts["frame"]
    assert list(got["missing_count"]) == [int(full[c].isna().sum()) for c in ("a", "s", "cat")]


@pytest.fixture(scope="module")
def outlier_model(parts, tmp_path_factory):
    """Outlier bounds fitted by the port's in-memory outlier_detection on
    the first part (both sides, the three methods' defaults)."""
    from anovos_tpu_torch.data_analyzer.quality_checker import outlier_detection
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset

    model = str(tmp_path_factory.mktemp("outlier_model"))
    first = os.path.join(parts["tgt"], "part-00000.parquet")
    outlier_detection(read_dataset(first, "parquet"), list_of_cols="a|b|c|d", detection_side="both",
                      model_path=model)
    return model


def test_outlier_stats_streaming_matches_jax(parts, outlier_model):
    """Exact integer counts, equal to the JAX package's and to numpy's
    f32 compares over all rows."""
    from anovos_tpu.data_analyzer.quality_checker import outlier_stats_streaming as jos
    from anovos_tpu_torch.data_analyzer.quality_checker import _load_outlier_model, outlier_stats_streaming

    got = outlier_stats_streaming(parts["tgt"], "parquet", outlier_model, chunk_rows=CHUNK)
    pd.testing.assert_frame_equal(got, jos(parts["tgt"], "parquet", outlier_model, chunk_rows=CHUNK))
    bounds, _ = _load_outlier_model(outlier_model)
    full = parts["frame"]
    for _, r in got.iterrows():
        v = full[r["attribute"]].dropna().to_numpy(np.float32)
        lo, hi = (np.float32(-np.inf if b is None else b) for b in bounds[r["attribute"]])
        assert (r["lower_outliers"], r["upper_outliers"]) == (int((v < lo).sum()), int((v > hi).sum()))
    assert got["upper_outliers"].sum() > 0


def _model_files(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = os.path.join(d, f)
    return out


def _assert_drift_models_close(got_dir, exp_dir, src_dir):
    """Same files; cutoffs within j ulps of the bin width plus one ulp of
    j·width and one of the cutoff; categorical keys equal and p within 1e-6.  A numeric
    column's counts equal the JAX package's given the same cutoffs: the
    difference of the two frequency rows is exactly the source values
    (read from ``src_dir``) that the two cutoff rows put in different bins."""
    got, exp = _model_files(got_dir), _model_files(exp_dir)
    assert sorted(got) == sorted(exp)
    bins = os.path.join("drift_statistics", "attribute_binning", "part-00000.parquet")
    g, e = pd.read_parquet(got[bins]), pd.read_parquet(exp[bins])
    assert list(g["attribute"]) == list(e["attribute"])
    cuts = {}
    for c, gp, ep in zip(g["attribute"], g["parameters"], e["parameters"]):
        gp, ep = np.asarray(gp, np.float32), np.asarray(ep, np.float32)
        width = np.float32((ep[-1] - ep[0]) / (len(ep) - 1))
        j = np.arange(1, len(ep) + 1, dtype=np.float32)
        allow = j * np.spacing(np.abs(width)) + np.spacing(np.abs(j * width)) + np.spacing(np.abs(ep))
        assert np.all(np.abs(gp - ep) <= allow), (c, gp, ep)
        cuts[c] = (gp, ep)
    src = pd.read_parquet(src_dir)
    for rel in got:
        if rel == bins:
            continue
        gf, ef = pd.read_csv(got[rel], dtype=str), pd.read_csv(exp[rel], dtype=str)
        col = gf.columns[0]
        assert list(gf[col]) == list(ef[col]), rel
        gp, ep = gf["p"].astype(float).to_numpy(), ef["p"].astype(float).to_numpy()
        if col not in cuts:
            np.testing.assert_allclose(gp, ep, rtol=0, atol=1e-6, err_msg=rel)
            continue
        v = src[col].dropna().to_numpy(np.float32)
        moved = np.zeros(len(gp), np.int64)
        np.add.at(moved, (v[:, None] > cuts[col][0][None, :]).sum(1), 1)
        np.add.at(moved, (v[:, None] > cuts[col][1][None, :]).sum(1), -1)
        np.testing.assert_allclose((gp - ep) * len(src), moved, rtol=0, atol=1e-6 * len(src), err_msg=rel)


def test_statistics_streaming_matches_jax(parts, tmp_path):
    """Fresh fit from the source folder, then a second target pass against
    the persisted model (pre_existing_source): both frames and the model
    files against the JAX package's."""
    from anovos_tpu.drift_stability.drift_detector import statistics_streaming as jss
    from anovos_tpu_torch.drift_stability.drift_detector import statistics_streaming

    kw = dict(method_type="all", chunk_rows=CHUNK)
    got = statistics_streaming(parts["tgt"], "parquet", parts["src"], source_path=str(tmp_path / "p"), **kw)
    exp = jss(parts["tgt"], "parquet", parts["src"], source_path=str(tmp_path / "j"), **kw)
    _assert_drift_frames_close(got, exp)
    assert got["flagged"].sum() > 0
    _assert_drift_models_close(str(tmp_path / "p"), str(tmp_path / "j"), parts["src"])
    got2 = statistics_streaming(parts["tgt"], "parquet", pre_existing_source=True,
                                source_path=str(tmp_path / "p"), **kw)
    exp2 = jss(parts["tgt"], "parquet", pre_existing_source=True, source_path=str(tmp_path / "j"), **kw)
    _assert_drift_frames_close(got2, exp2)
    _assert_drift_frames_close(got2, got)


def _assert_drift_frames_close(got, exp):
    assert list(got.columns) == list(exp.columns)
    assert list(got["attribute"]) == list(exp["attribute"])
    assert list(got["flagged"]) == list(exp["flagged"])
    for m in ("PSI", "HD", "JSD", "KS"):
        np.testing.assert_allclose(got[m], exp[m], rtol=0, atol=1e-4, err_msg=m)


def test_statistics_streaming_equals_in_memory(parts, tmp_path):
    """The streaming drift of two folders is the port's in-memory
    ``statistics(use_sampling=False)`` of the same rows: equal frames and
    byte-equal model files."""
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset
    from anovos_tpu_torch.drift_stability.drift_detector import statistics, statistics_streaming

    got = statistics_streaming(parts["tgt"], "parquet", parts["src"], method_type="all",
                               chunk_rows=CHUNK, source_path=str(tmp_path / "s"))
    exp = statistics(read_dataset(parts["tgt"], "parquet"), read_dataset(parts["src"], "parquet"),
                     method_type="all", use_sampling=False, source_path=str(tmp_path / "m"))
    pd.testing.assert_frame_equal(got, exp)
    gs, ms = _model_files(str(tmp_path / "s")), _model_files(str(tmp_path / "m"))
    assert sorted(gs) == sorted(ms)
    for rel in gs:
        assert open(gs[rel], "rb").read() == open(ms[rel], "rb").read(), rel


def test_statistics_streaming_rejects_what_jax_rejects(parts):
    from anovos_tpu_torch.drift_stability.drift_detector import statistics_streaming

    with pytest.raises(ValueError, match="source_file_path required"):
        statistics_streaming(parts["tgt"], "parquet")
    with pytest.raises(ValueError, match="equal_range"):
        statistics_streaming(parts["tgt"], "parquet", parts["src"], bin_method="equal_frequency")


def test_counts_past_2_24_stay_exact():
    """Chunk histograms summed over many chunks: the JAX package adds them
    in f32 (``hist_d`` and ``_sum_hists``), which rounds once a bin passes
    2^24 = 16,777,216; the port sums int64 and stays exact.  Below 2^24
    a bin the two sums are equal (ROADMAP.md Queue C)."""
    from anovos_tpu_torch.ops.streaming import _sum_parts

    per_chunk = np.array([[1_000_001, 3], [1, 2]], np.int64)  # a 1M-row chunk's counts
    parts = {i: {"hist": per_chunk} for i in range(20)}
    exact = _sum_parts(parts, "hist")
    assert exact.dtype == np.int64
    np.testing.assert_array_equal(exact, per_chunk * 20)
    f32 = np.zeros((2, 2), np.float32)
    for i in sorted(parts):  # the reference's accumulation
        f32 = f32 + parts[i]["hist"].astype(np.float32)
    assert exact[0, 0] == 20_000_020 and f32[0, 0] == 20_000_016
    small = {i: {"hist": np.array([[4_000_000, 7]], np.int64)} for i in range(4)}
    f32s = sum(p["hist"].astype(np.float32) for p in small.values())
    np.testing.assert_array_equal(_sum_parts(small, "hist"), f32s.astype(np.int64))


@pytest.mark.parametrize("spec", [
    {"read_dataset": {"file_path": None, "file_type": "parquet"}},
    {"read_dataset": {"file_type": "csv", "file_configs": {"header": True, "sep": None}}},
    None,
])
def test_digest_and_fingerprints_match_jax(parts, spec):
    from anovos_tpu.cache import fingerprint as jf
    from anovos_tpu_torch.cache import fingerprint as pf

    if spec is not None and spec["read_dataset"].get("file_type") == "parquet":
        spec = {"read_dataset": {**spec["read_dataset"], "file_path": parts["tgt"]}}
    assert pf.canonical(spec) == jf.canonical(spec)
    assert pf.dataset_fingerprint(spec) == jf.dataset_fingerprint(spec)
    one = os.path.join(parts["tgt"], "part-00000.parquet")
    file_spec = {"read_dataset": {"file_path": one}}
    assert pf.dataset_fingerprint(file_spec) == jf.dataset_fingerprint(file_spec)
    assert pf.digest("a", b"b", "") == jf.digest("a", b"b", "")


def test_stream_signature_names_the_package(parts, tmp_path):
    """The same stream's signature differs between the packages, so a
    checkpoint directory the JAX package wrote is not resumed by the port
    (its partials are f32): the port starts afresh and gives its own
    uninterrupted result."""
    from anovos_tpu.ops import streaming as js
    from anovos_tpu.data_ingest.data_ingest import _resolve_files
    from anovos_tpu_torch.ops import streaming as ps

    files = _resolve_files(parts["tgt"], "parquet")
    args = (files, "parquet", ["a", "b"], CHUNK, 2048)
    assert ps._stream_sig(*args) != js._stream_sig(*args)
    ck = str(tmp_path / "ck")
    js.describe_streaming(parts["tgt"], "parquet", chunk_rows=CHUNK, checkpoint_dir=ck)
    got = ps.describe_streaming(parts["tgt"], "parquet", chunk_rows=CHUNK, checkpoint_dir=ck, resume=True)
    pd.testing.assert_frame_equal(got, ps.describe_streaming(parts["tgt"], "parquet", chunk_rows=CHUNK))
    events = [json.loads(line) for line in open(os.path.join(ck, "stream_journal.jsonl"))]
    port_begin = [e for e in events if e["event"] == "run_begin"][-1]
    assert port_begin["resume"] and port_begin["committed_p1"] == 0


def test_streaming_quarantine_matches_jax(parts, tmp_path):
    """A part cut short inside the stream: both packages quarantine it with
    the same record and describe the other five alike."""
    import shutil

    from anovos_tpu.data_ingest import guard as jg
    from anovos_tpu.ops.streaming import describe_streaming as jds
    from anovos_tpu_torch.data_ingest import guard as pg
    from anovos_tpu_torch.ops.streaming import describe_streaming

    d = tmp_path / "damaged"
    shutil.copytree(parts["tgt"], d)
    raw = open(d / "part-00002.parquet", "rb").read()
    open(d / "part-00002.parquet", "wb").write(raw[:-64])
    got = describe_streaming(str(d), "parquet", chunk_rows=CHUNK)
    exp = jds(str(d), "parquet", chunk_rows=CHUNK)
    _assert_describe_close(got, exp)
    assert int(got.set_index("attribute").loc["b", "count"]) == sum(ROWS) - ROWS[2]
    assert [r.to_json() for r in pg.records()] == [r.to_json() for r in jg.records()]
    assert len(pg.records()) == 1
