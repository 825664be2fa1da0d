"""The port's continuum (``anovos_tpu_torch.continuum``) against the JAX
package's on the same seeded feeds, on the CPU.

Held to the JAX package: every accumulator family's ``from_chunk``,
``combine`` and ``finalize`` on the same frames (exact for missing, hll,
categorical, outlier and drift counts; the moments within the bands of
tests/test_torch_streaming.py, since the port's partials are the moments
kernel's merged in float64 where the JAX package's are f32 XLA sums);
``config_sig`` and the snapshot fingerprint; the state layout (file
names, manifest keys, journal events in their order); every artifact of
one batch step (the drift model's cutoffs within a few ulps, its counts
exact given each side's cutoffs; the drift CSVs and alert values equal
where both read one persisted model); the report's bytes given the same
frames.  Held within the port: the monoid laws, retraction, the scan,
orphan adoption, snapshot restore, model swap and refold, foreign-config
orphans, a fixed corrupt day, shuffled arrivals against one batch step,
and row blocking at 1,000 rows against one block.  The feed recipe is
tests/test_continuum.py's.
"""

import hashlib
import json
import os
import pathlib
import shutil

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)

FAMILIES = ("categorical", "drift_target", "hll", "missing", "moments", "outlier")
EXACT_FAMILIES = ("missing", "hll", "categorical", "outlier", "drift_target")
MOMENT_COLS = ("mean", "stddev", "variance", "skewness", "kurtosis")


# ---------------------------------------------------------------------------
# helpers (the feed recipe of tests/test_continuum.py)
# ---------------------------------------------------------------------------
def _tree_hash(root, exclude=("obs",)) -> str:
    h = hashlib.sha256()
    root = pathlib.Path(root)
    for p in sorted(root.rglob("*")):
        if p.is_file() and not any(part in exclude for part in p.parts):
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _day_frame(rng, rows=300, shift=0.0, extra=False) -> pd.DataFrame:
    df = pd.DataFrame({
        "a": rng.normal(10.0 + shift, 2.0, rows),
        "b": rng.exponential(5.0, rows),
        "cat": rng.choice(["x", "y", "z"], rows),
    })
    if extra:
        df["extra"] = rng.normal(0.0, 1.0, rows)
    return df


def _write_feed(root, days, corrupt=(), rng_seed=7):
    """days: {day number: kwargs for _day_frame}; corrupt: day numbers
    whose parquet becomes garbage bytes."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(rng_seed)
    for i, kw in sorted(days.items()):
        path = os.path.join(root, f"day-{i:02d}.parquet")
        _day_frame(rng, **kw).to_parquet(path, index=False)
        if i in corrupt:
            with open(path, "wb") as f:
                f.write(b"NOTPARQUET" * 120)


def _spec(workdir, tag, feed_dir=None, drift=True, **extra) -> dict:
    spec = {
        "dataset_path": feed_dir or os.path.join(workdir, tag, "feed"),
        "state_dir": os.path.join(workdir, tag, "state"),
        "output_path": os.path.join(workdir, tag, "out"),
        **extra,
    }
    if drift:
        spec["drift"] = {"baseline": "day-01*", "threshold": 0.25}
    return spec


def _cfg(workdir, tag, feed_dir=None, drift=True, **extra):
    from anovos_tpu_torch.continuum.watcher import ContinuumConfig

    return ContinuumConfig.from_dict(_spec(workdir, tag, feed_dir, drift, **extra), base_dir=str(workdir))


def _jcfg(workdir, tag, feed_dir=None, drift=True, **extra):
    from anovos_tpu.continuum.watcher import ContinuumConfig

    return ContinuumConfig.from_dict(_spec(workdir, tag, feed_dir, drift, **extra), base_dir=str(workdir))


def _journal(state_dir):
    with open(os.path.join(state_dir, "continuum_journal.jsonl")) as f:
        return [json.loads(line) for line in f]


def _parts(frames, ctx, family, pkg="port"):
    if pkg == "port":
        from anovos_tpu_torch.continuum.sufficient import ACCUMULATORS, PartFrame
    else:
        from anovos_tpu.continuum.sufficient import ACCUMULATORS, PartFrame
    return {key: ACCUMULATORS[family].from_chunk(PartFrame(df, ctx), ctx, key)
            for key, df in frames.items()}


def _maps_equal(a, b) -> bool:
    if sorted(a) != sorted(b):
        return False
    return all(_partials_equal(a[k], b[k]) for k in a)


def _partials_equal(x, y) -> bool:
    if sorted(x) != sorted(y):
        return False
    return all(np.array_equal(np.asarray(x[n]), np.asarray(y[n])) for n in x)


def _skew_kurt(p):
    n, m2, m3, m4 = (np.asarray(p[k], np.float64) for k in ("n", "M2", "M3", "M4"))
    m2p = m2 / np.maximum(n, 1)
    return (m3 / np.maximum(n, 1)) / m2p ** 1.5, (m4 / np.maximum(n, 1)) / m2p ** 2


def _assert_partials_match(family, got, exp):
    """One family's partial (or combine) of the port against the JAX
    package's: exact but for the moments, whose f32 JAX partial gets the
    bands (n, min, max and nonzero exact)."""
    assert sorted(got) == sorted(exp), family
    if family != "moments":
        for name in exp:
            np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(exp[name]), err_msg=name)
        return
    for name in ("cols", "rows", "n", "min", "max", "nonzero"):
        np.testing.assert_array_equal(np.asarray(got[name], exp[name].dtype), exp[name], err_msg=name)
    sd = np.sqrt(np.asarray(exp["M2"], np.float64) / np.maximum(np.asarray(exp["n"], np.float64), 1))
    allow = 1e-5 * (np.abs(exp["mean"]) + sd) + 1e-7
    assert np.all(np.abs(got["mean"] - exp["mean"]) <= allow), (got["mean"], exp["mean"])
    np.testing.assert_allclose(got["M2"], exp["M2"], rtol=2e-5, atol=1e-6)
    gs, gk = _skew_kurt(got)
    es, ek = _skew_kurt(exp)
    np.testing.assert_allclose(gs, es, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gk, ek, rtol=1e-4, atol=1e-4)


def _assert_stats_close(got: pd.DataFrame, exp: pd.DataFrame):
    """A stats frame against the JAX package's: counts, extremes, nonzero
    and HLL estimates exact; the moments within 1e-4 + 1e-5 relative after
    the 4-decimal rounding."""
    assert list(got.columns) == list(exp.columns)
    assert list(got["attribute"]) == list(exp["attribute"])
    for c in got.columns:
        if c == "attribute":
            continue
        g, e = got[c].to_numpy(np.float64), exp[c].to_numpy(np.float64)
        if c in MOMENT_COLS:
            np.testing.assert_allclose(g, e, rtol=1e-5, atol=1e-4, equal_nan=True, err_msg=c)
        else:
            np.testing.assert_array_equal(g, e, err_msg=c)


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Both packages keep their quarantine records, chaos plans, flight
    rings and heartbeats in process globals: clear them around each test."""
    from anovos_tpu.data_ingest import guard as jg
    from anovos_tpu.obs import flight as jf
    from anovos_tpu.resilience import chaos as jc
    from anovos_tpu_torch.data_ingest import guard as pg
    from anovos_tpu_torch.obs import flight as pf
    from anovos_tpu_torch.obs import telemetry as pt
    from anovos_tpu_torch.resilience import chaos as pc

    def _reset():
        for m in (jg, jf, jc, pg, pf, pc):
            m.reset()
        pt.clear_heartbeat()

    _reset()
    yield
    _reset()


# ---------------------------------------------------------------------------
# the families against the JAX package
# ---------------------------------------------------------------------------
_CUTS = {"a": np.linspace(5.0, 15.0, 9), "b": np.linspace(0.5, 20.0, 9)}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny persisted drift model (attribute_binning + frequencies) that
    both packages read."""
    from anovos_tpu_torch.data_transformer.model_io import save_model_df

    root = str(tmp_path_factory.mktemp("ctx"))
    model = os.path.join(root, "drift_model")
    save_model_df(pd.DataFrame({"attribute": list(_CUTS),
                                "parameters": [list(map(float, v)) for v in _CUTS.values()]}),
                  model, "attribute_binning")
    for c, keys in (("a", list(range(1, 11))), ("b", list(range(1, 11))), ("cat", ["x", "y", "z"])):
        d = os.path.join(model, "frequency_counts", c)
        os.makedirs(d, exist_ok=True)
        pd.DataFrame({c: keys, "p": [1.0 / len(keys)] * len(keys)}).to_csv(
            os.path.join(d, "part-00000.csv"), index=False)
    return model


def _ctx(model, pkg="port"):
    if pkg == "port":
        from anovos_tpu_torch.continuum.sufficient import DriftSpec, FoldContext
    else:
        from anovos_tpu.continuum.sufficient import DriftSpec, FoldContext
    return FoldContext(hll_p=8, outlier_bounds={"a": (5.0, 15.0), "b": (0.0, 20.0)},
                       drift=DriftSpec(model_dir=model, baseline="day-01*"), drift_cutoffs=dict(_CUTS))


@pytest.fixture(scope="module")
def three_frames():
    """Three partitions: a plain day, a shifted day with nulls (numeric and
    categorical), and a day with an extra column (schema drift)."""
    rng = np.random.default_rng(11)
    p2 = _day_frame(rng, rows=150, shift=3.0)
    p2.loc[rng.random(150) < 0.1, "a"] = np.nan
    p2["cat"] = p2["cat"].astype(object)
    p2.loc[rng.random(150) < 0.1, "cat"] = None
    return {
        "p1": _day_frame(rng, rows=200),
        "p2": p2,
        "p3": _day_frame(rng, rows=250, extra=True),
    }


@pytest.mark.parametrize("family", FAMILIES)
def test_part_stats_match_jax(family, model_dir, three_frames):
    got = _parts(three_frames, _ctx(model_dir), family)
    exp = _parts(three_frames, _ctx(model_dir, "jax"), family, "jax")
    for key in three_frames:
        _assert_partials_match(family, got[key][key], exp[key][key])


@pytest.mark.parametrize("family", FAMILIES)
def test_combine_matches_jax(family, model_dir, three_frames):
    from anovos_tpu.continuum.sufficient import ACCUMULATORS as JACC
    from anovos_tpu_torch.continuum.sufficient import ACCUMULATORS

    got = {k: v[k] for k, v in _parts(three_frames, _ctx(model_dir), family).items()}
    exp = {k: v[k] for k, v in _parts(three_frames, _ctx(model_dir, "jax"), family, "jax").items()}
    acc, jacc = ACCUMULATORS[family], JACC[family]
    _assert_partials_match(family, acc.combine(acc.combine(got["p1"], got["p2"]), got["p3"]),
                           jacc.combine(jacc.combine(exp["p1"], exp["p2"]), exp["p3"]))


@pytest.mark.parametrize("family", FAMILIES)
def test_finalize_matches_jax(family, model_dir, three_frames):
    from anovos_tpu.continuum.sufficient import ACCUMULATORS as JACC
    from anovos_tpu_torch.continuum.sufficient import ACCUMULATORS

    ctx, jctx = _ctx(model_dir), _ctx(model_dir, "jax")
    state, jstate = {}, {}
    for k, v in _parts(three_frames, ctx, family).items():
        state = ACCUMULATORS[family].merge(state, v)
    for k, v in _parts(three_frames, jctx, family, "jax").items():
        jstate = JACC[family].merge(jstate, v)
    got = ACCUMULATORS[family].finalize(state, ctx)
    exp = JACC[family].finalize(jstate, jctx)
    if family == "moments":
        _assert_stats_close(got, exp)
    else:
        assert got.to_csv(index=False) == exp.to_csv(index=False)


def test_drift_freqs_and_alerts_match_jax(model_dir, three_frames):
    """The per-partition drift alert reads ``freqs`` of one partial: the
    alert records equal the JAX package's."""
    from anovos_tpu.continuum import alerts as jalerts
    from anovos_tpu_torch.continuum import alerts

    ctx, jctx = _ctx(model_dir), _ctx(model_dir, "jax")
    for key, frame in three_frames.items():
        fams = {f: _parts({key: frame}, ctx, f)[key][key] for f in ("drift_target", "missing")}
        jfams = {f: _parts({key: frame}, jctx, f, "jax")[key][key] for f in ("drift_target", "missing")}
        got = alerts.evaluate_part(key, fams, ctx, thresholds={"missing_pct": 0.05})
        exp = jalerts.evaluate_part(key, jfams, jctx, thresholds={"missing_pct": 0.05})
        assert got == exp
        assert got, key  # the uniform source model flags every day


# ---------------------------------------------------------------------------
# the monoid laws (the port's own)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_merge_is_associative_and_order_insensitive(family, model_dir, three_frames):
    from anovos_tpu_torch.continuum.sufficient import ACCUMULATORS

    acc = ACCUMULATORS[family]
    parts = _parts(three_frames, _ctx(model_dir), family)
    a, b, c = parts["p1"], parts["p2"], parts["p3"]
    left = acc.merge(acc.merge(a, b), c)
    assert _maps_equal(left, acc.merge(a, acc.merge(b, c)))
    assert _maps_equal(left, acc.merge(c, acc.merge(a, b)))
    assert _maps_equal(acc.merge(left, a), left)
    with pytest.raises(ValueError):
        acc.merge(left, {"p1": b["p2"]})


@pytest.mark.parametrize("family", EXACT_FAMILIES)
def test_exact_families_combine_associative(family, model_dir, three_frames):
    from anovos_tpu_torch.continuum.sufficient import ACCUMULATORS

    acc = ACCUMULATORS[family]
    parts = _parts(three_frames, _ctx(model_dir), family)
    x, y, z = (parts[k][k] for k in ("p1", "p2", "p3"))
    assert _partials_equal(acc.combine(acc.combine(x, y), z), acc.combine(x, acc.combine(y, z)))
    assert _partials_equal(acc.combine(x, y), acc.combine(y, x))


@pytest.mark.parametrize("family", FAMILIES)
def test_finalize_invariant_under_fold_order(family, model_dir, three_frames):
    from anovos_tpu_torch.continuum.sufficient import ACCUMULATORS

    ctx = _ctx(model_dir)
    parts = _parts(three_frames, ctx, family)
    outs = []
    for order in (("p1", "p2", "p3"), ("p3", "p1", "p2"), ("p2", "p3", "p1")):
        state = {}
        for k in order:
            state = ACCUMULATORS[family].merge(state, parts[k])
        outs.append(ACCUMULATORS[family].finalize(state, ctx).to_csv(index=False))
    assert outs[1:] == outs[:1] * 2


def test_retraction_removes_contribution(model_dir, three_frames):
    from anovos_tpu_torch.continuum.sufficient import ACCUMULATORS

    ctx = _ctx(model_dir)
    acc = ACCUMULATORS["moments"]
    parts = _parts(three_frames, ctx, "moments")
    full = acc.merge(acc.merge(parts["p1"], parts["p2"]), parts["p3"])
    without = dict(full)
    without.pop("p2")
    assert (acc.finalize(without, ctx).to_csv(index=False)
            == acc.finalize(acc.merge(parts["p1"], parts["p3"]), ctx).to_csv(index=False))


def test_row_blocks_of_1000_equal_one_block(model_dir, monkeypatch):
    """FOLD_BLOCK_ROWS (2^24 on the card, where the kernels' f32 counts
    stop being exact) set to 1,000: a 3,500-row partition folds in four
    blocks, one moments and one histogram launch each, and gives the
    one-block partials: counts, extremes, registers, outliers and
    histograms exact, the moments within f32 rounding (mean 1e-6·(|mean|
    + σ), M2 1e-6 relative, skewness and kurtosis 1e-5)."""
    from anovos_tpu_torch.continuum import sufficient
    from anovos_tpu_torch.ops import drift_kernels, streaming

    rng = np.random.default_rng(3)
    frame = _day_frame(rng, rows=3500)
    frame.loc[rng.random(3500) < 0.05, "a"] = np.nan
    ctx = _ctx(model_dir)
    one = {f: _parts({"p": frame}, ctx, f)["p"]["p"] for f in FAMILIES}
    calls = {"moments": 0, "hist": 0}
    chunk_stats, hist = streaming._chunk_stats, drift_kernels.binned_histograms

    def counted_stats(X, M):
        calls["moments"] += 1
        assert X.shape[1] <= 1000
        return chunk_stats(X, M)

    def counted_hist(X, M, cuts, nbins):
        calls["hist"] += 1
        assert X.shape[0] <= 1000
        return hist(X, M, cuts, nbins)

    monkeypatch.setattr(sufficient, "FOLD_BLOCK_ROWS", 1000)
    monkeypatch.setattr(streaming, "_chunk_stats", counted_stats)
    monkeypatch.setattr(drift_kernels, "binned_histograms", counted_hist)
    blocked = {f: _parts({"p": frame}, ctx, f)["p"]["p"] for f in FAMILIES}
    assert calls == {"moments": 4, "hist": 4}
    for f in FAMILIES:
        if f != "moments":
            assert _partials_equal(blocked[f], one[f]), f
    got, exp = blocked["moments"], one["moments"]
    for name in ("cols", "rows", "n", "min", "max", "nonzero"):
        np.testing.assert_array_equal(got[name], exp[name], err_msg=name)
    sd = np.sqrt(exp["M2"] / exp["n"])
    assert np.all(np.abs(got["mean"] - exp["mean"]) <= 1e-6 * (np.abs(exp["mean"]) + sd))
    np.testing.assert_allclose(got["M2"], exp["M2"], rtol=1e-6)
    for g, e in zip(_skew_kurt(got), _skew_kurt(exp)):
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# state: scan / adopt / snapshot restore / model swap / foreign config
# ---------------------------------------------------------------------------
def test_scan_classifies_new_changed_retracted(tmp_path):
    from anovos_tpu_torch.continuum.watcher import step
    from anovos_tpu_torch.obs import get_metrics

    feed = os.path.join(str(tmp_path), "feed")
    _write_feed(feed, {1: {}, 2: {}, 3: {}})
    cfg = _cfg(str(tmp_path), "t", feed_dir=feed, drift=False)
    step(cfg)
    rng = np.random.default_rng(99)
    _day_frame(rng, rows=123).to_parquet(os.path.join(feed, "day-02.parquet"), index=False)
    os.unlink(os.path.join(feed, "day-03.parquet"))
    _day_frame(rng, rows=50).to_parquet(os.path.join(feed, "day-04.parquet"), index=False)
    folded = get_metrics().counter("continuum_partitions_folded_total").value()
    s = step(cfg)
    assert s["scan"]["changed"] == ["day-02.parquet"]
    assert s["scan"]["retracted"] == ["day-03.parquet"]
    assert s["scan"]["new"] == ["day-04.parquet"]
    assert s["partitions"] == 3 and s["rows"] == 300 + 123 + 50
    # the service's gauges and counter (the JAX names)
    assert get_metrics().counter("continuum_partitions_folded_total").value() == folded + 2
    assert get_metrics().gauge("continuum_fold_backlog").value() == 0.0
    assert get_metrics().gauge("continuum_arrival_artifact_lag_seconds").value() > 0


def test_orphan_npz_adopted_without_decode(tmp_path):
    from anovos_tpu_torch.continuum.watcher import step

    feed = os.path.join(str(tmp_path), "feed")
    _write_feed(feed, {1: {}, 2: {}})
    cfg = _cfg(str(tmp_path), "t", feed_dir=feed, drift=False)
    step(cfg)
    mpath = os.path.join(cfg.state_dir, "state_manifest.json")
    with open(mpath) as f:
        doc = json.load(f)
    doc["parts"].pop("day-02.parquet")
    with open(mpath, "w") as f:
        json.dump(doc, f)
    s = step(cfg)
    assert s["folded"] == []
    recs = _journal(cfg.state_dir)
    assert any(r.get("event") == "partition_seen" and r.get("status") == "adopted"
               and r.get("part") == "day-02.parquet" for r in recs)
    assert sum(1 for r in recs if r.get("event") == "fold_commit" and r["part"] == "day-02.parquet") == 1


def test_snapshot_restore_from_store(tmp_path):
    """A lost state dir rebuilds from the newest snapshot in the port's
    CacheStore; the artifacts are byte-identical and nothing re-decodes."""
    from anovos_tpu_torch.cache.store import CacheStore
    from anovos_tpu_torch.continuum.watcher import step

    feed = os.path.join(str(tmp_path), "feed")
    _write_feed(feed, {1: {}, 2: {}, 3: {}})
    cache = os.path.join(str(tmp_path), "snapstore")
    cfg = _cfg(str(tmp_path), "t", feed_dir=feed, drift=False, cache_dir=cache)
    s0 = step(cfg)
    assert CacheStore(cache).lookup(s0["snapshot_fp"])["node"].startswith("continuum:state:")
    ref = _tree_hash(cfg.output_path)
    shutil.rmtree(cfg.state_dir)
    shutil.rmtree(cfg.output_path)
    s = step(cfg)
    assert s["folded"] == [] and s["partitions"] == 3
    assert _tree_hash(cfg.output_path) == ref
    assert any(r.get("event") == "state_restored" for r in _journal(cfg.state_dir))


def _write_drift_model(model_dir, lo, hi):
    from anovos_tpu_torch.data_transformer.model_io import save_model_df
    from anovos_tpu_torch.drift_stability.drift_detector import save_frequency_map

    cuts = {"a": np.linspace(lo, hi, 9), "b": np.linspace(0.5, 20.0, 9)}
    save_model_df(pd.DataFrame({"attribute": list(cuts),
                                "parameters": [list(map(float, v)) for v in cuts.values()]}),
                  model_dir, "attribute_binning")
    for c in ("a", "b"):
        save_frequency_map(model_dir, c, list(range(1, 11)), [0.1] * 10)
    save_frequency_map(model_dir, "cat", ["x", "y", "z"], [1 / 3] * 3)


def test_swapped_drift_model_invalidates_and_refolds(tmp_path):
    from anovos_tpu_torch.continuum.watcher import step

    work = str(tmp_path)
    feed = os.path.join(work, "feed")
    _write_feed(feed, {1: {}, 2: {}})
    model = os.path.join(work, "modelA")
    _write_drift_model(model, 5.0, 15.0)
    cfg = _cfg(work, "t", feed_dir=feed, drift=False)
    cfg.drift = {"model_path": model}
    step(cfg)
    shutil.rmtree(model)
    _write_drift_model(model, 0.0, 30.0)
    s = step(cfg)
    assert s["refolded"] == ["day-01.parquet", "day-02.parquet"]
    assert any(r.get("event") == "family_invalidated" and r.get("family") == "drift_target"
               for r in _journal(cfg.state_dir))
    ref = _cfg(work, "ref", feed_dir=feed, drift=False)
    ref.drift = {"model_path": model}
    step(ref)
    with open(os.path.join(cfg.output_path, "continuum_drift.csv")) as a, \
            open(os.path.join(ref.output_path, "continuum_drift.csv")) as b:
        assert a.read() == b.read()


def test_foreign_config_orphans_not_adopted(tmp_path):
    from anovos_tpu_torch.continuum.watcher import step

    feed = os.path.join(str(tmp_path), "feed")
    _write_feed(feed, {1: {}, 2: {}})
    cfg = _cfg(str(tmp_path), "t", feed_dir=feed, drift=False)
    step(cfg)
    cfg2 = _cfg(str(tmp_path), "t", feed_dir=feed, drift=False, hll_rsd=0.02)
    assert cfg2.config_sig() != cfg.config_sig()
    s = step(cfg2)
    assert sorted(s["folded"]) == ["day-01.parquet", "day-02.parquet"]
    assert not any(r.get("status") == "adopted" for r in _journal(cfg2.state_dir)
                   if r.get("event") == "partition_seen")


def test_fixed_corrupt_day_refolds(tmp_path):
    from anovos_tpu_torch.continuum.watcher import status, step

    feed = os.path.join(str(tmp_path), "feed")
    _write_feed(feed, {1: {}, 2: {}}, corrupt=(2,))
    cfg = _cfg(str(tmp_path), "t", feed_dir=feed, drift=False)
    assert step(cfg)["quarantined"] == ["day-02.parquet"]
    s = step(cfg)
    assert s["quarantined"] == [] and s["folded"] == []
    assert s["scan"]["quarantined"] == ["day-02.parquet"]
    _day_frame(np.random.default_rng(1), rows=77).to_parquet(os.path.join(feed, "day-02.parquet"), index=False)
    assert step(cfg)["folded"] == ["day-02.parquet"]
    assert status(cfg)["quarantined"] == []


# ---------------------------------------------------------------------------
# incremental against batch, and the batch step against the JAX package
# ---------------------------------------------------------------------------
PLANTED = {1: {}, 2: {}, 3: {"extra": True}, 4: {}, 5: {"shift": 5.0}, 6: {}}


def test_incremental_matches_batch_with_planted_faults(tmp_path):
    """Shuffled arrivals (schema drift day 3, corrupt day 4, shift day 5)
    against ONE step over the union: byte-identical artifact trees
    (``obs/`` left out), the corrupt day quarantined with its alert, and
    the shift day's drift alert carrying the flight recorder's tail."""
    from anovos_tpu_torch.continuum.watcher import status, step
    from anovos_tpu_torch.data_ingest import guard

    work = str(tmp_path)
    src = os.path.join(work, "alldays")
    _write_feed(src, PLANTED, corrupt=(4,))
    inc = _cfg(work, "inc")
    os.makedirs(inc.dataset_path)
    alerts_by_day = {}
    for i in (1, 3, 2, 4, 6, 5):
        shutil.copy2(os.path.join(src, f"day-{i:02d}.parquet"),
                     os.path.join(inc.dataset_path, f"day-{i:02d}.parquet"))
        alerts_by_day[i] = step(inc)["alerts"]
    bat = _cfg(work, "bat", feed_dir=src)
    guard.reset()
    sb = step(bat)
    assert _tree_hash(inc.output_path) == _tree_hash(bat.output_path)
    assert sb["quarantined"] == ["day-04.parquet"]
    assert status(inc)["quarantined"] == ["day-04.parquet"]
    assert alerts_by_day[4] >= 1 and alerts_by_day[5] >= 1
    with open(os.path.join(inc.output_path, "obs", "continuum_alerts.jsonl")) as f:
        alines = [json.loads(line) for line in f]
    drift = [a for a in alines if a["kind"] == "drift" and a["partition"] == "day-05.parquet"]
    assert drift and drift[0]["value"] > drift[0]["threshold"]
    assert drift[0]["flight"], "alert carries no flight-recorder context"
    assert any(a["kind"] == "quarantine" and a["partition"] == "day-04.parquet" for a in alines)


@pytest.fixture(scope="module")
def batch_legs(tmp_path_factory):
    """One batch step of each package over the planted feed (each fits its
    own drift model from day 1), with an outlier model both read."""
    from anovos_tpu.continuum import watcher as jw
    from anovos_tpu.data_ingest import guard as jg
    from anovos_tpu_torch.continuum import watcher as pw
    from anovos_tpu_torch.data_ingest import guard as pg
    from anovos_tpu_torch.data_transformer.model_io import save_model_df
    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime("cpu")
    work = str(tmp_path_factory.mktemp("legs"))
    feed = os.path.join(work, "feed")
    _write_feed(feed, PLANTED, corrupt=(4,))
    outlier = os.path.join(work, "outlier_model")
    save_model_df(pd.DataFrame({"attribute": ["a", "b"], "parameters": [[6.0, 14.0], [None, 15.0]]}),
                  outlier, "outlier_numcols")
    extra = {"outlier_model_path": outlier, "stability": {"threshold": 1}}
    out = {"feed": feed, "work": work}
    for tag, mod, guard, cfgf in (("port", pw, pg, _cfg), ("jax", jw, jg, _jcfg)):
        guard.reset()
        cfg = cfgf(work, tag, feed_dir=feed, **extra)
        out[tag] = {"cfg": cfg, "summary": mod.step(cfg)}
    return out


def test_config_sig_and_snapshot_fingerprint_equal_jax(tmp_path, batch_legs):
    from anovos_tpu.continuum.watcher import ContinuumConfig as JCfg
    from anovos_tpu_torch.continuum.watcher import ContinuumConfig

    for d in ({"dataset_path": "x"},
              {"dataset_path": "x", "drift": {"baseline": "base-*", "bin_size": 20, "method_type": "all"},
               "outlier_model_path": "m", "hll_rsd": 0.02, "drop_cols": ["income"],
               "list_of_cols": ["a", "b"], "stability": {"threshold": 2}}):
        assert ContinuumConfig.from_dict(d).config_sig() == JCfg.from_dict(d).config_sig()
    assert batch_legs["port"]["summary"]["snapshot_fp"] == batch_legs["jax"]["summary"]["snapshot_fp"]


def test_state_layout_equals_jax(batch_legs):
    """The same file names under the state dir, the same manifest keys and
    entries (the drift family's basis digests the fitted cutoffs, which
    may differ by ulps), and the same journal events in the same order."""
    p, j = (batch_legs[t]["cfg"].state_dir for t in ("port", "jax"))

    def files(root):
        return sorted(str(x.relative_to(root)) for x in pathlib.Path(root).rglob("*") if x.is_file())

    assert files(p) == files(j)
    pm, jm = (json.load(open(os.path.join(d, "state_manifest.json"))) for d in (p, j))
    assert sorted(pm) == sorted(jm) and pm["config_sig"] == jm["config_sig"]
    assert sorted(pm["family_basis"]) == sorted(jm["family_basis"])
    assert pm["family_basis"]["outlier"] == jm["family_basis"]["outlier"]
    assert pm["parts"] == jm["parts"]
    strip = ("t", "fold_wall_s", "wall_s", "fp", "dataset")
    pj = [{k: v for k, v in r.items() if k not in strip} for r in _journal(p)]
    jj = [{k: v for k, v in r.items() if k not in strip} for r in _journal(j)]
    assert [r["event"] for r in pj] == [r["event"] for r in jj]
    assert pj == jj
    for fn in os.listdir(os.path.join(p, "parts")):
        with np.load(os.path.join(p, "parts", fn)) as a, np.load(os.path.join(j, "parts", fn)) as b:
            assert sorted(a.files) == sorted(b.files), fn


def test_batch_artifacts_match_jax(batch_legs):
    """Each artifact of the port's batch step against the JAX package's:
    stats in the moment bands (HLL estimates exact), missing, categorical
    and outlier byte-equal, stability within the bands its CVs inherit,
    the drift model's cutoffs within a few ulps and its counts exact
    given each side's cutoffs, the step summaries' fold accounting equal."""
    p, j = (batch_legs[t]["cfg"].output_path for t in ("port", "jax"))
    assert sorted(os.listdir(p)) == sorted(os.listdir(j))
    _assert_stats_close(pd.read_csv(os.path.join(p, "continuum_stats.csv")),
                        pd.read_csv(os.path.join(j, "continuum_stats.csv")))
    for name in ("continuum_missing.csv", "continuum_categorical.csv", "continuum_outlier.csv"):
        with open(os.path.join(p, name)) as a, open(os.path.join(j, name)) as b:
            assert a.read() == b.read(), name
    for name, atol in (("continuum_stability.csv", 2e-4), ("continuum_stability_history.csv", 1e-5)):
        got, exp = pd.read_csv(os.path.join(p, name)), pd.read_csv(os.path.join(j, name))
        assert list(got.columns) == list(exp.columns)
        for c in got.columns:
            if pd.api.types.is_numeric_dtype(exp[c]) and c != "idx":
                np.testing.assert_allclose(got[c].to_numpy(np.float64), exp[c].to_numpy(np.float64),
                                           rtol=1e-4, atol=atol, equal_nan=True, err_msg=f"{name}:{c}")
            else:
                assert list(got[c].astype(str)) == list(exp[c].astype(str)), f"{name}:{c}"
    sp, sj = batch_legs["port"]["summary"], batch_legs["jax"]["summary"]
    for k in ("scan", "folded", "refolded", "quarantined", "model_fitted", "partitions", "rows",
              "sections_rendered"):
        assert sp[k] == sj[k], k
    # each side's own model: cutoffs within a few ulps, counts exact given them
    pm, jm = (os.path.join(batch_legs[t]["cfg"].state_dir, "drift_model") for t in ("port", "jax"))
    pb, jb = (pd.read_parquet(os.path.join(m, "attribute_binning", "part-00000.parquet")) for m in (pm, jm))
    assert list(pb["attribute"]) == list(jb["attribute"]) == ["a", "b"]
    base = pd.read_parquet(os.path.join(batch_legs["feed"], "day-01.parquet"))
    for c, gp, ep in zip(pb["attribute"], pb["parameters"], jb["parameters"]):
        gp, ep = np.asarray(gp, np.float32), np.asarray(ep, np.float32)
        assert np.all(np.abs(gp - ep) <= 4 * np.spacing(np.abs(ep).max())), (c, gp, ep)
        v = base[c].dropna().to_numpy(np.float32)
        for m, cuts in ((pm, gp), (jm, ep)):
            counts = np.bincount((v[:, None] > cuts[None, :]).sum(1), minlength=10)
            p_file = pd.read_csv(os.path.join(m, "frequency_counts", c, "part-00000.csv"))["p"].to_numpy()
            np.testing.assert_array_equal(np.round(p_file * len(base)), counts)
    for m in (pm, jm):
        cat = pd.read_csv(os.path.join(m, "frequency_counts", "cat", "part-00000.csv"), dtype=str)
        vc = base["cat"].value_counts()
        assert list(cat["cat"]) == sorted(vc.index)
        np.testing.assert_array_equal(np.round(cat["p"].astype(float).to_numpy() * len(base)),
                                      [vc[k] for k in sorted(vc.index)])


def test_drift_csv_and_alerts_equal_jax_on_one_model(tmp_path, batch_legs):
    """Both packages read the port's fitted model as ``model_path``: the
    drift CSVs are byte-equal and the alerts carry the same values."""
    from anovos_tpu.continuum import watcher as jw
    from anovos_tpu_torch.continuum import watcher as pw

    model = os.path.join(str(tmp_path), "shared_model")
    shutil.copytree(os.path.join(batch_legs["port"]["cfg"].state_dir, "drift_model"), model)
    alerts = {}
    for tag, mod, cfgf in (("port", pw, _cfg), ("jax", jw, _jcfg)):
        cfg = cfgf(str(tmp_path), tag, feed_dir=batch_legs["feed"], drift=False)
        cfg.drift = {"model_path": model, "threshold": 0.25}
        mod.step(cfg)
        with open(os.path.join(cfg.output_path, "obs", "continuum_alerts.jsonl")) as f:
            alerts[tag] = [{k: v for k, v in json.loads(line).items() if k not in ("t_unix", "flight")}
                           for line in f]
    outs = [os.path.join(str(tmp_path), t, "out", "continuum_drift.csv") for t in ("port", "jax")]
    with open(outs[0]) as a, open(outs[1]) as b:
        assert a.read() == b.read()
    assert alerts["port"] == alerts["jax"]
    assert any(a["kind"] == "drift" for a in alerts["port"])


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------
def test_report_bytes_equal_jax_given_the_same_frames(tmp_path, batch_legs):
    from anovos_tpu.data_report.continuum_report import render_report as jrender
    from anovos_tpu_torch.continuum.state import ContinuumState
    from anovos_tpu_torch.continuum.watcher import _finalize_artifacts
    from anovos_tpu_torch.data_report.continuum_report import render_report

    cfg = batch_legs["port"]["cfg"]
    ctx = cfg.fold_context()
    state = ContinuumState(cfg.state_dir, cfg.config_sig(), ctx)
    arts = _finalize_artifacts(cfg, state, ctx)
    feed = {"partitions": len(state.folded_keys()), "rows": state.total_rows()}
    outs = []
    for tag, fn in (("port", render_report), ("jax", jrender)):
        out = os.path.join(str(tmp_path), tag)
        res = fn(out, arts, quarantined=state.quarantined_parts(), feed=feed,
                 cache_dir=os.path.join(out, "sections"))
        with open(res["path"], "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    assert b"Degraded / Quarantined" in outs[0]


def test_report_rerenders_only_affected_sections(tmp_path):
    from anovos_tpu_torch.continuum.watcher import step

    feed = os.path.join(str(tmp_path), "feed")
    _write_feed(feed, {1: {}, 2: {}})
    cfg = _cfg(str(tmp_path), "t", feed_dir=feed, drift=False)
    s1 = step(cfg)
    assert "stats" in s1["sections_rendered"] and not s1["sections_reused"]
    _day_frame(np.random.default_rng(2), rows=100).to_parquet(os.path.join(feed, "day-03.parquet"), index=False)
    s2 = step(cfg)
    assert "missing" in s2["sections_reused"] and "stats" in s2["sections_rendered"]
    s3 = step(cfg)
    assert s3["folded"] == [] and s3["sections_rendered"] == []
    assert os.path.exists(os.path.join(cfg.output_path, "continuum_report.html"))
