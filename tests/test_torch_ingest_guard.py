"""The port's ingest guard (``anovos_tpu_torch/data_ingest/guard.py``)
against the JAX package's (``tests/test_ingest_guard.py``'s cases): the
same damaged part files go through both packages' ``read_dataset``.

Held equal: the quarantine records (file, error class, stage, rows lost,
whether estimated, byte offset, message) and the manifests on disk; the
Tables read from the surviving parts; the reconciled and sanitized frames
and their drift and sanitization counters; the degradation registry's
``ingest/<file>`` entry; and under ``ANOVOS_INGEST_ON_CORRUPT=raise`` or
with every part unreadable, both packages raise.  Knobs are set with
``monkeypatch.setenv`` only: both packages read them at call time.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)


@pytest.fixture(autouse=True)
def _fresh_guards(monkeypatch):
    """Empty quarantine registries, no chaos plan, fresh metrics and
    degradation registries in both packages; no retry (retries are
    exercised explicitly)."""
    from anovos_tpu.data_ingest import guard as jg
    from anovos_tpu.obs import get_metrics as jm
    from anovos_tpu.resilience import chaos as jc
    from anovos_tpu.resilience import policy as jp
    from anovos_tpu_torch.data_ingest import guard as pg
    from anovos_tpu_torch.obs import get_metrics as pm
    from anovos_tpu_torch.resilience import chaos as pc
    from anovos_tpu_torch.resilience import policy as pp

    monkeypatch.setenv("ANOVOS_INGEST_RETRIES", "0")
    for mod in (jg, pg, jc, pc):
        mod.reset()
    for p in (jp, pp):
        p.reset_degraded()
    jm().reset()
    pm().reset()
    yield
    for mod in (jg, pg, jc, pc):
        mod.reset()


def _both():
    from anovos_tpu.data_ingest import data_ingest as jdi
    from anovos_tpu.data_ingest import guard as jg
    from anovos_tpu_torch.data_ingest import data_ingest as pdi
    from anovos_tpu_torch.data_ingest import guard as pg

    return (("jax", jdi, jg), ("port", pdi, pg))


def _write_parts(d, nparts=4, rows=50, file_type="parquet"):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(11)
    paths = []
    for i in range(nparts):
        df = pd.DataFrame({"a": rng.normal(size=rows), "b": rng.integers(0, 9, rows).astype("int64"),
                           "c": rng.choice(["x", "y"], rows)})
        p = os.path.join(d, f"part-{i:05d}.{file_type}")
        if file_type == "parquet":
            df.to_parquet(p, index=False)
        elif file_type == "csv":
            df.to_csv(p, index=False)
        else:
            from anovos_tpu_torch.data_ingest.avro_io import write_avro

            write_avro(df, p)
        paths.append(p)
    return paths


def _records(g):
    return [r.to_json() for r in g.records()]


def _assert_tables_equal(pt, jt):
    assert pt.col_names == jt.col_names and pt.nrows == jt.nrows
    pd.testing.assert_frame_equal(pt.to_pandas(), jt.to_pandas())


def _damage(path: str, how: str) -> None:
    raw = open(path, "rb").read()
    if how == "truncate":
        raw = raw[: len(raw) - 100]  # the footer / last block is gone
    elif how == "magic":
        raw = raw[:-4] + b"XXXX"
    else:
        raw = b"not a data file at all"
    open(path, "wb").write(raw)


@pytest.mark.parametrize("file_type,how,part", [
    ("parquet", "truncate", 1),
    ("parquet", "magic", 2),
    ("parquet", "garbage", 0),
    ("csv", "garbage", 3),
    ("avro", "garbage", 1),
    ("avro", "truncate", 2),
])
def test_corrupt_part_quarantined_like_jax(tmp_path, file_type, how, part):
    """One damaged part among four: both packages quarantine it with the
    same record and manifest, and read the same Table from the others.
    An avro part cut 100 bytes short loses its one block without an error
    in both packages (the decoder stops at the end of the data): nothing
    is quarantined and its rows are missing (ROADMAP.md Queue C)."""
    paths = _write_parts(tmp_path / "d", file_type=file_type)
    _damage(paths[part], how)
    out = {}
    for name, di, g in _both():
        g.configure(str(tmp_path / name / "obs"))
        t = di.read_dataset(str(tmp_path / "d"), file_type)
        mp = g.manifest_path()
        out[name] = (t, _records(g), json.load(open(mp)) if os.path.exists(mp) else None)
    (pt, prec, pman), (jt, jrec, jman) = out["port"], out["jax"]
    _assert_tables_equal(pt, jt)
    assert pt.nrows == 3 * 50
    assert prec == jrec and pman == jman
    if (file_type, how) == ("avro", "truncate"):
        assert prec == [] and pman is None
    else:
        assert len(prec) == 1 and prec[0]["file"] == os.path.abspath(paths[part])
        assert pman["parts"] == 1


def test_undecodable_utf8_csv_quarantined_like_jax(tmp_path):
    """pyarrow types bad UTF-8 as binary: both readers raise the decode
    error (byte offset 0) and quarantine the part with an estimated
    two-row loss."""
    d = tmp_path / "csvs"
    d.mkdir()
    pd.DataFrame({"a": [1.0, 2.0], "s": ["ok", "fine"]}).to_csv(d / "part-00000.csv", index=False)
    with open(d / "part-00001.csv", "wb") as f:
        f.write(b"a,s\n3.0,\xff\xfe\x00garbage\n4.0,ok\n")
    pd.DataFrame({"a": [5.0], "s": ["last"]}).to_csv(d / "part-00002.csv", index=False)
    recs = {}
    for name, di, g in _both():
        t = di.read_dataset(str(d), "csv")
        assert t.nrows == 3
        recs[name] = _records(g)
    assert recs["port"] == recs["jax"]
    r = recs["port"][0]
    assert r["error_class"] == "UnicodeDecodeError" and r["byte_offset"] == 0
    assert r["rows_lost"] == 2 and r["rows_estimated"]


def test_degraded_registry_names_the_part(tmp_path):
    from anovos_tpu.resilience import degraded_sections as jdeg
    from anovos_tpu_torch.resilience import degraded_sections as pdeg

    paths = _write_parts(tmp_path / "d")
    open(paths[0], "wb").write(b"not parquet at all")
    for _name, di, _g in _both():
        di.read_dataset(str(tmp_path / "d"), "parquet")
    assert "ingest/part-00000.parquet" in pdeg()
    assert pdeg() == jdeg()


@pytest.mark.parametrize("spec,rows,retries", [
    ("corrupt@io:*part-00001.parquet", 4 * 50, "1"),       # one failure, the retry reads it
    ("truncate@io:*part-00001.parquet:n=99", 3 * 50, "1"),  # exhausts to quarantine, exact rows
    ("slowread@io:*part-00000.parquet:secs=0.05", 4 * 50, "0"),
])
def test_chaos_io_faults_match_jax(tmp_path, monkeypatch, spec, rows, retries):
    from anovos_tpu.obs import get_metrics as jm
    from anovos_tpu.resilience import chaos as jc
    from anovos_tpu_torch.obs import get_metrics as pm
    from anovos_tpu_torch.resilience import chaos as pc

    monkeypatch.setenv("ANOVOS_INGEST_RETRIES", retries)
    _write_parts(tmp_path / "d")
    out = {}
    for (name, di, g), chaos, metrics in zip(_both(), (jc, pc), (jm, pm)):
        chaos.install(spec)
        t = di.read_dataset(str(tmp_path / "d"), "parquet")
        out[name] = (t, _records(g), chaos.plan().injection_count(),
                     metrics().counter("ingest_retries_total").value())
    (pt, prec, pinj, pret), (jt, jrec, jinj, jret) = out["port"], out["jax"]
    _assert_tables_equal(pt, jt)
    assert pt.nrows == rows
    assert prec == jrec and (pinj, pret) == (jinj, jret)
    if "truncate" in spec:
        assert prec[0]["error_class"] == "ChaosTruncate" and prec[0]["rows_lost"] == 50
        assert not prec[0]["rows_estimated"]


def test_all_parts_quarantined_raises_in_both(tmp_path):
    paths = _write_parts(tmp_path / "d", nparts=2)
    for p in paths:
        open(p, "wb").write(b"garbage")
    for _name, di, g in _both():
        with pytest.raises(g.IngestError, match="quarantined"):
            di.read_dataset(str(tmp_path / "d"), "parquet")


@pytest.mark.parametrize("file_type", ["parquet", "csv", "avro"])
def test_on_corrupt_raise_restores_fail_fast_in_both(tmp_path, monkeypatch, file_type):
    monkeypatch.setenv("ANOVOS_INGEST_ON_CORRUPT", "raise")
    paths = _write_parts(tmp_path / "d", file_type=file_type)
    open(paths[1], "wb").write(b"garbage")
    for _name, di, g in _both():
        with pytest.raises(g.IngestError, match="part read failed"):
            di.read_dataset(str(tmp_path / "d"), file_type)
        assert g.records() == []


def _drifted_dir(tmp_path):
    d = tmp_path / "drift"
    d.mkdir()
    pd.DataFrame({"a": np.array([1, 2, 3], dtype="int64"), "b": [1.5, 2.5, 3.5],
                  "c": ["x", "y", "z"]}).to_parquet(d / "part-00000.parquet", index=False)
    pd.DataFrame({"a": [4.25, 5.25], "c": ["w", "v"], "d": ["extra", "extra"]}).to_parquet(
        d / "part-00001.parquet", index=False)
    return d


def test_schema_drift_reconciled_like_jax(tmp_path):
    """A widened column, a missing one and an extra one: the same Table and
    the same drift counters in both packages."""
    from anovos_tpu.obs import get_metrics as jm
    from anovos_tpu_torch.obs import get_metrics as pm

    d = _drifted_dir(tmp_path)
    tables = {name: di.read_dataset(str(d), "parquet") for name, di, _g in _both()}
    _assert_tables_equal(tables["port"], tables["jax"])
    assert tables["port"].col_names == ["a", "b", "c"]
    for kind in ("missing_col", "extra_col", "widened"):
        assert pm().counter("ingest_schema_drift_total").value(kind=kind) == \
            jm().counter("ingest_schema_drift_total").value(kind=kind) == 1


def test_schema_drift_strict_raises_in_both(tmp_path, monkeypatch):
    monkeypatch.setenv("ANOVOS_INGEST_SCHEMA_DRIFT", "strict")
    d = _drifted_dir(tmp_path)
    for _name, di, g in _both():
        with pytest.raises(g.IngestError, match="schema drift"):
            di.read_dataset(str(d), "parquet")


@pytest.mark.parametrize("frames", [
    ([1.0, 2.0], ["3.5", "junk"]),                            # numeric reference, string part
    (["00501", "00502"], np.array([501, 502], dtype="int64")),  # string reference, numeric part
    ([1, 2], [3.5, None]),                                     # int reference, float part
])
def test_reconcile_frames_match_jax(frames):
    from anovos_tpu.data_ingest import guard as jg
    from anovos_tpu_torch.data_ingest import guard as pg

    ref, drifted = frames
    parts = [("p0", pd.DataFrame({"v": ref})), ("p1", pd.DataFrame({"v": drifted}))]
    got = pd.concat(pg.reconcile_frames(parts), ignore_index=True)
    exp = pd.concat(jg.reconcile_frames(parts), ignore_index=True)
    pd.testing.assert_frame_equal(got, exp)


@pytest.mark.parametrize("mode", ["mask", "clip", "keep"])
def test_sanitize_frame_matches_jax(mode, monkeypatch):
    from anovos_tpu.data_ingest import guard as jg
    from anovos_tpu.obs import get_metrics as jm
    from anovos_tpu_torch.data_ingest import guard as pg
    from anovos_tpu_torch.obs import get_metrics as pm

    monkeypatch.setenv("ANOVOS_INGEST_SANITIZE", mode)
    df = pd.DataFrame({"v": [1.0, np.inf, -np.inf, np.nan, 1e39, -1e39, 2.0], "clean": np.arange(7.0)})
    got, exp = pg.sanitize_frame(df.copy()), jg.sanitize_frame(df.copy())
    pd.testing.assert_frame_equal(got, exp)
    assert pm().snapshot() == jm().snapshot()
    if mode == "mask":
        assert got["v"].notna().sum() == 2


def test_storm_read_like_jax(tmp_path):
    """±inf and f32 overflow through read_dataset: nulled in both, the
    same Table."""
    d = tmp_path / "storm"
    d.mkdir()
    pd.DataFrame({"v": [1.0, np.inf, -np.inf, np.nan, 1e39, -1e39, 2.0],
                  "clean": np.arange(7.0)}).to_parquet(d / "part-00000.parquet", index=False)
    tables = {name: di.read_dataset(str(d), "parquet") for name, di, _g in _both()}
    _assert_tables_equal(tables["port"], tables["jax"])
    assert tables["port"].to_pandas()["v"].notna().sum() == 2


def test_clean_input_is_untouched(tmp_path, monkeypatch):
    """On clean parts every layer is a no-op: the guarded read equals the
    fail-fast, strict, keep read, and nothing is quarantined."""
    from anovos_tpu_torch.data_ingest import data_ingest as pdi
    from anovos_tpu_torch.data_ingest import guard as pg

    _write_parts(tmp_path / "clean", nparts=3)
    guarded = pdi.read_dataset(str(tmp_path / "clean"), "parquet").to_pandas()
    monkeypatch.setenv("ANOVOS_INGEST_ON_CORRUPT", "raise")
    monkeypatch.setenv("ANOVOS_INGEST_SCHEMA_DRIFT", "strict")
    monkeypatch.setenv("ANOVOS_INGEST_SANITIZE", "keep")
    pd.testing.assert_frame_equal(guarded, pdi.read_dataset(str(tmp_path / "clean"), "parquet").to_pandas())
    assert pg.records() == []


def test_policy_and_backoff_match_jax(monkeypatch):
    """The env policy, ``parse_policy`` and the deterministic backoff of
    both packages agree."""
    from anovos_tpu.data_ingest import guard as jg
    from anovos_tpu.resilience import policy as jp
    from anovos_tpu_torch.data_ingest import guard as pg
    from anovos_tpu_torch.resilience import policy as pp

    monkeypatch.setenv("ANOVOS_INGEST_RETRIES", "3")
    monkeypatch.setenv("ANOVOS_INGEST_SANITIZE", "clip")
    import dataclasses

    assert dataclasses.asdict(pg.policy_from_env()) == dataclasses.asdict(jg.policy_from_env())
    for spec in ("raise", "continue", "retry:2", "retry:3:degrade", "retry:1:continue"):
        assert pp.parse_policy(spec).describe() == jp.parse_policy(spec).describe()
        for attempt in range(1, 5):
            assert pp.backoff_delay("part-00001.parquet", attempt, pp.parse_policy(spec)) == \
                jp.backoff_delay("part-00001.parquet", attempt, jp.parse_policy(spec))
    for bad in ("retry", "retry:x", "sometimes"):
        with pytest.raises(ValueError):
            pp.parse_policy(bad)


@pytest.mark.parametrize("spec", [
    "seed=7;corrupt@io:*part-0000[13].parquet:n=2;slowread@io:*:secs=0:p=0.5",
    "truncate@io:/data/*:n=3;exc@node:stats_generator/*",
])
def test_chaos_plan_fires_like_jax(spec):
    """The same spec claims the same directives at the same visits in both
    packages (seeded, hash-keyed coin flips)."""
    from anovos_tpu.resilience.chaos import ChaosPlan as JPlan
    from anovos_tpu_torch.resilience.chaos import ChaosPlan as PPlan

    jp, pp = JPlan(spec), PPlan(spec)
    sites = [f"io:/data/part-{i % 5:05d}.parquet" for i in range(20)] + ["node:stats_generator/x"]
    for site in sites:
        assert [d.describe() for d in pp.claim(site)] == [d.describe() for d in jp.claim(site)]
    assert pp.summary() == jp.summary()
