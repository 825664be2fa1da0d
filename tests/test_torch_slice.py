"""The port's whole first slice — read_dataset → stats_generator → drift
statistics → stability_index_computation — against the JAX package's on
one parquet dataset, and the rule that the port never imports JAX or the
JAX package."""

import ast
import os
import pathlib
import re

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_frames_close, torch_cpu_runtime  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
DROP = ["ifa", "dt_1", "dt_2", "empty", "logfnl"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from examples._data import synthesize

    d = tmp_path_factory.mktemp("income") / "parquet"
    d.mkdir()
    df = synthesize(20000)
    df.iloc[:12000].to_parquet(d / "part-00000.parquet", index=False)
    df.iloc[12000:].to_parquet(d / "part-00001.parquet", index=False)
    return str(d)


def test_whole_slice_matches_jax(dataset, tmp_path):
    from anovos_tpu.data_analyzer import stats_generator as jsg
    from anovos_tpu.data_ingest.data_ingest import delete_column as jdel
    from anovos_tpu.data_ingest.data_ingest import read_dataset as jread
    from anovos_tpu.drift_stability import stability_index_computation as jsi
    from anovos_tpu.drift_stability import statistics as jstat
    from anovos_tpu_torch.data_analyzer import stats_generator as psg
    from anovos_tpu_torch.data_ingest.data_ingest import delete_column, read_dataset
    from anovos_tpu_torch.drift_stability import stability_index_computation, statistics

    pt = delete_column(read_dataset(dataset, "parquet"), DROP)
    jt = jdel(jread(dataset, "parquet"), DROP)
    assert pt.col_names == jt.col_names and pt.dtypes() == jt.dtypes()
    n = pt.nrows

    for fn in ("global_summary", "measures_of_counts", "measures_of_cardinality",
               "measures_of_percentiles", "mode_computation"):
        exp = getattr(jsg, fn)(jt)
        assert_frames_close(getattr(psg, fn)(pt), exp, exact_cols=list(exp.columns))
    for fn in ("measures_of_centralTendency", "measures_of_dispersion", "measures_of_shape"):
        got, exp = getattr(psg, fn)(pt), getattr(jsg, fn)(jt)
        # f32 moments rounded to 4 decimals: see tests/test_torch_stats.py
        assert_frames_close(got, exp, rtol=1e-6, atol=3e-4)

    half = n // 2
    drift_p = statistics(pt.slice_rows(half, n), pt.slice_rows(0, half), method_type="all",
                         bin_size=10, use_sampling=False, source_path=str(tmp_path / "p"))
    drift_j = jstat(jt.gather_rows(np.arange(half, n)), jt.gather_rows(np.arange(half)),
                    method_type="all", bin_size=10, use_sampling=False,
                    source_path=str(tmp_path / "j"))
    assert list(drift_p["attribute"]) == list(drift_j["attribute"])
    assert list(drift_p["flagged"]) == list(drift_j["flagged"])
    for m in ("PSI", "HD", "JSD", "KS"):
        np.testing.assert_allclose(drift_p[m], drift_j[m], rtol=0, atol=1e-4, err_msg=m)

    thirds = [(i * n // 3, (i + 1) * n // 3) for i in range(3)]
    si_p = stability_index_computation(*[pt.slice_rows(a, b) for a, b in thirds])
    si_j = jsi(*[jt.gather_rows(np.arange(a, b)) for a, b in thirds])
    assert list(si_p["attribute"]) == list(si_j["attribute"])
    assert list(si_p["stability_index"].fillna(-1)) == list(si_j["stability_index"].fillna(-1))


def test_read_dataset_csv_matches_jax(tmp_path):
    from examples._data import synthesize
    from anovos_tpu.data_ingest.data_ingest import read_dataset as jread
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset

    df = synthesize(3000, seed=9).drop(columns=["empty"])
    df.loc[::5, "capital-gain"] = np.inf
    df.to_csv(tmp_path / "part-00000.csv", index=False)
    got = read_dataset(str(tmp_path), "csv").to_pandas()
    exp = jread(str(tmp_path), "csv").to_pandas()
    pd.testing.assert_frame_equal(got, exp)
    assert got["capital-gain"].isna().sum() >= 600  # ±inf became null
    with pytest.raises(ValueError, match="unsupported file_type"):
        read_dataset(str(tmp_path), "orc")


@pytest.mark.parametrize("casts", [
    ("age|fnlwgt", "int|float"),
    ("education-num|race", "string|string"),
    ("latitude", "bigint"),
    ("label", "double"),
])
def test_column_ops_match_jax(casts):
    from examples._data import synthesize
    from anovos_tpu.data_ingest import data_ingest as jdi
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.data_ingest import data_ingest as pdi
    from anovos_tpu_torch.shared.table import Table

    df = synthesize(2000, seed=4).drop(columns=["ifa"])
    df["num_str"] = [str(i % 13) for i in range(len(df))]
    pt, jt = Table.from_pandas(df, device="cpu"), JTable.from_pandas(df)
    cols, dts = casts
    got = pdi.recast_column(pdi.rename_column(pdi.select_column(pt, "all"), "race", "race2"),
                            cols.replace("race", "race2"), dts)
    exp = jdi.recast_column(jdi.rename_column(jdi.select_column(jt, "all"), "race", "race2"),
                            cols.replace("race", "race2"), dts)
    assert got.dtypes() == exp.dtypes()
    pd.testing.assert_frame_equal(got.to_pandas(), exp.to_pandas())
    got2 = pdi.recast_column(pdi.delete_column(got, "dt_1|dt_2"), "num_str", "int")
    exp2 = jdi.recast_column(jdi.delete_column(exp, "dt_1|dt_2"), "num_str", "int")
    pd.testing.assert_frame_equal(got2.to_pandas(), exp2.to_pandas())


def _port_sources():
    files = sorted((REPO / "anovos_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


# a path component naming the JAX package or its C++ library: "native/...",
# ".../anovos_tpu/...", or the bare directory names a join would take
_JAX_PATH = re.compile(r"(^|[/\\])(native|anovos_tpu)([/\\]|$)")
# "anovos_tpu/ops/pallas_kernels.py:149": a file:line reference the port
# reports, never a path it opens
_FILE_LINE = re.compile(r"\.py:\d+$")


def _violations(source: str, where: str) -> list:
    """Imports of jax, jaxlib or anovos_tpu, and string constants other
    than docstrings that name a path under ``native/`` or ``anovos_tpu/``."""
    tree = ast.parse(source, filename=where)
    docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                  if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
                  and node.body and isinstance(node.body[0], ast.Expr)
                  and isinstance(node.body[0].value, ast.Constant)}
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docstrings and _JAX_PATH.search(node.value)
                    and not _FILE_LINE.search(node.value)):
                bad.append(f"{where}:{node.lineno} names the path {node.value!r}")
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "anovos_tpu"):
                bad.append(f"{where}:{node.lineno} imports {name}")
    return bad


def test_port_never_imports_jax_or_the_jax_package():
    """No source of the port imports JAX or the JAX package, or names a
    path under ``native/`` or ``anovos_tpu/`` (it keeps its own copy of the
    C++ codec)."""
    bad = []
    for f in _port_sources():
        bad += _violations(f.read_text(), str(f.relative_to(REPO)))
    assert len(_port_sources()) > 20
    assert {"avro_io.py", "data_sampling.py", "native.py", "quality_checker.py", "sampling.py",
            "transformers.py", "geospatial.py", "geo_kernels.py", "geo_utils.py", "feast_exporter.py",
            "feature_retrieval.py"} <= {f.name for f in _port_sources()}
    # the streaming slice: each module on the out-of-core path
    rel = {str(f.relative_to(REPO)) for f in _port_sources()}
    assert {f"anovos_tpu_torch/{m}.py" for m in (
        "resilience/policy", "resilience/chaos", "obs/metrics", "cache/fingerprint", "cache/journal",
        "data_ingest/guard", "data_ingest/prefetch", "ops/streaming")} <= rel
    # the continuum slice, with the host modules it keeps its own copy of
    assert {f"anovos_tpu_torch/{m}.py" for m in (
        "continuum/__init__", "continuum/__main__", "continuum/sufficient", "continuum/state",
        "continuum/alerts", "continuum/watcher", "data_report/continuum_report", "cache/store",
        "obs/flight", "obs/telemetry")} <= rel
    # the scheduler slice: the executor, the async writer's module and the
    # feature recommender (the corpus is the port's own copy)
    assert {f"anovos_tpu_torch/{m}.py" for m in (
        "parallel/__init__", "parallel/placement", "parallel/scheduler", "shared/artifact_store",
        "workflow", "feature_recommender/__init__", "feature_recommender/featrec_init",
        "feature_recommender/feature_explorer", "feature_recommender/feature_mapper")} <= rel
    # the run-record slice: the tracer, @timed, devprof, the manifest and
    # the version the manifest records
    assert {f"anovos_tpu_torch/{m}.py" for m in (
        "obs/__init__", "obs/tracing", "obs/timed", "obs/devprof", "obs/manifest", "version")} <= rel
    assert (REPO / "anovos_tpu_torch" / "feature_recommender" / "data" / "corpus.jsonl").is_file()
    assert (REPO / "anovos_tpu_torch" / "shared" / "csrc" / "anovos_native.cpp").is_file()
    assert not bad, bad


@pytest.mark.parametrize("line,caught", [
    ("import jax.numpy as jnp", True),
    ("from anovos_tpu.shared import native", True),
    ("SRC = os.path.join(ROOT, 'native', 'anovos_native.cpp')", True),
    ("SRC = ROOT / 'native/anovos_native.cpp'", True),
    ("open(REPO + '/anovos_tpu/data_ingest/avro_io.py')", True),
    ("BUILD = ROOT / 'anovos_tpu'", True),
    ("REPLACES = 'anovos_tpu/ops/pallas_kernels.py:149'", False),
    ("SRC = ROOT / 'anovos_tpu_torch/shared/csrc/anovos_native.cpp'", False),
    ("MODE = 'native_avro_decode'", False),
    ("def f():\n    'reads like anovos_tpu/shared/native.py'", False),
])
def test_source_rule_catches_jax_paths(line, caught):
    assert bool(_violations(line, "probe.py")) is caught


def test_chip_smoke_last_line_names_the_card():
    """``chip_smoke.py``'s last line: ``kind`` is the card's name and
    ``count`` the number of cards, read from torch when it is printed."""
    import json
    import types

    import chip_smoke

    cuda = types.SimpleNamespace(get_device_name=lambda i: f"card {i}", device_count=lambda: 1)
    line = json.loads(chip_smoke.result_line(types.SimpleNamespace(cuda=cuda)))
    assert line == {"ok": True, "device": {"platform": "gpu", "kind": "card 0", "count": 1}}
