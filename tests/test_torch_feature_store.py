"""The port's Feast export (``anovos_tpu_torch/feature_store/``) against
the JAX package's: the generated ``anovos.py`` byte for byte, the config
check's errors, the two timestamp columns, and the retrieval module's
import gate (``feast`` is absent in both environments)."""

import copy
import datetime
import sys

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)

FEAST = {
    "file_path": "feast_repo/",
    "entity": {"name": "income", "description": "income data", "id_col": "ifa"},
    "file_source": {"description": "data source description", "owner": "me@business.com",
                    "timestamp_col": "event_time", "create_timestamp_col": "create_time_col"},
    "feature_view": {"name": "income_view", "owner": "view@owner.com", "ttl_in_seconds": 3600000,
                     "create_timestamps": True},
    "service_name": "income_feature_service",
}
TYPES = [("ifa", "string"), ("age", "float"), ("fnlwgt", "int"), ("big", "bigint"), ("income", "double"),
         ("flag", "boolean"), ("dt_1", "timestamp"), ("odd", "decimal"), ("event_time", "timestamp"),
         ("create_time_col", "timestamp")]


@pytest.mark.parametrize("service", [True, False])
def test_repo_file_bytes_equal_jax(tmp_path, service):
    """``anovos.py`` from the same dtypes and config, with and without a
    feature service; it compiles."""
    from anovos_tpu.feature_store import feast_exporter as jfe
    from anovos_tpu_torch.feature_store import feast_exporter

    cfg = copy.deepcopy(FEAST)
    if not service:
        cfg.pop("service_name")
    out = {}
    for name, mod in (("port", feast_exporter), ("jax", jfe)):
        c = dict(cfg, file_path=str(tmp_path / name))
        path = mod.generate_feature_description(TYPES, c, "output/final_dataset/part-00000.parquet")
        with open(path, "rb") as f:
            out[name] = f.read()
    assert out["port"] == out["jax"]
    text = out["port"].decode()
    compile(text, "anovos.py", "exec")
    assert ('Field(name="age", dtype=Float32)' in text and 'Field(name="ifa"' not in text
            and ("FeatureService(" in text) == service)


def test_generators_and_mapping_equal_jax():
    from anovos_tpu.feature_store import feast_exporter as jfe
    from anovos_tpu_torch.feature_store import feast_exporter as fe

    assert fe.dataframe_to_feast_type_mapping == jfe.dataframe_to_feast_type_mapping
    assert fe.generate_prefix() == jfe.generate_prefix()
    assert fe.generate_entity_definition(FEAST["entity"]) == jfe.generate_entity_definition(FEAST["entity"])
    assert fe.generate_file_source(FEAST["file_source"]) == jfe.generate_file_source(FEAST["file_source"])
    assert fe.generate_fields(TYPES, ["ifa"]) == jfe.generate_fields(TYPES, ["ifa"])
    assert fe.generate_feature_service("s", "v") == jfe.generate_feature_service("s", "v")
    assert fe.generate_feature_view(TYPES, [], FEAST["feature_view"], "income") == \
        jfe.generate_feature_view(TYPES, [], FEAST["feature_view"], "income")


@pytest.mark.parametrize("drop,repartition", [(None, 1), (None, -1), (None, 2), ("entity", 1),
                                              ("file_path", 1), ("file_source", 1), ("feature_view", 1)])
def test_config_check_raises_as_jax_does(drop, repartition):
    from anovos_tpu.feature_store import feast_exporter as jfe
    from anovos_tpu_torch.feature_store import feast_exporter as fe

    cfg = {k: v for k, v in FEAST.items() if k != drop}
    errs = []
    for mod in (fe, jfe):
        try:
            mod.check_feast_configuration(cfg, repartition)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    assert (errs[0] is None) == (drop is None and repartition == 1)


def test_timestamp_columns_match_jax():
    """Both columns are timestamps of now, to the second; the other
    columns untouched."""
    from anovos_tpu.feature_store import feast_exporter as jfe
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.feature_store import feast_exporter as fe
    from anovos_tpu_torch.shared.table import Table

    df = pd.DataFrame({"ifa": ["a", "b", None], "x": [1.5, np.nan, 3.0]})
    before = pd.Timestamp(datetime.datetime.now()).floor("s")
    got = fe.add_timestamp_columns(Table.from_pandas(df, device="cpu"), FEAST["file_source"])
    exp = jfe.add_timestamp_columns(JTable.from_pandas(df), FEAST["file_source"])
    after = pd.Timestamp(datetime.datetime.now())
    assert got.col_names == exp.col_names == ["ifa", "x", "event_time", "create_time_col"]
    assert got.dtypes() == exp.dtypes()
    g, e = got.to_pandas(), exp.to_pandas()
    pd.testing.assert_frame_equal(g[["ifa", "x"]], e[["ifa", "x"]])
    for c in ("event_time", "create_time_col"):
        assert g[c].between(before, after).all() and e[c].between(before, after).all(), c
        assert g[c].nunique() == 1 and not g[c].isna().any()


def test_retrieval_gate_raises_as_jax_does(monkeypatch):
    """Without feast a retrieval raises ImportError in both packages, after
    the same argument check; the entity frame is the same but for now."""
    from anovos_tpu.feature_store import feature_retrieval as jfr
    from anovos_tpu_torch.feature_store import feature_retrieval as fr

    monkeypatch.setitem(sys.modules, "feast", None)
    frame = fr.build_entity_frame()
    jframe = jfr.build_entity_frame()
    assert list(frame.columns) == list(jframe.columns) == ["ifa", "event_timestamp"]
    assert list(frame["ifa"]) == list(jframe["ifa"]) == jfr.DEMO_ENTITY_IDS
    assert fr.DEMO_FEATURES == jfr.DEMO_FEATURES
    for mod in (fr, jfr):
        with pytest.raises(ValueError, match="features list or a feature_service"):
            mod.retrieve_historical_features("repo", frame)
        with pytest.raises(ImportError, match="feast is required"):
            mod.retrieve_historical_features("repo", frame, features=mod.DEMO_FEATURES)
        with pytest.raises(ImportError, match="feast is required"):
            mod.retrieve_historical_feature_demo("repo")
