"""The port's entry point, ``python -m anovos_tpu_torch <config.yaml>
[run_type] [auth_key_json]``, and the runner's guards: the usage line,
``--resume`` refused, the blocks not ported yet refused before any work,
a geospatial name in a transformers block raising AttributeError as in the
JAX runner, the device never falling back to the CPU, and ``anovos_tpu_torch.workflow``
importable without a YAML reader.  Also ``chip_smoke.py``'s copy of
``config/configs_basic.yaml`` held equal to the file.
"""

import os
import subprocess
import sys

import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)
from test_torch_workflow import basic_config, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(*args, cwd=REPO, code=""):
    """``python -m anovos_tpu_torch args`` (or ``python -c code``) with
    the repo importable and no CUDA device visible."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-c", code] if code else [sys.executable, "-m", "anovos_tpu_torch", *args]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_no_argument_prints_the_usage_line():
    res = run_cli()
    assert res.returncode == 1
    assert "usage: python -m anovos_tpu_torch <config.yaml> [run_type] [auth_key_json]" in res.stderr


def test_resume_is_refused():
    res = run_cli("config/configs_basic.yaml", "local", "--resume")
    assert res.returncode == 1
    assert "--resume" in res.stderr and "Queue A item 4" in res.stderr


@pytest.mark.parametrize("argv,expected", [
    (["c.yaml"], ("c.yaml", "local", {})),
    (["c.yaml", "emr"], ("c.yaml", "emr", {})),
    (["c.yaml", "ak8s", '{"fs.azure.sas": "?sv=x"}'], ("c.yaml", "ak8s", {"fs.azure.sas": "?sv=x"})),
    (["c.yaml", "ak8s", "bare-token"], ("c.yaml", "ak8s", {"auth_key": "bare-token"})),
    (["c.yaml", "ak8s", "5"], ("c.yaml", "ak8s", {"auth_key": "5"})),
])
def test_arguments_parse_as_main_py_parses_them(argv, expected):
    """A JSON auth dict is taken as it is; anything else is wrapped."""
    from anovos_tpu_torch.__main__ import parse_args

    assert parse_args(["prog", *argv]) == expected


def test_cli_runs_on_the_card_and_never_falls_back(tmp_path):
    """Without a CUDA device the entry point raises instead of running on
    the CPU (it has no device flag, as the JAX CLI has none)."""
    import yaml

    data = tmp_path / "data"
    data.mkdir()
    pd.DataFrame({"a": [1.0, 2.0], "b": ["x", "y"]}).to_parquet(data / "part-00000.parquet")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({"input_dataset": {"read_dataset": {
        "file_path": str(data), "file_type": "parquet"}}}))
    res = run_cli(str(cfg), "local", cwd=str(tmp_path))
    assert res.returncode != 0
    assert "CUDA device requested" in res.stderr


@pytest.mark.parametrize("block,item", [("streaming_analysis", "Queue A item 4"),
                                        ("continuous_analysis", "Queue A item 4"),
                                        ("streaming_analysis", "transformers"),
                                        ("continuous_analysis", "write_feast_features")])
def test_unported_blocks_raise_before_any_work(block, item):
    """The config's input path does not exist: the refusal comes first,
    also before a transformers step naming a function the port's
    transformers module lacks (which raises AttributeError when it runs)
    and before write_feast_features' config check (no write_main here)."""
    from anovos_tpu_torch import workflow

    cfg = load_config("configs_full.yaml")
    cfg.pop("transformers")
    cfg[block] = {"anything": {}}
    if item == "transformers":
        cfg[item] = {"geo": {"location_distance": {}}}
    elif item == "write_feast_features":
        cfg.pop("write_main")
        cfg[item] = {"file_path": "feast_repo/"}
    with pytest.raises(NotImplementedError, match=f"{block}.*Queue A item 4"):
        workflow.main(cfg, "local")


def test_basic_report_skips_the_analytics_blocks():
    """With basic_report true the later analytics keys are skipped, so the
    streaming blocks are not refused there; without it they are.
    A geospatial function in a transformers block and write_feast_features
    pass the check in both modes: the runner resolves the first by getattr
    when it runs, and runs the second."""
    from anovos_tpu_torch.workflow import NOT_PORTED, _check_ported

    assert set(NOT_PORTED) == {"streaming_analysis", "continuous_analysis"}
    cfg = load_config("configs_full.yaml")
    cfg["transformers"]["geo"] = {"geo_format_latlon": {"list_of_lat": "latitude"}}
    cfg["write_feast_features"] = load_config("configs_feast.yaml")["write_feast_features"]
    for basic in (False, True):
        _check_ported(cfg, basic_report=basic)
    cfg["streaming_analysis"] = {"stats": True}
    _check_ported(cfg, basic_report=True)
    with pytest.raises(NotImplementedError, match="streaming_analysis"):
        _check_ported(cfg, basic_report=False)


def test_geospatial_transformer_names_raise_attribute_error_in_both_runners(tmp_path):
    """A transformers step naming ``location_distance`` (a function of
    data_transformer.geospatial, not of data_transformer.transformers)
    raises AttributeError in both runners, which resolve it by getattr."""
    from anovos_tpu import workflow as jwf
    from anovos_tpu_torch import workflow as pwf

    data = tmp_path / "data"
    data.mkdir()
    pd.DataFrame({"lat1": [1.0, 2.0], "lon1": [3.0, 4.0], "lat2": [1.5, 2.5],
                  "lon2": [3.5, 4.5]}).to_parquet(data / "part-00000.parquet")
    cfg = {"input_dataset": {"read_dataset": {"file_path": str(data), "file_type": "parquet"}},
           "transformers": {"geo": {"location_distance": {"list_of_lat": ["lat1", "lat2"],
                                                          "list_of_lon": ["lon1", "lon2"]}}}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
        mp.chdir(tmp_path)
        for wf in (pwf, jwf):
            with pytest.raises(AttributeError, match="location_distance"):
                wf.main(cfg, "local")


def test_workflow_imports_without_a_yaml_reader():
    res = run_cli(code="import sys; sys.modules['yaml'] = None; "
                       "import anovos_tpu_torch.workflow, anovos_tpu_torch.__main__; print('ok')")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_runs_the_basic_config():
    """chip_smoke.py keeps its own copy of config/configs_basic.yaml (the
    GPU machine may lack a YAML reader): after the same path substitution
    it is the file's, in the file's order."""
    import chip_smoke

    got = chip_smoke.basic_config("/data/main", "/data/join")
    exp = basic_config("/data/main", "/data/join")
    assert got == exp and list(got) == list(exp)


def test_chip_smoke_runs_the_full_config():
    """chip_smoke.py's copy of config/configs_full.yaml (phase 10d): after
    the same substitution (the input and drift source, the four stability
    datasets, the two dictionaries set to NA) it is the file's, blocks and
    transformer steps in the file's order."""
    import chip_smoke

    si = [f"/data/si{i}" for i in range(4)]
    got = chip_smoke.full_config("/data/main", si)
    exp = load_config("configs_full.yaml")
    exp["input_dataset"]["read_dataset"]["file_path"] = "/data/main"
    drift = exp["drift_detector"]
    drift["drift_statistics"]["source_dataset"]["read_dataset"]["file_path"] = "/data/main"
    for i, d in enumerate(si):
        drift["stability_index"][f"dataset{i + 1}"]["read_dataset"]["file_path"] = d
    exp["report_generation"]["dataDict_path"] = "NA"
    exp["report_generation"]["metricDict_path"] = "NA"
    assert got == exp and list(got) == list(exp)
    assert [list(g) for g in got["transformers"].values()] == [list(g) for g in exp["transformers"].values()]
