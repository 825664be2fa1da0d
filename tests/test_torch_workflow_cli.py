"""The port's entry point, ``python -m anovos_tpu_torch <config.yaml>
[run_type] [auth_key_json] [--resume]``, and the runner's guards: the
usage line, ``--resume`` accepted, a missing input stopping a run before any
work in both runners, the analytics blocks (``continuous_analysis`` among
them) skipped under ``basic_report`` as the JAX runner skips them, a
geospatial name in a transformers block raising AttributeError as in the
JAX runner, the device never falling back to the CPU, and ``anovos_tpu_torch.workflow``
importable without a YAML reader.  Every knob of a layer the port does not
have yet (``obs/telemetry.UNPORTED_KNOBS``) and a chaos ``wedge`` make
``workflow.main`` and ``workflow.run`` raise before any work, naming the
ROADMAP.md item, and the four knobs of the run record work
(``ANOVOS_TPU_TRACE``, ``ANOVOS_TPU_TRACE_BUFFER``, ``ANOVOS_PROFILE``,
``ANOVOS_TPU_DEVPROF``).  Also ``chip_smoke.py``'s copy of
``config/configs_basic.yaml`` held equal to the file.
"""

import os
import subprocess
import sys

import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)
from anovos_tpu_torch.obs.telemetry import UNPORTED_KNOBS
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
    assert ("usage: python -m anovos_tpu_torch <config.yaml> [run_type] [auth_key_json] [--resume]"
            in res.stderr)
    assert run_cli("--resume").returncode == 1  # --resume alone is no config


def test_resume_is_refused():
    """``--resume`` is no longer refused (the streaming passes resume from
    their chunk checkpoints): the run starts, logs the JAX runner's
    warning that no node cache backs the other blocks, and stops where any
    run of this config does here, at its absent input."""
    res = run_cli("config/configs_basic.yaml", "local", "--resume")
    assert res.returncode != 0
    assert "Queue A item" not in res.stderr
    assert "--resume requested but ANOVOS_TPU_CACHE is unset" in res.stderr
    assert "FileNotFoundError: no parquet files" in res.stderr


@pytest.mark.parametrize("argv,expected", [
    (["c.yaml"], ("c.yaml", "local", {}, False)),
    (["c.yaml", "emr"], ("c.yaml", "emr", {}, False)),
    (["c.yaml", "ak8s", '{"fs.azure.sas": "?sv=x"}'], ("c.yaml", "ak8s", {"fs.azure.sas": "?sv=x"}, False)),
    (["c.yaml", "ak8s", "bare-token"], ("c.yaml", "ak8s", {"auth_key": "bare-token"}, False)),
    (["c.yaml", "ak8s", "5"], ("c.yaml", "ak8s", {"auth_key": "5"}, False)),
])
def test_arguments_parse_as_main_py_parses_them(argv, expected):
    """A JSON auth dict is taken as it is; anything else is wrapped.  The
    fourth field is ``--resume``, which may stand anywhere after the
    program, as ``anovos_tpu/__main__.py`` takes it."""
    from anovos_tpu_torch.__main__ import parse_args

    assert parse_args(["prog", *argv]) == expected
    for at in range(1, len(argv) + 2):
        with_resume = ["prog", *argv[:at - 1], "--resume", *argv[at - 1:]]
        assert parse_args(with_resume) == expected[:3] + (True,)


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
def test_unported_blocks_raise_before_any_work(block, item, tmp_path, monkeypatch):
    """The config's input path does not exist.  Every block of the JAX
    runner is ported, streaming_analysis and continuous_analysis among
    them, so neither is refused: each run reaches the missing input first,
    before a transformers step naming a function the port's transformers
    module lacks (which raises AttributeError when it runs) and before
    write_feast_features' config check (no write_main here), and the JAX
    runner stops there with the same error class."""
    from anovos_tpu import workflow as jwf
    from anovos_tpu_torch import workflow

    cfg = load_config("configs_full.yaml")
    cfg.pop("transformers")
    cfg[block] = {"anything": {}}
    if item == "transformers":
        cfg[item] = {"geo": {"location_distance": {}}}
    elif item == "write_feast_features":
        cfg.pop("write_main")
        cfg[item] = {"file_path": "feast_repo/"}
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="no parquet files"):
        workflow.main(cfg, "local")
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    with pytest.raises(FileNotFoundError):
        jwf.main(cfg, "local")


@pytest.mark.parametrize("knob", sorted(UNPORTED_KNOBS))
def test_unported_knobs_raise_naming_their_item(knob, tmp_path, monkeypatch):
    """A set knob of an unported layer makes ``main`` (on a config whose
    input does not exist, so any work would raise FileNotFoundError) and
    ``run`` (on a config file that does not exist) raise
    NotImplementedError naming the knob, what it asks for and its Queue A
    item; the same knob set to 0 or off is no request."""
    from anovos_tpu_torch import workflow

    what, item = UNPORTED_KNOBS[knob]
    cfg = load_config("configs_basic.yaml")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv(knob, "1")
    match = f"{knob} asks for {what}, which is not ported.*ROADMAP.md Queue A item {item}$"
    with pytest.raises(NotImplementedError, match=match):
        workflow.main(cfg, "local")
    with pytest.raises(NotImplementedError, match=match):
        workflow.run(str(tmp_path / "absent.yaml"), "local")
    assert os.listdir(tmp_path) == []
    for off in ("0", "off"):
        monkeypatch.setenv(knob, off)
        with pytest.raises(FileNotFoundError):
            workflow.main(cfg, "local")


def test_chaos_wedge_raises_naming_the_failover_item(tmp_path, monkeypatch):
    """A chaos plan with a ``wedge`` directive: the port has no backend
    failover, which gives a wedge its outcome, so ``main`` raises before
    any work instead of ignoring it; ``exc`` and ``hang`` plans run."""
    from anovos_tpu_torch import workflow

    cfg = load_config("configs_basic.yaml")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ANOVOS_TPU_CHAOS", "seed=3;exc@node:join_dataset;wedge@node:stats_generator/*")
    with pytest.raises(NotImplementedError, match="backend wedge.*failover.*ROADMAP.md Queue A item 4$"):
        workflow.main(cfg, "local")
    monkeypatch.setenv("ANOVOS_TPU_CHAOS", "exc@node:join_dataset;hang@node:x:secs=1")
    with pytest.raises(FileNotFoundError):
        workflow.main(cfg, "local")


def test_basic_report_skips_the_analytics_blocks(tmp_path, monkeypatch):
    """With basic_report true both runners skip the analytics keys after
    it, continuous_analysis among them: neither folds the feed.  Without
    it both run one continuum step and write its artifacts."""
    from anovos_tpu import workflow as jwf
    from anovos_tpu_torch import workflow
    from test_torch_continuum import _write_feed

    feed = tmp_path / "feed"
    _write_feed(str(feed), {1: {}, 2: {}})
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    for basic in (True, False):
        for tag, wf in (("port", workflow), ("jax", jwf)):
            work = tmp_path / f"{tag}-{basic}"
            work.mkdir()
            monkeypatch.chdir(work)
            cfg = {"input_dataset": {"read_dataset": {"file_path": str(feed / "day-01.parquet"),
                                                      "file_type": "parquet"}},
                   "anovos_basic_report": {"basic_report": basic,
                                           "report_args": {"skip_corr_matrix": True,
                                                           "output_path": str(work / "report_stats")}},
                   "continuous_analysis": {"dataset_path": str(feed), "state_dir": str(work / "state"),
                                           "output_path": str(work / "out")}}
            wf.main(cfg, "local")
            assert (work / "report_stats" / "ml_anovos_report.html").exists() is basic, (tag, basic)
            assert (work / "out" / "continuum_stats.csv").exists() is (not basic), (tag, basic)


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


# the four knobs of the run record, which the runner used to refuse: each
# now does what it asks for (one test a knob, in place of its case above)

def _record_run(tmp_path, monkeypatch, **env):
    """``workflow.run`` of the mini config of tests/test_obs.py on 300
    rows, sequential, under ``env``; returns its manifest."""
    import yaml

    from anovos_tpu_torch import obs, workflow
    from test_torch_obs import mini_cfg, mini_parquet

    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(mini_cfg(mini_parquet(tmp_path, 300))))
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    for knob, value in env.items():
        monkeypatch.setenv(knob, value)
    monkeypatch.chdir(tmp_path)
    workflow.run(str(cfg_path), "local")
    return obs.load_manifest(workflow.LAST_MANIFEST_PATH)


def test_trace_knob_writes_the_chrome_trace(tmp_path, monkeypatch):
    man = _record_run(tmp_path, monkeypatch, ANOVOS_TPU_TRACE="1")
    path = tmp_path / "report_stats" / "obs" / "trace.json"
    assert man["trace_path"] == str(path)
    import json

    events = json.loads(path.read_text())["traceEvents"]
    nodes = {e["name"] for e in events if e.get("cat") == "node" and e["ph"] == "X"}
    assert set(man["scheduler"]["nodes"]) | {"input_dataset/ETL"} == nodes


def test_trace_buffer_knob_bounds_the_ring(tmp_path, monkeypatch):
    from anovos_tpu_torch import obs

    man = _record_run(tmp_path, monkeypatch, ANOVOS_TPU_TRACE_BUFFER="5")
    tracer = obs.get_tracer()
    assert tracer.maxlen == 5 and tracer.span_count() == 5 and tracer.dropped > 0
    # the manifest's snapshot is taken before its own write's spans land
    assert 0 < man["metrics"]["trace_spans_dropped_total"]["series"][""] <= tracer.dropped
    monkeypatch.delenv("ANOVOS_TPU_TRACE_BUFFER")
    (tmp_path / "again").mkdir()
    _record_run(tmp_path / "again", monkeypatch)
    assert obs.get_tracer().maxlen == 200_000


def test_profile_knob_writes_a_profiler_trace(tmp_path, monkeypatch):
    prof = tmp_path / "profile"
    _record_run(tmp_path, monkeypatch, ANOVOS_PROFILE=str(prof))
    (trace,) = prof.iterdir()
    assert trace.name.startswith("anovos_torch_profile_") and trace.stat().st_size > 0


def test_devprof_knob_off_leaves_the_manifest_section_null(tmp_path, monkeypatch):
    man = _record_run(tmp_path, monkeypatch, ANOVOS_TPU_DEVPROF="0")
    assert man["devprof"] is None
    assert not any(k.startswith(("devprof_", "transfer_")) for k in man["metrics"])
    (tmp_path / "on").mkdir()
    monkeypatch.setenv("ANOVOS_TPU_DEVPROF", "1")
    assert set(_record_run(tmp_path / "on", monkeypatch)["devprof"]) == set(man["scheduler"]["nodes"])
