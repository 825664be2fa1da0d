"""The port's data-plane and continuum chaos scenarios
(``anovos_tpu_torch/resilience/scenarios.py``: ``corrupt-ingest``,
``slowread-stream`` and ``feed-30d``, with the 30-day feed of
``resilience/feed.py``) against ``tools/chaos_run.py``'s on the same seeds,
on the CPU.

A module fixture runs each JAX gate (in a fresh single-device process, as
``tests/test_resilience.py`` does) and the port's through its CLI
(``--device cpu --json``) once; the tests hold the outcomes equal:

* ``corrupt-ingest``: ok, injections, the quarantine records, the degraded
  set, no flight dump and none on the clean leg; the chaos tree has JAX's
  files, each stats CSV within ``tests/test_torch_workflow.py``'s bands,
  and is byte-equal to a clean run of the port over parts 0 and 3 alone;
* ``slowread-stream``: parity, injections, no quarantine, the workers;
* ``feed-30d``: the feed's bytes, parity, both quarantine lists, the shift
  alert's day, the alerts (kind, partition, attribute) with their values
  within the continuum tests' bands, flight context on every drift alert.

The two timed bounds (the slow-read chaos wall, day 30's fold against day
2's) are sub-second comparisons that a loaded test worker can tip either
way: the tests check their fields, the gates keep JAX's bounds, and
``chip_smoke.py`` phase 21 holds each gate's whole ``ok`` on the card.
Every test leaves both packages with no chaos plan, quarantine record,
degraded section or armed flight recorder, and no ``anovos-torch-*``
thread.
"""

import contextlib
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

from _torch_port import failover_isolated, torch_cpu_runtime  # noqa: F401
from test_torch_workflow import assert_csv_close

REPO = pathlib.Path(__file__).resolve().parents[1]
CLI_SCENARIOS = ("corrupt-ingest", "slowread-stream", "feed-30d")
JAX_TIMEOUT = 400
KNOBS = ("ANOVOS_TPU_CHAOS", "ANOVOS_TPU_EXECUTOR", "ANOVOS_TPU_NODE_TIMEOUT", "ANOVOS_TPU_CACHE",
         "ANOVOS_TPU_FLIGHTREC", "ANOVOS_STREAM_INFLIGHT", "ANOVOS_STREAM_DECODE_WORKERS")


def _reset_both():
    from anovos_tpu.data_ingest import guard as jguard
    from anovos_tpu.obs import flight as jflight
    from anovos_tpu.resilience import chaos as jchaos
    from anovos_tpu.resilience import policy as jpolicy
    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.obs import flight
    from anovos_tpu_torch.resilience import chaos, policy

    for mod in (chaos, jchaos, guard, jguard, flight, jflight):
        mod.reset()
    for mod in (policy, jpolicy):
        mod.reset_degraded()


def _port_left_nothing():
    """What a port scenario must leave behind: nothing."""
    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.obs import flight
    from anovos_tpu_torch.resilience import chaos, policy

    return chaos.plan() is None and not guard.records() and not policy.degraded_sections() and not flight.enabled()


def _cli(argv):
    """(exit code, the JSON result) of the port's scenario CLI."""
    from anovos_tpu_torch.resilience import scenarios

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = scenarios.main([*argv, "--device", "cpu", "--json"])
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def _jax_gate(name, workdir):
    """``tools/chaos_run.py``'s gate in a fresh single-device process, as
    ``tests/test_resilience.py`` runs it (the JAX package's concurrent
    executor is not run on the pytest process's 8-device mesh)."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    for k in ("XLA_FLAGS", *KNOBS):
        env.pop(k, None)
    return subprocess.Popen([sys.executable, "-m", "tools.chaos_run", "--scenario", name, "--workdir",
                             str(workdir), "--json"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=REPO)


@pytest.fixture(scope="module")
def gates(tmp_path_factory):
    """Each scenario's JAX gate and the port's CLI, once, in a directory
    each (one JAX process at a time, beside the port's run of the same
    scenario, so the module loads one core more than its worker); whether
    each port run kept the env knobs and left nothing behind."""
    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime("cpu")
    root = tmp_path_factory.mktemp("dataplane")
    env = {k: os.environ.get(k) for k in KNOBS}
    out = {"root": root}
    procs = {}
    try:
        for name in CLI_SCENARIOS:
            p = procs[name] = _jax_gate(name, root / name / "jax")
            port_dir = root / name / "port"
            rc, res = _cli(["--scenario", name, "--workdir", str(port_dir)])
            out[name] = {"rc": rc, "port": res, "left_nothing": _port_left_nothing(),
                         "env_kept": {k: os.environ.get(k) for k in KNOBS} == env,
                         "port_dir": port_dir, "jax_dir": root / name / "jax"}
            _reset_both()
            stdout, stderr = p.communicate(timeout=JAX_TIMEOUT)
            assert stdout.strip(), stderr[-4000:]
            res = json.loads(stdout.strip().splitlines()[-1])
            assert p.returncode == (0 if res["ok"] else 1), stdout + stderr[-4000:]
            assert res["ok"] or _timed_only(JAX_TIMED_ONLY, name, res), stdout + stderr[-4000:]
            out[name]["jax"] = res
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        _reset_both()
    return out


@pytest.fixture(autouse=True)
def _isolated(failover_isolated):  # noqa: F811
    yield
    _reset_both()


# the one failure a CPU run may show, in either package: a timed bound
# (module docstring)
TIMED_ONLY = {"corrupt-ingest": None, "slowread-stream": r"chaos wall \S+ s exceeded the bound \S+ s: the pool "
              r"serialized the slow parts", "feed-30d": r"day-30 fold \S+ s is \S+x day 2's: the fold wall grew "
              r"with the history"}
JAX_TIMED_ONLY = {"corrupt-ingest": None, "slowread-stream": r"chaos wall \S+s exceeded the bound \S+s \u2014 the "
                  r"pool serialized the slow parts instead of absorbing them", "feed-30d": r"day-30 fold \S+s is "
                  r"\S+x day-2 \u2014 fold wall grew with history length"}


def _timed_only(table, name, res):
    """Whether ``res`` failed on its scenario's timed bound and nothing else."""
    import re

    return bool(table[name]) and re.fullmatch(table[name], res.get("error", "")) is not None


@pytest.mark.parametrize("name", CLI_SCENARIOS)
def test_cli_exits_zero_and_leaves_nothing_behind(gates, name):
    """The CLI exits 0 with ``ok``; where a timed bound tipped on a loaded
    host it exits 1 and names that bound and nothing else."""
    g = gates[name]
    res = g["port"]
    assert res["scenario"] == name and g["rc"] == (0 if res["ok"] else 1)
    assert res["ok"] or _timed_only(TIMED_ONLY, name, res), res
    assert g["left_nothing"] and g["env_kept"]


def test_tables_are_the_jax_gates():
    from tools import chaos_run

    from anovos_tpu_torch.resilience import scenarios

    for table in ("SCENARIOS", "SCENARIO_PARTS", "EXPECT_QUARANTINE", "EXPECT", "EXPECT_DEGRADED",
                  "REQUIRE_MULTIDEV", "EXPECT_FLIGHT"):
        assert getattr(scenarios, table) == getattr(chaos_run, table), table
    # the slow-read bound: clean + 0.6 x 6 parts x 0.6 s x 2 passes
    assert scenarios.SLOWREAD_SHARE * scenarios.SLOWREAD_SLOW_PARTS * scenarios.SLOWREAD_SECS * 2 == pytest.approx(4.32)


# ------------------------------------------------------------ corrupt-ingest ----
def test_corrupt_ingest_outcome_equals_jax(gates):
    g = gates["corrupt-ingest"]
    got, exp = g["port"], g["jax"]

    def outcome(r):
        return (r["ok"], r["injections"], r["quarantine_records"], r["degraded"], r["flightrec"],
                r["clean_flightrec"], r["clean_quarantined_parts"], r["quarantined_parts"], r["quarantine_rows"],
                r["missing_counters"], r["flightrec_missing"], r["parity"])

    assert outcome(got) == outcome(exp), (got, exp)
    assert got["quarantine_records"] == {"part-00001.parquet": 375, "part-00002.parquet": 375}
    assert got["degraded"] == ["ingest/part-00001.parquet", "ingest/part-00002.parquet"]
    assert got["injections"] == 5 and got["flightrec"] == [] and got["clean_flightrec"] == 0
    assert got["chaos_wall_bound_s"] == round(got["clean_wall_s"] * 2 + 90, 1)
    # each record as JAX's, the paths aside
    recs = [{k: v for k, v in r.items() if k not in ("file", "error")} | {"file": os.path.basename(r["file"])}
            for r in got["resilience"]["quarantine"]["records"]]
    jrecs = [{k: v for k, v in r.items() if k not in ("file", "error")} | {"file": os.path.basename(r["file"])}
             for r in exp["resilience"]["quarantine"]["records"]]
    assert recs == jrecs
    assert [r["error_class"] for r in recs] == ["ChaosCorrupt", "ChaosTruncate"]


def test_corrupt_ingest_parts_are_the_jax_bytes(gates):
    g = gates["corrupt-ingest"]
    names = sorted(os.listdir(g["jax_dir"] / "data4"))
    assert names == [f"part-{i:05d}.parquet" for i in range(4)]
    assert sorted(os.listdir(g["port_dir"] / "data4")) == names
    for n in names:
        assert (g["port_dir"] / "data4" / n).read_bytes() == (g["jax_dir"] / "data4" / n).read_bytes(), n


def test_corrupt_ingest_chaos_tree_matches_jax(gates):
    from anovos_tpu_torch.resilience.scenarios import tree_files

    import pandas as pd

    g = gates["corrupt-ingest"]
    port, jax = g["port_dir"] / "chaos", g["jax_dir"] / "chaos"
    files = sorted(tree_files(jax))
    assert sorted(tree_files(port)) == files
    csvs = [f for f in files if f.endswith(".csv")]
    assert len(csvs) >= 8
    for rel in csvs:
        assert_csv_close(str(port / rel), str(jax / rel))
    final = [f for f in files if f.startswith("output/") and f.endswith(".parquet")]
    assert final
    for rel in final:
        a, b = pd.read_parquet(port / rel), pd.read_parquet(jax / rel)
        assert len(a) == len(b) == 750 and list(a.columns) == list(b.columns)
        np.testing.assert_array_equal(a["age"].to_numpy(), b["age"].to_numpy())


def test_corrupt_ingest_chaos_tree_is_the_surviving_parts_run(gates, tmp_path):
    """Quarantine takes out exactly the lost rows: the chaos tree is
    byte-equal to a clean run over parts 0 and 3 alone."""
    from anovos_tpu_torch.resilience import scenarios

    g = gates["corrupt-ingest"]
    cfg = scenarios.survivors_config(str(g["port_dir"]), str(tmp_path / "survivors"))
    assert sorted(os.listdir(tmp_path / "survivors")) == ["part-00000.parquet", "part-00003.parquet"]
    scenarios.run_leg(cfg, str(tmp_path / "run"), "", "600")
    assert scenarios.tree_hash(tmp_path / "run") == scenarios.tree_hash(g["port_dir"] / "chaos")
    assert scenarios.tree_files(tmp_path / "run") == scenarios.tree_files(g["port_dir"] / "chaos")


# ----------------------------------------------------------- slowread-stream ----
def test_slowread_stream_outcome_equals_jax(gates):
    g = gates["slowread-stream"]
    got, exp = g["port"], g["jax"]
    assert got["parity"] is exp["parity"] is True
    assert got["injections"] == exp["injections"] >= 12
    assert got["quarantined_parts"] == exp["quarantined_parts"] == 0
    assert got["clean_quarantined_parts"] == exp["clean_quarantined_parts"] == 0
    assert got["stream_workers"] == exp["stream_workers"] == 4
    assert got["stream_overlap_pct"] is not None
    assert got["serial_penalty_s"] == exp["serial_penalty_s"]
    assert got["chaos_wall_bound_s"] == round(got["clean_wall_s"] + 0.6 * got["serial_penalty_s"], 2)
    for name in sorted(os.listdir(g["jax_dir"] / "stream_data")):
        assert ((g["port_dir"] / "stream_data" / name).read_bytes()
                == (g["jax_dir"] / "stream_data" / name).read_bytes()), name


# ------------------------------------------------------------------ feed-30d ----
def test_feed_builder_writes_the_jax_bytes(tmp_path):
    from tools import continuum_bench

    from anovos_tpu_torch.resilience import feed

    assert (feed.SHIFT_DAY, feed.CORRUPT_DAY, feed.SCHEMA_DRIFT_DAY) == (
        continuum_bench.SHIFT_DAY, continuum_bench.CORRUPT_DAY, continuum_bench.SCHEMA_DRIFT_DAY)
    for days, rows in ((30, 500), (21, 64)):
        a = feed.build_feed_30d(str(tmp_path / f"port{days}"), days=days, rows_per_day=rows)
        b = continuum_bench.build_feed_30d(str(tmp_path / f"jax{days}"), days=days, rows_per_day=rows)
        names = sorted(os.listdir(b))
        assert sorted(os.listdir(a)) == names and len(names) == days
        for n in names:
            assert open(os.path.join(a, n), "rb").read() == open(os.path.join(b, n), "rb").read(), n


def test_feed_30d_outcome_equals_jax(gates):
    g = gates["feed-30d"]
    got, exp = g["port"], g["jax"]
    keys = ("parity", "continuum_quarantined", "continuum_batch_quarantined", "continuum_shift_alert_day",
            "continuum_days", "continuum_rows_per_day", "e2e_continuum_alerts", "drift_alerts",
            "drift_alerts_with_flight_context")
    assert {k: got[k] for k in keys} == {k: exp[k] for k in keys}
    assert got["parity"] is True and got["continuum_quarantined"] == ["day-20.parquet"]
    assert got["continuum_shift_alert_day"] == 25
    assert got["drift_alerts"] == got["drift_alerts_with_flight_context"] > 0
    assert got["continuum_day30_vs_day2"] > 0 and got["continuum_day2_fold_s"] > 0
    assert sorted(set(got) - {"error"}) == sorted(set(exp) - {"error"})
    for n in sorted(os.listdir(g["jax_dir"] / "alldays")):
        assert (g["port_dir"] / "alldays" / n).read_bytes() == (g["jax_dir"] / "alldays" / n).read_bytes(), n


def _alerts(workdir):
    with open(os.path.join(workdir, "inc", "out", "obs", "continuum_alerts.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_feed_30d_alerts_equal_jax(gates):
    """The same (kind, partition, attribute) alerts in both packages, their
    values within the continuum tests' drift band, every drift alert with
    flight context."""
    g = gates["feed-30d"]
    got, exp = _alerts(g["port_dir"]), _alerts(g["jax_dir"])
    # the quarantine reason names the part by its path
    for recs, d in ((got, g["port_dir"]), (exp, g["jax_dir"])):
        for a in recs:
            if isinstance(a.get("reason"), str):
                a["reason"] = a["reason"].replace(str(d), "<workdir>")

    def key(a):
        return (a["kind"], a.get("partition"), a.get("attribute"))

    assert sorted(map(key, got)) == sorted(map(key, exp))
    assert {"drift", "quarantine"} <= {a["kind"] for a in got}
    by_key = {key(a): a for a in exp}
    for a in got:
        e = by_key[key(a)]
        assert sorted(a) == sorted(e), key(a)
        for k, v in a.items():
            if k in ("t_unix", "flight"):
                continue
            if isinstance(v, float) and isinstance(e[k], float):
                np.testing.assert_allclose(v, e[k], rtol=1e-4, atol=1e-4, err_msg=f"{key(a)}:{k}")
            else:
                assert v == e[k], (key(a), k)
    assert all(a.get("flight") for a in got if a["kind"] == "drift")


def test_feed_30d_gate_leaves_an_armed_recorder_armed(tmp_path, monkeypatch):
    """The gate disarms only a recorder it armed: one armed by the caller
    stays armed (on the caller's directory)."""
    from anovos_tpu_torch.obs import flight
    from anovos_tpu_torch.resilience import feed, scenarios

    monkeypatch.setattr(scenarios, "FEED_DAYS", 2)
    monkeypatch.setattr(scenarios, "FEED_ROWS_PER_DAY", 64)
    flight.configure(str(tmp_path / "mine"))
    res = scenarios.run_feed_30d(str(tmp_path / "w"))
    assert flight.enabled() and not res["ok"] and "no drift alert" in res["error"]
    assert res["continuum_days"] == 2 and res["continuum_parity"] is True
    flight.reset()
    assert feed.build_feed_30d(str(tmp_path / "w" / "alldays")) == str(tmp_path / "w" / "alldays")
    assert len(os.listdir(tmp_path / "w" / "alldays")) == 2


# ----------------------------------------------------------------- the CLI ----
def test_cli_honours_config_and_spec(tmp_path):
    """``--config`` (YAML) and ``--spec`` on the ``exc`` scenario: the given
    config's nodes run (no drift block, no drift artifacts) and the given
    plan fires on its site."""
    from anovos_tpu_torch.resilience import scenarios

    cfg = scenarios.synthetic_config(str(tmp_path / "data_root"))
    del cfg["drift_detector"]
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    spec = "seed=7;exc@node:quality_checker/duplicate_detection"
    rc, res = _cli(["--scenario", "exc", "--config", str(path), "--spec", spec, "--workdir", str(tmp_path / "w")])
    assert rc == 0 and res["ok"] and res["spec"] == spec and res["injections"] == 1
    assert res["resilience"]["retries"] >= 1 and res["parity"]
    files = scenarios.tree_files(tmp_path / "w" / "clean")
    assert files and not any("drift" in f for f in files)
    assert "report_stats/duplicate_detection.csv" in files
    assert not os.path.exists(tmp_path / "w" / "data")  # the built-in data was not written
    assert _port_left_nothing()


def test_cli_serve_fault_runs_the_serving_gate(tmp_path, monkeypatch):
    from anovos_tpu_torch.serving import demo

    calls = []
    monkeypatch.setattr(demo, "run_serve_fault", lambda workdir: calls.append(workdir) or
                        {"scenario": "serve-fault", "ok": True, "injections": 3})
    rc, res = _cli(["--scenario", "serve-fault", "--workdir", str(tmp_path)])
    assert rc == 0 and calls == [str(tmp_path)] and res == {"scenario": "serve-fault", "ok": True, "injections": 3}


def test_hang_collective_waits_for_the_mesh(tmp_path):
    from anovos_tpu_torch.resilience import scenarios

    for call in (lambda: scenarios.main(["--scenario", "hang-collective", "--device", "cpu"]),
                 lambda: scenarios.run_scenario("hang-collective", str(tmp_path))):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A, Multi-device and multi-host"):
            call()
    assert not os.listdir(tmp_path)


def test_survivors_config_reads_only_the_readable_parts(tmp_path):
    from anovos_tpu_torch.resilience import scenarios

    cfg = scenarios.survivors_config(str(tmp_path / "w"), str(tmp_path / "s"))
    reads = [cfg["input_dataset"]["read_dataset"]["file_path"],
             cfg["drift_detector"]["drift_statistics"]["source_dataset"]["read_dataset"]["file_path"]]
    assert reads == [str(tmp_path / "s")] * 2
    assert sorted(os.listdir(tmp_path / "s")) == ["part-00000.parquet", "part-00003.parquet"]
    shutil.rmtree(tmp_path / "s")
