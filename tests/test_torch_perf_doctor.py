"""The port's perf doctor (``anovos_tpu_torch/obs/diffing.py``, its ledger
reader ``obs/ledger.py``, ``python -m anovos_tpu_torch.obs.diffing`` and
the report's Perf Ledger and Run Diff tabs) against the JAX package's
``obs/diffing.py``, ``tools/perf_ledger.py`` and ``tools/perf_doctor.py``,
case by case as ``tests/test_perf_doctor.py`` and the reader cases of
``tests/test_perf_ledger.py`` hold the JAX ones:

* every manifest and ledger diff: ``canonical`` byte-equal to JAX's on
  the same two inputs, schema-valid, and ranked as JAX ranks it (phase
  decomposition, a node in one run only, degraded first, queue wait never
  booked, cross-class pairs refused with ``cuda`` an ``accel`` backend,
  the program-set and cache hit-set diffs);
* ``live_node_summary`` and the flight snapshot's ``doctor`` field;
* the CLI's modes and exit codes against ``tools/perf_doctor.py``'s, on a
  ledger made from the committed ``BENCH_r04``/``BENCH_r05`` rounds;
* two real runs of each runner diffed: the port's view of its manifests
  equal to JAX's of its own but for the named manifest differences;
* the reader's ``load`` and ``field_trends`` and both tabs equal to JAX's
  on the same ledger and baseline, under ``ANOVOS_PERF_LEDGER`` and
  ``ANOVOS_RUN_DIFF_BASELINE``.

Every test leaves no thread behind (``_no_thread_left``).
"""

import copy
import json
import os
import subprocess
import sys

import pytest

from _torch_port import assert_no_thread_left, thread_names, torch_cpu_runtime  # noqa: F401
from anovos_tpu_torch.obs import diffing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_thread_left():
    before = thread_names()
    yield
    assert_no_thread_left(before)


def _node(dur=1.0, queue=0.0, cached=False, degraded=False, state="done"):
    return {"start_s": 0.0, "end_s": dur, "dur_s": dur, "queue_wait_s": queue, "thread": "w0", "lane": "device",
            "devices": [], "state": state, "cached": cached, "attempts": 1, "escalated": False,
            "degraded": degraded, "deps": []}


def _dev(wall=1.0, device=0.0, dispatch=0.2, transfer=0.05, host=None, h2d=1000, d2h=500):
    if host is None:
        host = max(wall - device - dispatch - transfer, 0.0)
    return {"wall_s": wall, "device_time_s": device, "dispatch_s": dispatch, "transfer_s": transfer,
            "host_s": round(host, 6), "h2d_bytes": h2d, "d2h_bytes": d2h, "dispatches": 3, "transfers": 2,
            "last_op": "op", "clamped": False}


def _man(nodes, devprof=None, census=None, backend="cpu", config_hash="c1", mode="sequential", wall=10.0,
         cache=None, resilience=None, env=None):
    return {"manifest_version": 1, "config_hash": config_hash, "run_type": "local",
            "executor": {"mode": mode, "workers": 1}, "critical_path": sorted(nodes),
            "scheduler": {"mode": mode, "workers": 1, "wall_s": wall, "nodes": nodes}, "block_seconds": {},
            "metrics": {}, "compile_census": census, "cache": cache, "resilience": resilience,
            "devprof": devprof, "env": env, "trace_path": None, "backend": backend, "generated_unix": 1000.0}


_CENSUS_B = {"compiles_total": 10, "distinct_programs": 8, "distinct_kernels": 8, "compile_seconds_total": 5.0,
             "programs": [{"program": "jit(eager_one)", "count": 3, "seconds": 2.0, "nodes": ["a"]},
                          {"program": "jit(shared)", "count": 1, "seconds": 1.0, "nodes": ["a"]}]}
_CENSUS_C = {"compiles_total": 4, "distinct_programs": 3, "distinct_kernels": 3, "compile_seconds_total": 2.0,
             "programs": [{"program": "jit(_fused_block)", "count": 2, "seconds": 1.5, "nodes": ["a"]},
                          {"program": "jit(shared)", "count": 2, "seconds": 1.2, "nodes": ["a"]}]}
_ENV_B = {"code_version": "1.0", "knobs": {"ANOVOS_AE_COMPUTE": "bf16"}, "env_fingerprint": "e1",
          "dataset_fingerprint": "d1"}
_ENV_C = {"code_version": "1.0", "knobs": {}, "env_fingerprint": "e2", "dataset_fingerprint": "d1"}

PAIRS = {
    "phases": (_man({"a": _node(1.0), "b": _node(2.0)}, devprof={"a": _dev(1.0), "b": _dev(2.0, dispatch=0.5)}),
               _man({"a": _node(1.0), "b": _node(3.0)}, devprof={"a": _dev(1.0), "b": _dev(3.0, dispatch=1.4)},
                    backend="cpu")),
    "one_run_only": (_man({"a": _node(1.0), "gone": _node(2.5)}, devprof={"a": _dev(1.0), "gone": _dev(2.5)}),
                     _man({"a": _node(1.0), "fresh": _node(0.5)}, devprof={"a": _dev(1.0), "fresh": _dev(0.5)})),
    "degraded": (_man({"a": _node(1.0), "q": _node(4.0)}, devprof={"a": _dev(1.0), "q": _dev(4.0)}),
                 _man({"a": _node(1.2), "q": _node(0.1, degraded=True, state="degraded")},
                      devprof={"a": _dev(1.2), "q": _dev(0.1)},
                      resilience={"degraded_sections": {"q": "retries exhausted"}})),
    "queue_wait": (_man({"a": _node(1.0), "b": _node(2.0)}, devprof={"a": _dev(1.0), "b": _dev(2.0)}),
                   _man({"a": _node(1.0, queue=1.7), "b": _node(2.0, queue=2.4)},
                        devprof={"a": _dev(1.0), "b": _dev(2.0)}, mode="concurrent", wall=8.0)),
    "programs": (_man({"a": _node(1.0)}, devprof={"a": _dev(1.0)}, census=_CENSUS_B),
                 _man({"a": _node(1.0)}, devprof={"a": _dev(1.0)}, census=_CENSUS_C)),
    "cache": (_man({"a": _node(1.0, cached=True), "b": _node(2.0, cached=True)}, devprof={},
                   cache={"enabled": True, "hits": 2, "misses": 0}, env=_ENV_B),
              _man({"a": _node(1.0), "b": _node(2.0, cached=True)}, devprof={},
                   cache={"enabled": True, "hits": 1, "misses": 1}, env=_ENV_C)),
    "cuda_vs_cuda": (_man({"a": _node(1.0)}, devprof={"a": _dev(1.0)}, backend="cuda"),
                     _man({"a": _node(1.5), "c": _node(0.5)}, devprof={"a": _dev(1.5, dispatch=0.7),
                                                                       "c": _dev(0.5)}, backend="cuda")),
}


def _kinds(diag):
    return [(a["kind"], a["subject"]) for a in diag["attributions"]]


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_manifest_diff_is_canonically_jax_s(pair):
    from anovos_tpu.obs import diffing as jdiff

    base, cand = PAIRS[pair]
    d = diffing.diff_manifests(base, cand, baseline_label="b", candidate_label="c")
    assert diffing.validate_diagnosis(d) == []
    assert diffing.canonical(d) == jdiff.canonical(jdiff.diff_manifests(base, cand, "b", "c"))
    assert diffing.render_text(d, top=0) == jdiff.render_text(d, top=0)
    assert diffing.canonical(d) == diffing.canonical(diffing.diff_manifests(base, cand, "b", "c"))


def test_phase_decomposition_and_dominant_phase():
    d = diffing.diff_manifests(*PAIRS["phases"])
    assert d["nodes"]["b"]["wall_delta_s"] == pytest.approx(1.0)
    assert d["nodes"]["b"]["dominant_phase"] == "dispatch_s"
    disp = [a for a in d["attributions"] if a["kind"] == "phase" and a["subject"] == "dispatch_s"]
    assert disp and disp[0]["delta_s"] == pytest.approx(0.9) and "b (+0.900s)" in disp[0]["detail"]


def test_node_present_in_one_run_only():
    d = diffing.diff_manifests(*PAIRS["one_run_only"])
    assert d["nodes"]["gone"]["status"] == "removed" and d["nodes"]["fresh"]["status"] == "added"
    assert {("node_removed", "gone"), ("node_added", "fresh")} <= set(_kinds(d))
    assert next(a for a in d["attributions"] if a["kind"] == "node_removed")["severity"] == "structural"


def test_degraded_vs_clean_pair_ranks_first():
    d = diffing.diff_manifests(*PAIRS["degraded"])
    top = d["attributions"][0]
    assert (top["kind"], top["subject"], top["severity"]) == ("degraded", "q", "structural")
    assert "missing, not slower" in top["detail"] and d["nodes"]["q"]["degraded"] == [False, True]


def test_sequential_vs_concurrent_queue_wait_never_books_as_regression():
    d = diffing.diff_manifests(*PAIRS["queue_wait"])
    assert d["executor_change"] == ["sequential", "concurrent"]
    assert d["nodes"]["b"]["queue_wait_delta_s"] == pytest.approx(2.4)
    assert {a["kind"] for a in d["attributions"]} <= {"executor"}


@pytest.mark.parametrize("b,c,refused", [("cpu", "cuda", True), ("cuda", "tpu", False), ("cuda", None, False)])
def test_cross_backend_class_pair_refused_loudly(b, c, refused):
    base, cand = _man({"a": _node(1.0)}, backend=b), _man({"a": _node(1.0)}, backend=c)
    if refused:
        with pytest.raises(diffing.DiffRefused, match="backend classes"):
            diffing.diff_manifests(base, cand)
    else:
        assert diffing.diff_manifests(base, cand)["backend_class"] == "accel"
    with pytest.raises(diffing.DiffRefused):
        diffing.diff_ledger_entries({"backend_class": "cpu", "fields": {}}, {"backend_class": "accel", "fields": {}})


def test_program_set_diff_names_nodes_and_wall():
    d = diffing.diff_manifests(*PAIRS["programs"])
    p = d["programs"]
    assert (p["new"], p["retired"], p["count_changed"]) == (["jit(_fused_block)"], ["jit(eager_one)"],
                                                           {"jit(shared)": [1, 2]})
    assert p["compile_wall_delta_s"] == pytest.approx(-3.0) and p["nodes_touched"] == ["a"]
    prog = next(a for a in d["attributions"] if a["kind"] == "programs")
    assert "jit(_fused_block)" in prog["detail"] and "nodes touched: a" in prog["detail"]


def test_cache_hit_set_diff_names_moved_fingerprint_input():
    d = diffing.diff_manifests(*PAIRS["cache"])
    assert d["cache"]["re_executed"] == ["a"]
    assert any("ANOVOS_AE_COMPUTE" in m for m in d["cache"]["moved_inputs"])
    cache_attr = next(a for a in d["attributions"] if a["kind"] == "cache")
    assert "re-executed" in cache_attr["detail"] and "ANOVOS_AE_COMPUTE" in cache_attr["detail"]
    env_attr = next(a for a in d["attributions"] if a["kind"] == "env")
    assert (env_attr["subject"], env_attr["severity"]) == ("ANOVOS_AE_COMPUTE", "info")


def test_validator_bites():
    d = diffing.diff_manifests(*PAIRS["cuda_vs_cuda"])
    broken = json.loads(diffing.canonical(d))
    broken["attributions"][0]["rank"] = 99
    assert diffing.validate_diagnosis(broken)
    assert diffing.validate_diagnosis([]) == ["diagnosis is not a dict"]


def test_backend_class_agrees_with_jax_and_the_ledger():
    from anovos_tpu.obs.diffing import backend_class as jclass
    from tools.perf_ledger import _backend_class

    for b in ("cpu", "cpu-fallback (x)", "tpu", "TPU v5e", "cuda", "cuda:0", "", None, "none"):
        assert diffing.backend_class(b) == jclass(b) == _backend_class(b)
    assert diffing.backend_class("cuda") == "accel"


# -- ledger entries -------------------------------------------------------

LEDGER_PAIRS = {
    "flagged": ({"backend_class": "cpu", "source": "r1", "fields": {"e2e_warm_s": 6.0, "value": 100.0,
                                                                     "old_only": 1.0}},
                {"backend_class": "cpu", "source": "r2", "fields": {"e2e_warm_s": 9.0, "value": 101.0,
                                                                     "new_only": 2.0}}),
    "nodes": ({"backend_class": "cpu", "source": "r1", "fields": {"value": 1.0},
               "nodes": {"assoc/IV": {"wall_s": 0.4, "dispatch_s": 0.3, "host_s": 0.1}}},
              {"backend_class": "cpu", "source": "r2", "round": 2, "fields": {"value": 1.0},
               "nodes": {"assoc/IV": {"wall_s": 1.2, "dispatch_s": 1.0, "host_s": 0.2}}}),
}


@pytest.mark.parametrize("pair", sorted(LEDGER_PAIRS))
def test_ledger_diff_is_canonically_jax_s(pair):
    from anovos_tpu.obs import diffing as jdiff

    base, cand = LEDGER_PAIRS[pair]
    d = diffing.diff_ledger_entries(base, cand, flagged=["e2e_warm_s"])
    assert diffing.validate_diagnosis(d) == []
    assert diffing.canonical(d) == jdiff.canonical(jdiff.diff_ledger_entries(base, cand, flagged=["e2e_warm_s"]))
    if pair == "flagged":
        top = d["attributions"][0]
        assert (top["subject"], top["severity"]) == ("e2e_warm_s", "structural") and "FLAGGED" in top["detail"]
        assert d["fields"]["old_only"]["candidate"] is None and d["fields"]["new_only"]["baseline"] is None
    else:
        assert d["nodes"]["assoc/IV"]["dominant_phase"] == "dispatch_s"
        attr = next(a for a in d["attributions"] if a["kind"] == "node")
        assert "dispatch_s" in attr["detail"] and attr["delta_s"] == pytest.approx(0.8)


# -- the live summary -----------------------------------------------------

def test_live_node_summary_equals_jax_and_flags_slow_and_inflight_nodes():
    from anovos_tpu.obs.diffing import live_node_summary as jlive

    baseline = _man({"a": _node(1.0), "b": _node(0.4)}, devprof={"a": _dev(1.0), "b": _dev(0.4)})
    finished = {"a": _dev(2.0, dispatch=1.5), "new": _dev(0.1)}
    active = {"b": {"elapsed_s": 5.0, "dispatch_s": 0.1}}
    s = diffing.live_node_summary(baseline, finished, active)
    assert s == jlive(baseline, finished, active)
    assert s["slow"] == ["a", "b"] and s["nodes"]["a"]["dominant_phase"] == "dispatch_s"
    assert s["nodes"]["b"]["in_flight"] is True
    assert diffing.live_node_summary({}, finished) is None and diffing.live_node_summary(None, finished) is None


def test_flight_snapshot_carries_doctor_summary(tmp_path, monkeypatch):
    from anovos_tpu_torch.obs import devprof, flight, write_manifest

    obs_dir = tmp_path / "obs"
    obs_dir.mkdir()
    write_manifest(_man({"a": _node(1.0)}, devprof={"a": _dev(1.0)}), str(obs_dir / "run_manifest.json"))
    monkeypatch.setattr(devprof, "results", lambda: {"a": _dev(3.0, dispatch=2.5)})
    monkeypatch.setattr(devprof, "active_frames", lambda: {})
    flight.configure(str(obs_dir))
    try:
        doctor = flight.build_snapshot("test", node="a")["doctor"]
        assert doctor["slow"] == ["a"] and doctor["baseline_config_hash"] == "c1"
        assert doctor["nodes"]["a"]["baseline_wall_s"] == pytest.approx(1.0)
    finally:
        flight.reset()
    assert flight.build_snapshot("test2")["doctor"] is None


# -- the CLI --------------------------------------------------------------

def _cli(*args, module="anovos_tpu_torch.obs.diffing"):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": REPO})


@pytest.fixture(scope="module")
def round_ledger(tmp_path_factory):
    """A ledger of the committed BENCH_r*.json rounds, made by the JAX
    package's own ingest."""
    from tools import perf_ledger

    path = str(tmp_path_factory.mktemp("ledger") / "ledger.jsonl")
    assert perf_ledger.ingest_rounds(path=path) >= 2
    return path


def test_cli_self_check_deterministic_schema_valid(round_ledger):
    outs = [_cli("--self-check", "--ledger", round_ledger) for _ in range(2)]
    for p in outs:
        assert p.returncode == 0 and "self-check ok" in p.stdout, p.stdout + p.stderr
    assert outs[0].stdout == outs[1].stdout
    empty = _cli("--self-check", "--ledger", os.path.join(os.path.dirname(round_ledger), "absent.jsonl"))
    assert empty.returncode == 1 and "self-check FAILED" in empty.stderr


def test_cli_ledger_entry_mode_equals_jax(round_ledger, monkeypatch):
    args = ("--json", "--entry-baseline", "BENCH_r04.json", "--entry-candidate", "BENCH_r05.json")
    monkeypatch.setenv("ANOVOS_PERF_LEDGER", round_ledger)
    p, j = _cli(*args), _cli(*args, module="tools.perf_doctor")
    assert p.returncode == 0 == j.returncode, p.stderr + j.stderr
    assert p.stdout == j.stdout
    diag = json.loads(p.stdout.strip().splitlines()[-1])
    assert diag["kind"] == "ledger" and diag["attributions"] and diffing.validate_diagnosis(diag) == []
    assert _cli("--entry-baseline", "BENCH_r04.json").returncode == 2


def test_cli_manifest_mode_and_run_dir_resolution(tmp_path):
    from anovos_tpu_torch.obs import write_manifest

    run_b = tmp_path / "run_b"
    (run_b / "obs").mkdir(parents=True)
    write_manifest(_man({"a": _node(1.0)}, devprof={"a": _dev(1.0)}), str(run_b / "obs" / "run_manifest.json"))
    cand = tmp_path / "cand_manifest.json"
    write_manifest(_man({"a": _node(2.0)}, devprof={"a": _dev(2.0, dispatch=1.0)}), str(cand))
    args = ("--json", "--baseline", str(run_b), "--candidate", str(cand))
    p, j = _cli(*args), _cli(*args, module="tools.perf_doctor")
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout == j.stdout
    diag = json.loads(p.stdout.strip().splitlines()[-1])
    assert diag["kind"] == "manifest" and any(a["kind"] == "phase" for a in diag["attributions"])
    text = _cli(str(run_b / "obs"), str(cand))
    assert text.returncode == 0 and text.stdout.startswith("perf_doctor: manifest diff")
    assert _cli(str(cand)).returncode == 2


def test_cli_refuses_cross_backend_pair(tmp_path):
    from anovos_tpu_torch.obs import write_manifest

    b, c = tmp_path / "b.json", tmp_path / "c.json"
    write_manifest(_man({"a": _node(1.0)}, backend="cpu"), str(b))
    write_manifest(_man({"a": _node(1.0)}, backend="cuda"), str(c))
    p = _cli(str(b), str(c))
    assert p.returncode == 1 and "REFUSED" in p.stderr
    missing = _cli(str(b), str(tmp_path / "nowhere"))
    assert missing.returncode == 1 and "no run_manifest.json" in missing.stderr


# -- two real runs of each runner -----------------------------------------

def test_runner_manifests_diff_as_jax_s_do(tmp_path, monkeypatch):
    """Each runner twice on the mini config (sequential), the second run
    under ``ANOVOS_DBSCAN_GRID_SAMPLE`` (a knob both manifests record) and
    ``ANOVOS_AE_COMPUTE=bf16`` (which only the port's records: the JAX
    key leaves it out): the port's diagnosis of its pair has the structure
    JAX's has of its own (the node set, the attributions that do not
    depend on walls), its env section names the AE knob too, and the
    second run's flight recorder held the first run's manifest as its
    doctor's baseline."""
    from anovos_tpu import workflow as jwf
    from anovos_tpu.obs import diffing as jdiff
    from anovos_tpu_torch import workflow as pwf
    from anovos_tpu_torch.obs import flight, load_manifest
    from test_torch_obs import mini_cfg, mini_parquet

    cfg = mini_cfg(mini_parquet(tmp_path))
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    diags = {}
    for name, wf, dif in (("port", pwf, diffing), ("jax", jwf, jdiff)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        monkeypatch.delenv("ANOVOS_AE_COMPUTE", raising=False)
        monkeypatch.delenv("ANOVOS_DBSCAN_GRID_SAMPLE", raising=False)
        wf.main(copy.deepcopy(cfg), "local")
        first = json.load(open(wf.LAST_MANIFEST_PATH))
        monkeypatch.setenv("ANOVOS_AE_COMPUTE", "bf16")
        monkeypatch.setenv("ANOVOS_DBSCAN_GRID_SAMPLE", "5000")
        wf.main(copy.deepcopy(cfg), "local")
        second = json.load(open(wf.LAST_MANIFEST_PATH))
        diags[name] = dif.diff_manifests(first, second)
        assert dif.validate_diagnosis(diags[name]) == []
        if name == "port":
            assert load_manifest(wf.LAST_MANIFEST_PATH)["backend"] == "cpu"
            assert flight._BASELINE_MANIFEST["generated_unix"] == first["generated_unix"]
    p, j = diags["port"], diags["jax"]
    assert p["backend_class"] == j["backend_class"] == "cpu"
    assert sorted(p["nodes"]) == sorted(j["nodes"])
    assert {n: v["status"] for n, v in p["nodes"].items()} == {n: v["status"] for n, v in j["nodes"].items()}
    grid = {"ANOVOS_DBSCAN_GRID_SAMPLE": [None, "5000"]}
    assert j["env"]["changed_knobs"] == grid
    assert p["env"]["changed_knobs"] == {**grid, "ANOVOS_AE_COMPUTE": [None, "bf16"]}
    structural = lambda d: [(a["kind"], a["subject"]) for a in d["attributions"]  # noqa: E731
                            if a["severity"] != "timing"]
    assert structural(p) == sorted(structural(j) + [("env", "ANOVOS_AE_COMPUTE")])
    assert p["programs"] is None and j["programs"] is not None  # eager torch has no compile census


# -- the ledger reader and the report's tabs ------------------------------

def test_ledger_reader_equals_jax(tmp_path, round_ledger):
    from tools import perf_ledger

    path = tmp_path / "torn.jsonl"
    lines = open(round_ledger).read().splitlines()
    path.write_text("\n".join(lines) + "\n\n" + lines[-1][: len(lines[-1]) // 2])  # a torn tail
    from anovos_tpu_torch.obs import ledger

    assert ledger.load(str(path)) == perf_ledger.load(str(path)) and len(ledger.load(str(path))) == len(lines)
    assert ledger.load(str(tmp_path / "absent.jsonl")) == []
    assert ledger.TRACKED_FIELDS == perf_ledger.TRACKED_FIELDS
    entries = ledger.load(round_ledger)
    assert ledger.field_trends(entries) == perf_ledger.field_trends(entries)


def test_field_trends_emits_gap_markers_aligned_to_entries():
    from anovos_tpu_torch.obs import ledger
    from tools import perf_ledger

    def entry(n, fields):
        return perf_ledger._entry_from_bench({**fields, "e2e_backend": "cpu", "backend": "cpu"}, f"e{n}", n)

    entries = [entry(1, {"e2e_warm_s": 8.0, "value": 100.0}), entry(2, {"value": 110.0}),
               entry(3, {"e2e_warm_s": 6.0, "value": 120.0})]
    rows = {r["field"]: r for r in ledger.field_trends(entries)}
    warm = rows["e2e_warm_s"]
    assert len(warm["trend"]) == 3 and warm["trend"][1] == ledger.GAP_MARK
    assert ledger.GAP_MARK not in warm["trend"][0] + warm["trend"][2]
    assert (warm["n"], warm["gaps"]) == (2, 1) and (rows["value"]["n"], rows["value"]["gaps"]) == (3, 0)
    assert ledger.field_trends(entries) == perf_ledger.field_trends(entries)


def test_perf_ledger_tab_equals_jax(tmp_path, monkeypatch, round_ledger):
    from anovos_tpu.data_report.report_generation import perf_ledger_gen as jgen
    from anovos_tpu_torch.data_report.report_generation import perf_ledger_gen

    monkeypatch.delenv("ANOVOS_PERF_LEDGER", raising=False)
    assert perf_ledger_gen() == jgen() == ""
    monkeypatch.setenv("ANOVOS_PERF_LEDGER", str(tmp_path / "absent.jsonl"))
    assert perf_ledger_gen() == ""
    flagged = tmp_path / "flagged.jsonl"
    flagged.write_text(open(round_ledger).read() + json.dumps(
        {"source": "live", "backend_class": "cpu", "fields": {"value": 1.0}, "regressions": ["value"]}) + "\n")
    for path in (round_ledger, str(flagged)):
        monkeypatch.setenv("ANOVOS_PERF_LEDGER", path)
        html = perf_ledger_gen()
        assert html == jgen() and "<h3>Perf Ledger</h3>" in html
    assert "Entries flagged by the gate" in html


def test_run_diff_tab_equals_jax(tmp_path, monkeypatch):
    from anovos_tpu.data_report.report_generation import run_diff_gen as jgen
    from anovos_tpu_torch.data_report.report_generation import run_diff_gen
    from anovos_tpu_torch.obs import write_manifest

    master = tmp_path / "master"
    (master / "obs").mkdir(parents=True)
    write_manifest(_man({"a": _node(2.0)}, devprof={"a": _dev(2.0, dispatch=1.2)}),
                   str(master / "obs" / "run_manifest.json"))
    base_dir = tmp_path / "baseline_run"
    (base_dir / "obs").mkdir(parents=True)
    base_man = str(base_dir / "obs" / "run_manifest.json")
    write_manifest(_man({"a": _node(1.0)}, devprof={"a": _dev(1.0)}), base_man)
    monkeypatch.delenv("ANOVOS_RUN_DIFF_BASELINE", raising=False)
    assert run_diff_gen(str(master)) == jgen(str(master)) == ""
    monkeypatch.setenv("ANOVOS_RUN_DIFF_BASELINE", str(base_dir))
    assert run_diff_gen(str(tmp_path / "no_master")) == ""
    html = run_diff_gen(str(master))
    assert html == jgen(str(master)) and "ranked attributions" in html and "dispatch_s" in html
    write_manifest(_man({"a": _node(1.0)}, backend="tpu"), base_man)
    assert "Diff REFUSED" in run_diff_gen(str(master)) and run_diff_gen(str(master)) == jgen(str(master))
    write_manifest(_man({"renamed": _node(1.0)}, devprof={"renamed": _dev(1.0)}), base_man)
    html = run_diff_gen(str(master))
    assert html == jgen(str(master)) and "per-node movement" in html and "renamed" in html
    write_manifest(_man({"a": _node(2.0)}, devprof={"a": _dev(2.0, dispatch=1.2)}), base_man)
    assert "No attributable movement" in run_diff_gen(str(master))


def test_report_renders_both_tabs_after_run_timings(tmp_path, monkeypatch, round_ledger):
    """``anovos_report`` under both knobs: the Perf Ledger and Run Diff
    tabs follow Run Timings in both packages, with the same bodies."""
    import re

    from anovos_tpu.data_report.report_generation import anovos_report as jreport
    from anovos_tpu_torch.data_report.report_generation import anovos_report
    from anovos_tpu_torch.obs import write_manifest

    base = tmp_path / "base.json"
    write_manifest(_man({"a": _node(1.0)}, devprof={"a": _dev(1.0)}), str(base))
    monkeypatch.setenv("ANOVOS_PERF_LEDGER", round_ledger)
    monkeypatch.setenv("ANOVOS_RUN_DIFF_BASELINE", str(base))
    tabs = {}
    for name, report in (("port", anovos_report), ("jax", jreport)):
        master = tmp_path / name
        (master / "obs").mkdir(parents=True)
        write_manifest(_man({"a": _node(2.0)}, devprof={"a": _dev(2.0, dispatch=1.2)}),
                       str(master / "obs" / "run_manifest.json"))
        html = open(report(master_path=str(master), final_report_path=str(master))).read()
        names = re.findall(r"onclick='showTab\(\d+\)'>([^<]*)</button>", html)
        bodies = re.findall(r"<section[^>]*>(.*?)</section>", html, flags=re.S)
        tabs[name] = dict(zip(names, bodies))
        assert names[-3:] == ["Run Timings", "Perf Ledger", "Run Diff"], names
    for tab in ("Perf Ledger", "Run Diff"):
        assert tabs["port"][tab] == tabs["jax"][tab]
