"""A ``streaming_analysis`` config through both runners on the CPU: no
``input_dataset`` (the table never materializes), the four sub-analyses
(describe, quality_missing, quality_outlier against a model the port's
in-memory ``outlier_detection`` fitted on one part, drift against a
source folder) over six parquet parts in 2,500-row chunks, each runner in
a working directory of its own.

Held equal to the JAX runner's: the file trees (``obs/`` left out); the
missing and outlier CSVs byte for byte; ``stream_describe.csv`` with
tests/test_torch_streaming.py's bands (counts, extremes and quantiles
exact, moments within 1e-4 + 1e-5 relative); ``stream_drift.csv``'s
metrics within 1e-4 and its flags equal; the drift model's cutoffs within
j ulps of the bin width plus two ulps, its numeric counts equal given the
same cutoffs (a source value between the two packages' cutoffs moves one
count to the next bin) and its categorical frequencies within 1e-6.
Then the port's runner (200-row chunks, so whole parts end on chunk
boundaries) is killed after 200 chunk commits and run again through
``python -m anovos_tpu_torch ... --resume`` (which defaults the node
cache's root to ``.anovos_cache`` there): it writes the uninterrupted run's
files byte for byte and decodes fewer parts.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)
from test_torch_streaming import _assert_describe_close, _assert_drift_frames_close, _assert_drift_models_close, _frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (2000, 2600, 3000, 2200, 2900, 2400)
OUT = ("stream_describe.csv", "stream_missing.csv", "stream_outlier.csv", "stream_drift.csv")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from anovos_tpu_torch.data_analyzer.quality_checker import outlier_detection
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset
    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime("cpu")
    root = tmp_path_factory.mktemp("wf_stream")
    g = np.random.default_rng(9)
    tgt, src, model = root / "tgt", root / "src", root / "outlier_model"
    tgt.mkdir()
    src.mkdir()
    for i, n in enumerate(ROWS):
        _frame(g, i, n).to_parquet(tgt / f"part-{i:05d}.parquet", index=False)
    for i in range(3):
        _frame(g, i, 2500, shift=0.7).to_parquet(src / f"part-{i:05d}.parquet", index=False)
    outlier_detection(read_dataset(str(tgt / "part-00000.parquet"), "parquet"), list_of_cols="a|b|c|d",
                      detection_side="both", model_path=str(model))
    return {"tgt": str(tgt), "src": str(src), "model": str(model), "root": str(root)}


@pytest.fixture(autouse=True)
def _no_leftover_plans():
    """Each runner installs ANOVOS_TPU_CHAOS's plan for the process: clear
    both packages' plans and quarantine registries after every test."""
    yield
    from anovos_tpu.data_ingest import guard as jg
    from anovos_tpu.resilience import chaos as jc
    from anovos_tpu_torch.data_ingest import guard as pg
    from anovos_tpu_torch.resilience import chaos as pc

    for m in (jg, pg, jc, pc):
        m.reset()


def stream_config(data: dict) -> dict:
    return {
        "streaming_analysis": {
            "file_path": data["tgt"], "file_type": "parquet", "chunk_rows": 2500,
            "describe": {},
            "quality_missing": {},
            "quality_outlier": {"model_path": data["model"]},
            "drift": {"source_file_path": data["src"], "method_type": "all"},
        },
        "report_preprocessing": {"master_path": "report_stats"},
    }


def _write_yaml(cfg: dict, path: str) -> str:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


def _tree(root: str, skip=("obs",)) -> list:
    out = []
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if x not in skip)
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


@pytest.fixture(scope="module")
def runs(data):
    """``workflow.run`` of each package on the config, each in its own
    working directory."""
    from anovos_tpu import workflow as jwf
    from anovos_tpu_torch import workflow as pwf

    cfg_path = _write_yaml(stream_config(data), os.path.join(data["root"], "config.yaml"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
        mp.setenv("ANOVOS_INGEST_RETRIES", "0")
        mp.delenv("ANOVOS_TPU_CACHE", raising=False)
        mp.delenv("ANOVOS_TPU_CHAOS", raising=False)
        for name, wf in (("jax", jwf), ("port", pwf)):
            d = os.path.join(data["root"], name)
            os.makedirs(d)
            mp.chdir(d)
            wf.run(cfg_path, "local")
            out[name] = d
    out["block_times"] = pwf.block_times()
    out["degraded"] = pwf.degraded_sections()
    out["cfg_path"] = cfg_path
    return out


def test_file_trees_match_jax(runs):
    got, exp = _tree(runs["port"]), _tree(runs["jax"])
    assert got == exp
    assert sorted(os.path.join("report_stats", f) for f in OUT) == [f for f in got if f.startswith("report_stats")]
    assert any(f.startswith(os.path.join("intermediate_data", "drift_statistics")) for f in got)
    assert runs["degraded"] == {}
    assert set(runs["block_times"]) == {f"streaming_analysis, {s}" for s in
                                        ("describe", "quality_missing", "quality_outlier", "drift")}


@pytest.mark.parametrize("name", OUT)
def test_stream_csvs_match_jax(runs, name):
    gp, ep = (os.path.join(runs[k], "report_stats", name) for k in ("port", "jax"))
    if name in ("stream_missing.csv", "stream_outlier.csv"):
        assert open(gp, "rb").read() == open(ep, "rb").read()
        return
    got, exp = pd.read_csv(gp), pd.read_csv(ep)
    if name == "stream_describe.csv":
        _assert_describe_close(got, exp)
    else:
        _assert_drift_frames_close(got, exp)


def test_drift_model_matches_jax(runs, data):
    _assert_drift_models_close(os.path.join(runs["port"], "intermediate_data"),
                               os.path.join(runs["jax"], "intermediate_data"), data["src"])


def test_checkpoints_under_obs(runs):
    for sub in ("describe", "quality_missing", "quality_outlier", "drift"):
        d = os.path.join(runs["port"], "report_stats", "obs", "stream_ckpt", sub)
        assert os.path.isfile(os.path.join(d, "stream_manifest.json")), sub
        assert os.path.isfile(os.path.join(d, "stream_journal.jsonl")), sub


@pytest.mark.parametrize("bad,match", [
    ({"file_type": "parquet", "describe": {}}, "requires file_path"),
    ({"file_path": "x", "quality_outlier": {"list_of_cols": "a"}}, "requires model_path"),
])
def test_config_errors_match_jax(tmp_path, monkeypatch, bad, match):
    from anovos_tpu import workflow as jwf
    from anovos_tpu_torch import workflow as pwf

    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    monkeypatch.chdir(tmp_path)
    for wf in (jwf, pwf):
        with pytest.raises(TypeError, match=match):
            wf.main({"streaming_analysis": bad}, "local")


def test_killed_run_resumes_through_the_cli(data, tmp_path, monkeypatch):
    """The port's runner at 200-row chunks, uninterrupted in one directory
    and, in another, killed after 200 chunk commits (describe's 152 and 48
    of quality_missing's 76), then ``python -m anovos_tpu_torch <cfg> local
    --resume`` on the CPU there: the four CSVs and the drift model equal
    the uninterrupted run's byte for byte, and fewer parts are decoded
    than the 36 of a fresh run (describe 12, missing 6, outlier 6, drift
    3 + 3 + 6).  The runs are sequential and retry and degrade nothing
    (``ANOVOS_TPU_RETRIES=0``, ``ANOVOS_TPU_DEGRADE=0``), so the exception
    that stands for the kill ends the run, as a kill would, after the
    commits counted in YAML order."""
    from anovos_tpu_torch import workflow as pwf
    from anovos_tpu_torch.ops import streaming

    monkeypatch.setenv("ANOVOS_INGEST_RETRIES", "0")
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    monkeypatch.setenv("ANOVOS_TPU_RETRIES", "0")
    monkeypatch.setenv("ANOVOS_TPU_DEGRADE", "0")
    monkeypatch.delenv("ANOVOS_TPU_CHAOS", raising=False)
    cfg = stream_config(data)
    cfg["streaming_analysis"]["chunk_rows"] = 200
    cfg_path = _write_yaml(cfg, str(tmp_path / "config.yaml"))
    (tmp_path / "ref").mkdir()
    (tmp_path / "run").mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    pwf.main(cfg, "local")
    monkeypatch.chdir(tmp_path / "run")
    orig = streaming.StreamCheckpoint.commit
    state = {"n": 0}

    def bomb(self, pass_no, idx, arrays):
        orig(self, pass_no, idx, arrays)
        state["n"] += 1
        if state["n"] == 200:
            raise RuntimeError("simulated kill")

    monkeypatch.setattr(streaming.StreamCheckpoint, "commit", bomb)
    with pytest.raises(RuntimeError, match="simulated kill"):
        pwf.main(cfg, "local")
    monkeypatch.setattr(streaming.StreamCheckpoint, "commit", orig)

    code = ("import runpy, sys; from anovos_tpu_torch.shared.runtime import init_runtime; "
            "init_runtime('cpu'); from anovos_tpu_torch.data_ingest import data_ingest as di; "
            "orig = di.read_host_frame; reads = []; "
            "di.read_host_frame = lambda files, *a, **k: (reads.extend(files), orig(files, *a, **k))[1]; "
            f"sys.argv = ['anovos_tpu_torch', {cfg_path!r}, 'local', '--resume']; "
            "runpy.run_module('anovos_tpu_torch', run_name='__main__'); print('READS', len(reads))")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", ANOVOS_INGEST_RETRIES="0")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path / "run"), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    # --resume defaults the node cache's root to .anovos_cache in the working
    # directory; the killed run had no cache, so no node restores and the
    # passes resume from their chunk checkpoints
    assert "--resume requested but ANOVOS_TPU_CACHE is unset" not in res.stderr
    assert "records 0 previously committed node result(s)" in res.stderr
    assert len(os.listdir(tmp_path / "run" / ".anovos_cache" / "nodes")) == 4
    reads = int(res.stdout.strip().splitlines()[-1].split()[1])
    assert 0 < reads < 36, reads
    ref = _tree(str(tmp_path / "ref"))
    assert ref == _tree(str(tmp_path / "run"), skip=("obs", ".anovos_cache")) and len(ref) > 4
    for rel in ref:
        a = open(tmp_path / "ref" / rel, "rb").read()
        assert open(tmp_path / "run" / rel, "rb").read() == a, rel


def test_parse_args_accepts_resume():
    from anovos_tpu_torch.__main__ import parse_args

    assert parse_args(["prog", "c.yaml", "local", "--resume"]) == ("c.yaml", "local", {}, True)
    assert parse_args(["prog", "--resume", "c.yaml"]) == ("c.yaml", "local", {}, True)


def test_quarantined_part_reaches_the_manifest_and_registry(data, tmp_path, monkeypatch):
    """With ``ANOVOS_TPU_CHAOS`` corrupting one part on every read, the
    runner's quality_missing pass goes on over the other five; the
    quarantine manifest under ``report_stats/obs`` and the degradation
    registry name the part, as the JAX runner's do."""
    import json

    from anovos_tpu import workflow as jwf
    from anovos_tpu.data_ingest import guard as jg
    from anovos_tpu_torch import workflow as pwf
    from anovos_tpu_torch.data_ingest import guard as pg

    cfg = stream_config(data)
    cfg["streaming_analysis"] = {k: v for k, v in cfg["streaming_analysis"].items()
                                 if k in ("file_path", "file_type", "chunk_rows", "quality_missing")}
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    monkeypatch.setenv("ANOVOS_INGEST_RETRIES", "0")
    monkeypatch.setenv("ANOVOS_TPU_CHAOS", "corrupt@io:*part-00003.parquet:n=99")
    monkeypatch.delenv("ANOVOS_TPU_CACHE", raising=False)
    out = {}
    for name, wf, g in (("jax", jwf, jg), ("port", pwf, pg)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        wf.main(cfg, "local")
        out[name] = (json.load(open(d / "report_stats" / "obs" / "quarantine_manifest.json")),
                     open(d / "report_stats" / "stream_missing.csv", "rb").read())
    assert out["port"] == out["jax"]
    man = out["port"][0]
    assert man["parts"] == 1 and man["rows_lost"] == ROWS[3]
    assert os.path.basename(man["records"][0]["file"]) == "part-00003.parquet"
    assert "ingest/part-00003.parquet" in pwf.degraded_sections()


def test_chip_smoke_streaming_drift_is_configs_full():
    """chip_smoke.py's STREAM_DRIFT is configs_full.yaml's drift_statistics
    options, but the two the streaming pass sets itself (no persisted
    source, the model under intermediate_data)."""
    import chip_smoke
    import yaml

    with open(os.path.join(REPO, "config", "configs_full.yaml")) as f:
        exp = yaml.safe_load(f)["drift_detector"]["drift_statistics"]["configs"]
    assert exp.pop("pre_existing_source") is False and exp.pop("source_path") == "NA"
    assert chip_smoke.STREAM_DRIFT == exp


def test_chip_smoke_phase_13_rehearses_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py phase 13 at 4 target and 2 source parts of 20,000
    rows on the CPU: the CUDA calls stubbed, the plain kernel versions
    wrapped to count launches (they count none); every check (a)-(f) runs
    and B1 and B2 are counted on the path."""
    import torch

    import chip_smoke as cs
    from examples._data import synthesize
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.kernels import histogram, moments

    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "kernel_times", lambda torch, fn, cold=False, iters=0, reps=0:
                        (fn(), {"min": 0.0, "median": 0.0, "max": 0.0, "repeats": []})[1])
    monkeypatch.setattr(cs, "cuda_ms", lambda torch, fn, iters: (fn(), 0.0)[1])
    for mod, attr, kname in ((moments, "masked_moments_plain", "masked_moments"),
                             (histogram, "binned_histograms_plain", "binned_histograms")):
        plain = getattr(mod, attr)

        def counted(*a, plain=plain, kname=kname):
            kernels.LAUNCHES[kname] += 1
            return plain(*a)

        monkeypatch.setattr(mod, attr, counted)
    monkeypatch.setattr(cs, "STREAM_PARTS", 4)
    monkeypatch.setattr(cs, "STREAM_SRC_PARTS", 2)
    monkeypatch.setattr(cs, "STREAM_PART_ROWS", 20_000)
    monkeypatch.setattr(cs, "STREAM_CHUNK", 20_000)
    monkeypatch.delenv("ANOVOS_TPU_CHAOS", raising=False)
    df = synthesize(80_000, seed=0).drop(columns=cs.DROP)
    out = cs.phase_streaming(torch, 0, df, str(tmp_path))
    # describe 4 + drift's source pass 2; drift's source 2 + target 4
    assert out["launches"]["masked_moments"] == 6 and out["launches"]["binned_histograms"] == 6
    assert [p["op"] for p in out["passes"]] == ["describe_streaming", "missing_stats_streaming",
                                                "outlier_stats_streaming", "drift_statistics_streaming"]
    assert out["resume_decodes"] < 2 * 4 and out["drift_max_abs_err"] <= 1e-4
