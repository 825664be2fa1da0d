"""The port's prefetch pool and chunk checkpoints
(``anovos_tpu_torch/data_ingest/prefetch.py``, ``ops/streaming.py``):

* the controller, the env knobs and the resume skip plan against the JAX
  package's on the same inputs;
* the streaming passes equal with the pool off (0 workers) and on (3),
  through the spill tier, and at windows 1 and ``auto`` (whose high-water
  mark bounds the chunks in flight);
* a quarantined part skipped through the pool as on the consumer's thread;
* a run killed after a few chunk commits and resumed: describe, quality
  and drift each give the uninterrupted result and decode fewer parts; a
  part whose readability changed between the runs invalidates the chunks
  after it.

Knobs are set with ``monkeypatch.setenv`` only (both packages read them
at call time; xdist shares processes).
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.obs import get_metrics
    from anovos_tpu_torch.resilience import chaos

    monkeypatch.setenv("ANOVOS_INGEST_RETRIES", "0")
    # a real pool whatever the box's cpu count
    monkeypatch.setenv("ANOVOS_STREAM_DECODE_WORKERS", "3")
    guard.reset()
    chaos.reset()
    get_metrics().reset()
    yield
    guard.reset()
    chaos.reset()


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    d = tmp_path_factory.mktemp("prefetch_parts")
    rng = np.random.default_rng(3)
    for i in range(5):
        pd.DataFrame({
            "a": np.where(rng.random(2048) < 0.1, np.nan, rng.normal(i, 2.0, 2048)),
            "b": rng.exponential(5.0, 2048),
            "c": rng.choice(["x", "y", "z"], 2048),
        }).to_parquet(d / f"part-{i:05d}.parquet", index=False)
    src = tmp_path_factory.mktemp("prefetch_src")
    for i in range(3):
        pd.DataFrame({
            "a": rng.normal(i, 2.0, 2048),
            "b": rng.exponential(4.0, 2048),
            "c": rng.choice(["x", "y"], 2048),
        }).to_parquet(src / f"part-{i:05d}.parquet", index=False)
    return {"tgt": str(d), "src": str(src)}


# ----------------------------------------------------------------------
# controller, knobs, skip plan: equal to the JAX package's
# ----------------------------------------------------------------------
def _signals(seed):
    g = np.random.default_rng(seed)
    return [(float(f), float(d), 1.0) for f, d in zip(g.choice([0.0, 0.05, 0.5], 60),
                                                       g.choice([0.0, 0.05, 0.5], 60))]


@pytest.mark.parametrize("window,workers", [(None, None), (3, 2), (None, 0), (4, None)])
def test_controller_moves_like_jax(window, workers):
    from anovos_tpu.data_ingest import prefetch as jp
    from anovos_tpu_torch.data_ingest import prefetch as pp

    pc = pp.StreamController(window_spec=window, workers_spec=workers)
    jc = jp.StreamController(window_spec=window, workers_spec=workers)
    for sig in _signals(7) + [(1.0, 0.0, 1.0)] * 20 + [(0.0, 1.0, 1.0)] * 40:
        pc.observe(*sig)
        jc.observe(*sig)
        assert (pc.window, pc.workers, pc.resizes, pc.label) == (jc.window, jc.workers, jc.resizes, jc.label)
    if window is None and workers is None:
        assert pc.window == 2 and pc.resizes > 0


@pytest.mark.parametrize("knob,values", [
    ("ANOVOS_STREAM_INFLIGHT", ["auto", "", "6", "0", "junk"]),
    ("ANOVOS_STREAM_DECODE_WORKERS", ["auto", "", "0", "5", "-2", "junk"]),
    ("ANOVOS_STREAM_SPILL_DIR", ["", "/tmp/spill"]),
])
def test_env_knobs_parse_like_jax(monkeypatch, knob, values):
    from anovos_tpu.data_ingest import prefetch as jp
    from anovos_tpu_torch.data_ingest import prefetch as pp

    fn = {"ANOVOS_STREAM_INFLIGHT": "stream_window_spec", "ANOVOS_STREAM_DECODE_WORKERS":
          "decode_workers_spec", "ANOVOS_STREAM_SPILL_DIR": "spill_dir_spec"}[knob]
    for v in values:
        monkeypatch.setenv(knob, v)
        assert getattr(pp, fn)() == getattr(jp, fn)(), v
    monkeypatch.delenv(knob)
    assert getattr(pp, fn)() == getattr(jp, fn)()


def test_available_cpus_is_the_schedulers():
    from anovos_tpu.parallel.scheduler import available_cpus as jcpus
    from anovos_tpu_torch.data_ingest.prefetch import available_cpus

    assert available_cpus() == jcpus()


@pytest.mark.parametrize("rows,skip,chunk", [
    ({f"f{i}": 2048 for i in range(5)}, range(5), 2048),
    ({f"f{i}": 2048 for i in range(5)}, {0, 1}, 2048),
    ({**{f"f{i}": 2048 for i in range(5)}, "f1": 1000}, range(5), 2048),
    ({f"f{i}": 2048 for i in range(1, 5)}, range(5), 2048),
    ({f"f{i}": 1000 for i in range(5)}, range(3), 500),
    ({f"f{i}": 3000 for i in range(5)}, {0, 1, 2, 5}, 1000),
    ({**{f"f{i}": 2048 for i in range(5)}, "f2": 0}, range(5), 2048),
])
def test_plan_file_skips_matches_jax(rows, skip, chunk):
    from anovos_tpu.data_ingest.prefetch import plan_file_skips as jplan
    from anovos_tpu_torch.data_ingest.prefetch import plan_file_skips

    files = [f"f{i}" for i in range(5)]
    assert plan_file_skips(files, rows, frozenset(skip), chunk) == jplan(files, rows, frozenset(skip), chunk)


# ----------------------------------------------------------------------
# the pool: parity, spill, residency, quarantine
# ----------------------------------------------------------------------
def _passes(parts, tmp, chunk_rows=1024):
    from anovos_tpu_torch.data_analyzer import quality_checker as qc
    from anovos_tpu_torch.drift_stability import drift_detector as dd
    from anovos_tpu_torch.ops.streaming import describe_streaming

    return (describe_streaming(parts["tgt"], "parquet", chunk_rows=chunk_rows),
            qc.missing_stats_streaming(parts["tgt"], "parquet", chunk_rows=chunk_rows),
            dd.statistics_streaming(parts["tgt"], "parquet", parts["src"], method_type="all",
                                    chunk_rows=chunk_rows, source_path=str(tmp)))


def test_pool_parity_0_and_3_workers(parts, tmp_path, monkeypatch):
    from anovos_tpu_torch.ops.streaming import last_stream_summary

    monkeypatch.setenv("ANOVOS_STREAM_DECODE_WORKERS", "0")
    sync = _passes(parts, tmp_path / "m0")
    assert last_stream_summary()["workers"] == 0
    monkeypatch.setenv("ANOVOS_STREAM_DECODE_WORKERS", "3")
    pooled = _passes(parts, tmp_path / "m3")
    assert last_stream_summary()["workers"] >= 3
    for a, b in zip(sync, pooled):
        pd.testing.assert_frame_equal(a, b)


def test_spill_tier_round_trip(parts, tmp_path, monkeypatch):
    from anovos_tpu_torch.ops.streaming import describe_streaming, last_stream_summary

    monkeypatch.setenv("ANOVOS_STREAM_DECODE_WORKERS", "0")
    ref = describe_streaming(parts["tgt"], "parquet", chunk_rows=1024)
    spill = tmp_path / "spill"
    monkeypatch.setenv("ANOVOS_STREAM_DECODE_WORKERS", "4")
    monkeypatch.setenv("ANOVOS_STREAM_INFLIGHT", "1")  # a tiny window: frames spill
    monkeypatch.setenv("ANOVOS_STREAM_SPILL_DIR", str(spill))
    got = describe_streaming(parts["tgt"], "parquet", chunk_rows=1024)
    pd.testing.assert_frame_equal(ref, got)
    assert last_stream_summary()["spilled"] > 0
    assert not [p for p in spill.rglob("*") if p.is_file()]  # cleaned up with the pools


def test_residency_bound_window_1_and_auto(parts, monkeypatch):
    from anovos_tpu_torch.data_ingest.prefetch import _AUTO_WINDOW_CAP
    from anovos_tpu_torch.obs import get_metrics
    from anovos_tpu_torch.ops.streaming import describe_streaming

    monkeypatch.setenv("ANOVOS_STREAM_INFLIGHT", "1")
    r1 = describe_streaming(parts["tgt"], "parquet", chunk_rows=1024)
    assert get_metrics().gauge("stream_inflight_high_water").value(window="1") == 1
    monkeypatch.setenv("ANOVOS_STREAM_INFLIGHT", "auto")
    ra = describe_streaming(parts["tgt"], "parquet", chunk_rows=1024)
    hwa = get_metrics().gauge("stream_inflight_high_water").value(window="auto")
    assert hwa is not None and 1 <= hwa <= _AUTO_WINDOW_CAP
    pd.testing.assert_frame_equal(r1, ra)


def test_quarantined_part_skips_through_pool(parts, monkeypatch):
    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.ops.streaming import describe_streaming
    from anovos_tpu_torch.resilience import chaos

    ref = describe_streaming(parts["tgt"], "parquet", chunk_rows=1024)
    chaos.install("corrupt@io:*part-00002.parquet:n=99")  # decoded on a pool worker
    got = describe_streaming(parts["tgt"], "parquet", chunk_rows=1024)
    assert int(got.set_index("attribute").loc["b", "count"]) == 4 * 2048
    assert [os.path.basename(r.file) for r in guard.records()] == ["part-00002.parquet"]
    chaos.reset()
    guard.reset()
    monkeypatch.setenv("ANOVOS_STREAM_DECODE_WORKERS", "0")
    chaos.install("corrupt@io:*part-00002.parquet:n=99")
    pd.testing.assert_frame_equal(got, describe_streaming(parts["tgt"], "parquet", chunk_rows=1024))
    assert not ref.equals(got)


def test_raise_mode_propagates_through_the_stream(parts, monkeypatch):
    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.ops.streaming import describe_streaming
    from anovos_tpu_torch.resilience import chaos

    monkeypatch.setenv("ANOVOS_INGEST_ON_CORRUPT", "raise")
    chaos.install("corrupt@io:*part-00001.parquet:n=99")
    with pytest.raises(guard.IngestError):
        describe_streaming(parts["tgt"], "parquet", chunk_rows=1024)
    assert guard.records() == []


# ----------------------------------------------------------------------
# kill after a few commits, then resume
# ----------------------------------------------------------------------
def _bomb_commit(monkeypatch, after):
    from anovos_tpu_torch.ops import streaming

    orig = streaming.StreamCheckpoint.commit
    state = {"n": 0}

    def bomb(self, pass_no, idx, arrays):
        orig(self, pass_no, idx, arrays)
        state["n"] += 1
        if state["n"] == after:
            raise RuntimeError("simulated mid-stream kill")

    monkeypatch.setattr(streaming.StreamCheckpoint, "commit", bomb)
    return orig


def _counting_reads(monkeypatch):
    from anovos_tpu_torch.data_ingest import data_ingest

    reads = []
    orig = data_ingest.read_host_frame

    def counting(files, *a, **k):
        reads.extend(files)
        return orig(files, *a, **k)

    monkeypatch.setattr(data_ingest, "read_host_frame", counting)
    return reads


@pytest.mark.parametrize("which,after,fresh_reads", [
    ("describe", 2, 10),   # 5 files x 2 passes
    ("quality", 2, 5),     # one pass
    ("drift", 10, 11),     # 3 source files x 2 passes + 5 target files; killed in the target pass
])
def test_kill_resume_under_prefetch(parts, tmp_path, monkeypatch, which, after, fresh_reads):
    from anovos_tpu_torch.data_analyzer import quality_checker as qc
    from anovos_tpu_torch.drift_stability import drift_detector as dd
    from anovos_tpu_torch.ops import streaming

    def run(ck=None, resume=False, mp="m"):
        if which == "describe":
            return streaming.describe_streaming(parts["tgt"], "parquet", chunk_rows=2048,
                                                checkpoint_dir=ck, resume=resume)
        if which == "quality":
            return qc.missing_stats_streaming(parts["tgt"], "parquet", chunk_rows=2048,
                                              checkpoint_dir=ck, resume=resume)
        return dd.statistics_streaming(parts["tgt"], "parquet", parts["src"], method_type="all",
                                       chunk_rows=2048, source_path=str(tmp_path / mp),
                                       checkpoint_dir=ck, resume=resume)

    ref = run(mp="m1")
    ck = str(tmp_path / "ck")
    orig = _bomb_commit(monkeypatch, after)
    with pytest.raises(RuntimeError, match="simulated"):
        run(ck=ck, mp="m2")
    monkeypatch.setattr(streaming.StreamCheckpoint, "commit", orig)
    reads = _counting_reads(monkeypatch)
    res = run(ck=ck, resume=True, mp="m3")
    pd.testing.assert_frame_equal(res, ref)
    assert 0 < len(reads) < fresh_reads, reads
    events = [json.loads(line) for line in open(os.path.join(ck, "stream_journal.jsonl"))]
    assert {"run_begin", "chunk_begin", "chunk_commit"} <= {e["event"] for e in events}
    if which == "drift":
        # the resumed run wrote the same model as the uninterrupted one
        for sub in ("attribute_binning/part-00000.parquet", "frequency_counts/a/part-00000.csv"):
            a = open(tmp_path / "m1" / "drift_statistics" / sub, "rb").read()
            assert a == open(tmp_path / "m3" / "drift_statistics" / sub, "rb").read()


def test_resume_invalidates_chunks_after_readability_change(parts, tmp_path):
    """Run 1 quarantines the middle part (same bytes, a transient fault)
    and commits every chunk over the other four; the resumed run 2 reads
    it: the chunks from index 2 on shifted, so their partials are dropped
    and recomputed, and the result is the clean one."""
    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.ops import streaming
    from anovos_tpu_torch.resilience import chaos

    ref = streaming.describe_streaming(parts["tgt"], "parquet", chunk_rows=2048)
    ck = str(tmp_path / "ck3")
    chaos.install("corrupt@io:*part-00002.parquet:n=99")
    degraded = streaming.describe_streaming(parts["tgt"], "parquet", chunk_rows=2048, checkpoint_dir=ck)
    assert int(degraded.set_index("attribute").loc["a", "count"]) < int(ref.set_index("attribute").loc["a", "count"])
    chaos.reset()
    guard.reset()
    res = streaming.describe_streaming(parts["tgt"], "parquet", chunk_rows=2048, checkpoint_dir=ck, resume=True)
    pd.testing.assert_frame_equal(res, ref)
    events = [json.loads(line) for line in open(os.path.join(ck, "stream_journal.jsonl"))]
    assert any(e["event"] == "chunks_invalidated" and e["from_chunk"] == 2 for e in events)


def test_checkpoint_of_another_stream_is_not_resumed(parts, tmp_path):
    """Another chunk size is another stream: the checkpoint starts afresh
    and the result is that chunking's uninterrupted one."""
    from anovos_tpu_torch.ops import streaming

    ck = str(tmp_path / "ck2")
    streaming.describe_streaming(parts["tgt"], "parquet", chunk_rows=2048, checkpoint_dir=ck)
    b = streaming.describe_streaming(parts["tgt"], "parquet", chunk_rows=1024, checkpoint_dir=ck, resume=True)
    pd.testing.assert_frame_equal(b, streaming.describe_streaming(parts["tgt"], "parquet", chunk_rows=1024))
