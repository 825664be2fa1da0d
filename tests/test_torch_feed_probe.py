"""The fold-wall probe of the ``feed-30d`` incremental leg
(``anovos_tpu_torch/resilience/feed_probe.py``) on the CPU, at a small
feed: every day gets a split, the split fits inside the fold, and the
instruments are put back."""

import os

import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401


def test_probe_splits_each_fold_and_puts_the_instruments_back(tmp_path, torch_cpu_runtime):  # noqa: F811
    from anovos_tpu_torch.continuum import state, watcher
    from anovos_tpu_torch.data_ingest import guard, prefetch
    from anovos_tpu_torch.obs import flight
    from anovos_tpu_torch.resilience import feed_probe

    # from a disarmed recorder and no quarantine record, as in a fresh
    # process (an earlier test of the worker may have left either)
    flight.reset()
    guard.reset()
    before = (os.fsync, watcher._fold_keys, state.ContinuumState.part_partials,
              state.ContinuumState.commit_part, prefetch.DecodePool.fetch)
    rows = feed_probe.incremental_leg(21, 64, str(tmp_path))
    assert (os.fsync, watcher._fold_keys, state.ContinuumState.part_partials,
            state.ContinuumState.commit_part, prefetch.DecodePool.fetch) == before
    assert not flight.enabled() and not guard.records()
    assert [r["day"] for r in rows] == list(range(1, 22))
    for r in rows:
        assert r["fold"] > 0
        assert r["fetch"] + r["partials"] + r["commit"] <= r["fold"] * 1.05 + 1.0, r
        assert r["fsync"] <= r["commit"] + 0.5, r
    corrupt = rows[19]  # day 20 is garbage bytes: quarantined, nothing folds
    assert corrupt["partials"] == corrupt["commit"] == 0
    assert all(r["partials"] > 0 and r["commit"] > 0 for r in rows if r["day"] != 20)
    s = feed_probe.summary(rows)
    assert s["day2_ms"] == rows[1]["fold"] and s["last_ms"] == rows[-1]["fold"]
    assert s["ratio"] == pytest.approx(rows[-1]["fold"] / rows[1]["fold"], rel=1e-2)
    assert all(r["day"] not in (1, 20) for r in s["spikes"])


def test_probe_cli_prints_each_rep(tmp_path, capsys, torch_cpu_runtime):  # noqa: F811
    import json

    from anovos_tpu_torch.resilience import feed_probe

    out = tmp_path / "rows.json"
    assert feed_probe.main(["--reps", "1", "--days", "3", "--rows-per-day", "32", "--device", "cpu",
                            "--json", str(out)]) == 0
    assert capsys.readouterr().out.startswith("rep 0: day 2 ")
    reps = json.loads(out.read_text())
    assert len(reps) == 1 and [r["day"] for r in reps[0]] == [1, 2, 3]
