"""``chip_smoke.py`` phase 18 (the live plane) rehearsed on the CPU at
5,000 and 2,000 rows, as ``tests/test_torch_cache_chip_smoke.py``
rehearses phase 17: the CUDA calls stubbed, the plain kernel versions
wrapped to count launches, the card's memory gauges and backend name
stood in for, a device sleep a host sleep, ``.cuda()`` the identity;
the runs here are short, so the trace rotates every 50 ms (on the card
every 4 spans), the scraper polls every 10 ms, and the hang's
node_timeout is 2 s; a host sleep as long as the card's device sleep
(3 s) slows the report in (c).  Every check
of the phase runs: the C3 block, the scrapes, the launches inside the
scraped window and against their plain versions, the segments against an
uninterrupted export, the tree, the two dumps of the hang, and the
doctor's diagnosis through ``python -m anovos_tpu_torch.obs.diffing``.
No thread of the phase outlives it."""

import time

from _torch_port import assert_no_thread_left, thread_names, torch_cpu_runtime  # noqa: F401


def test_chip_smoke_phase_18_rehearses_on_the_cpu(monkeypatch, tmp_path):
    import torch

    import chip_smoke as cs
    from anovos_tpu_torch.obs import flight, metrics
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.kernels import histogram, moments

    before = thread_names()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: time.sleep(cycles / 2e9), raising=False)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    monkeypatch.setattr(metrics, "memory_by_device",
                        lambda: {"cuda:0": {"bytes_in_use": 1 << 20, "peak_bytes_in_use": 1 << 21}})
    monkeypatch.setattr(flight, "_backend", lambda: "cuda")
    for mod, attr, kname in ((moments, "masked_moments_plain", "masked_moments"),
                             (histogram, "binned_histograms_plain", "binned_histograms")):
        plain = getattr(mod, attr)

        def counted(*a, plain=plain, kname=kname):
            kernels.count_launch(kname)
            return plain(*a)

        monkeypatch.setattr(mod, attr, counted)
    for name, value in (("RUNNER_ROWS", 5000), ("RUNNER_SIDE_ROWS", 5000), ("RECORD_ROWS", 2000),
                        ("LIVE_ROTATE", "0.05s"), ("LIVE_HANG_TIMEOUT", 2),
                        ("LIVE_SCRAPE_PERIOD_S", 0.01)):
        monkeypatch.setattr(cs, name, value)
    for knob in ("ANOVOS_TPU_EXECUTOR", "ANOVOS_TPU_CHAOS", "ANOVOS_TPU_TRACE", "ANOVOS_TPU_DEVPROF",
                 "ANOVOS_PROFILE", "ANOVOS_TPU_CACHE", "ANOVOS_TPU_TELEMETRY", "ANOVOS_TPU_TRACE_ROTATE"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR_WORKERS", "4")
    root = str(tmp_path)
    _, _, main_dir, join_dir = cs.runner_inputs(torch, 0, root)
    sub = tmp_path / "record_income"
    sub.mkdir()
    import pandas as pd

    pd.read_parquet(main_dir).iloc[:cs.RECORD_ROWS].to_parquet(sub / "part-00000.parquet", index=False)
    with cs.executor(None):
        ref = cs.run_measured(torch, cs.basic_config(str(sub), join_dir), str(tmp_path / "reference"))
    out = cs.phase_live_plane(torch, {"tree": ref["tree"]}, {"main_dir": main_dir, "join_dir": join_dir}, root)
    assert out["c3_block"]["finalized"] == {"variance": "inf", "stddev": "inf", "skewness": "nan",
                                            "kurtosis": "nan"}
    assert out["launches"]["masked_moments"] == 4 and out["launches"]["binned_histograms"] == 2
    assert out["a"]["trace"]["segments"] >= cs.LIVE_MIN_SEGMENTS
    assert out["b"]["dumps"] == ["flightrec_anovos_basic_report.json", "flightrec_anovos_basic_report_2.json"]
    assert out["c"]["diagnosis"]["top"]["kind"] == "phase"
    assert "anovos_basic_report" in out["c"]["scraped"]["doctor_slow"]
    assert not (tmp_path / "live_plane").exists()
    assert_no_thread_left(before)
