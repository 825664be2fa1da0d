"""``chip_smoke.py`` phase 21 (the data-plane and continuum chaos
scenarios) rehearsed on the CPU, as ``tests/test_torch_chip_smoke_serving.py``
rehearses phase 19: the CUDA calls stubbed (``synchronize``, the kernel
timers, ``nvidia-smi``) and the plain kernel versions wrapped to count
launches.  Every check of the phase runs at the scenarios' own sizes but
the two timed bounds (the slow-read chaos wall, day 30's fold against day
2's), which are widened here: they are sub-second comparisons that a
loaded test worker can tip, and the card holds them in the phase itself.
The rehearsal checks the launches of each path, that B1 and B2 are held to
their plain versions at the phase's three shapes, and that the phase
leaves no chaos plan, quarantine record, degraded section, armed flight
recorder or ``anovos-torch-*`` thread behind."""

from _torch_port import assert_no_thread_left, thread_names, torch_cpu_runtime  # noqa: F401


def test_chip_smoke_phase_21_rehearses_on_the_cpu(monkeypatch):
    import torch

    import chip_smoke as cs
    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.obs import flight
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.kernels import histogram, moments
    from anovos_tpu_torch.resilience import chaos, policy, scenarios

    before = thread_names()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "kernel_times", lambda torch, fn, cold=False, **k: (
        fn(), {"min": 0.0, "median": 0.0, "max": 0.0, "repeats": [0.0]})[1])
    monkeypatch.setattr(cs, "cuda_ms", lambda torch, fn, iters: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "card_line", lambda: "CPU rehearsal, no card")
    for mod, attr, kname in ((moments, "masked_moments_plain", "masked_moments"),
                             (histogram, "binned_histograms_plain", "binned_histograms")):
        def counted(*a, plain=getattr(mod, attr), kname=kname):
            kernels.count_launch(kname)
            return plain(*a)

        monkeypatch.setattr(mod, attr, counted)
    monkeypatch.setattr(scenarios, "SLOWREAD_SHARE", 1e6)
    monkeypatch.setattr(scenarios, "FEED_FOLD_RATIO", 1e6)
    for knob in ("ANOVOS_TPU_CHAOS", "ANOVOS_TPU_CACHE", "ANOVOS_TPU_EXECUTOR", "ANOVOS_STREAM_INFLIGHT",
                 "ANOVOS_STREAM_DECODE_WORKERS"):
        monkeypatch.delenv(knob, raising=False)
    out = cs.phase_dataplane_chaos(torch, 0)
    la, lb, lc = (out["launches"][p] for p in ("dataplane_corrupt_ingest", "dataplane_slowread_stream",
                                               "dataplane_feed_30d"))
    assert la["masked_moments"] > 0 and la["binned_histograms"] > 0
    # eight 2,048-row chunks a leg, one launch each
    assert lb["masked_moments"] == 16 and lb["binned_histograms"] == 0
    assert lc["masked_moments"] > 0 and lc["binned_histograms"] > 0
    assert not any(v["neighbor_counts"] for v in out["launches"].values())
    shapes = [(r["path"], r["shape"]) for rows in out["kernels"].values() for r in rows]
    assert shapes == [("dataplane_corrupt_ingest", [2, 750]), ("dataplane_slowread_stream", [2, 2048]),
                      ("dataplane_feed_30d", [2, 500]),
                      ("dataplane_corrupt_ingest", [1, 750, 10]), ("dataplane_feed_30d", [2, 500, 10])]
    assert out["a"]["surviving_rows"] == 750 and out["a"]["injections"] == 5
    assert out["b"]["injections"] >= 12 and out["b"]["stream_workers"] == 4
    assert out["c"]["continuum_shift_alert_day"] == 25
    assert chaos.plan() is None and not guard.records() and not policy.degraded_sections() and not flight.enabled()
    assert_no_thread_left(before)
