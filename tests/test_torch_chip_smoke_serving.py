"""``chip_smoke.py`` phase 19 (serving) rehearsed on the CPU, as
``tests/test_torch_chip_smoke_live.py`` rehearses phase 18: the CUDA calls
stubbed (``synchronize``, ``.cuda()`` the identity, the kernel timers,
``nvidia-smi``), the plain kernel versions wrapped to count launches, and
the sizes cut (3,000 fit rows, 4 clients of 5 requests, the smoke CLI at
300 rows).  Every check of the phase runs: B1 launched by the fit and held
to its plain version, the warm-up's buckets, the load's byte parity with no
launch and no new segment after the warm-up, the hostile payloads, the
serve-fault gates, the smoke CLI; no thread of the phase outlives it."""

from _torch_port import assert_no_thread_left, thread_names, torch_cpu_runtime  # noqa: F401


def test_chip_smoke_phase_19_rehearses_on_the_cpu(monkeypatch):
    import torch

    import chip_smoke as cs
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.kernels import histogram, moments

    before = thread_names()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    monkeypatch.setattr(cs, "on_card", lambda tables, tensors=(): True)
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
    for name, value in (("SERVE_FIT_ROWS", 3000), ("SERVE_SRC_ROWS", 1000), ("SERVE_CLIENTS", 4),
                        ("SERVE_REQUESTS", 5),
                        ("SERVE_SMOKE_ARGS", ("smoke", "--telemetry", "--rows", "300", "--clients", "2",
                                              "--requests", "5"))):
        monkeypatch.setattr(cs, name, value)
    for knob in ("ANOVOS_TPU_CHAOS", "ANOVOS_TPU_TELEMETRY", "ANOVOS_TPU_TRACE_ROTATE", "ANOVOS_TPU_DEVPROF",
                 "ANOVOS_SERVE_BATCH_WINDOW_MS", "ANOVOS_SERVE_MAX_BATCH", "ANOVOS_SERVE_BF16"):
        monkeypatch.delenv(knob, raising=False)
    out = cs.phase_serving(torch, 0)
    exp = out["launches"]["serving_export"]
    assert exp["masked_moments"] > 0 and exp["binned_histograms"] == 0 == exp["neighbor_counts"]
    assert not any(out["launches"]["serving_warm"].values()) and not any(out["launches"]["serving_load"].values())
    assert out["a"]["held"]["b1_share_of_allowance"] <= 1.0
    assert out["kernels"]["masked_moments"][0]["path"] == "serving_export"
    assert out["b"]["warm"]["buckets"] == [8, 16, 32, 64, 128, 256]
    assert out["c"]["requests"] == 20 and out["c"]["p99_ms"] is not None
    assert out["d"]["refused"] == 9 and len(out["d"]["codes"]) == 5
    assert all(out["e"]["gates"].values()) and out["e"]["injections"] == 3
    assert out["f"]["serve_requests"] == 10
    assert cs.serving_leftovers() == []
    assert_no_thread_left(before)
