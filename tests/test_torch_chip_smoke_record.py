"""``chip_smoke.py`` phases 9 and 16 rehearsed on the CPU at 5,000 rows
(16's runs at 2,000): the CUDA calls stubbed, ``init_runtime("cuda")``
mapped to the CPU, the plain kernel versions wrapped to count launches
and to open a profiler range named after their CUDA kernel (the CPU
profiler records no device kernels, so the phase reads those ranges in
their place), and the devprof drain given a wall (a CPU runtime drains
nothing).  Every check of phase 16 runs: phase 9's manifest, the two
sequential runs' stable views, and the traced, profiled run's lanes,
devprof parts, launching nodes, h2d bytes against the inputs, profiler
ranges and re-rendered report (the drain probe, a device sleep, runs on the
card only, and the CPU profiler records no copies to a device, so the
trace's host-to-device bytes are stubbed)."""

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)


def test_chip_smoke_phase_16_rehearses_on_the_cpu(monkeypatch, tmp_path):
    import torch

    import chip_smoke as cs
    from anovos_tpu_torch.obs import devprof
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.kernels import histogram, moments
    from anovos_tpu_torch.shared import runtime

    real_init = runtime.init_runtime
    monkeypatch.setattr(runtime, "init_runtime", lambda device="cuda": real_init("cpu"))
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
            kernels.count_launch(kname)
            with torch.profiler.record_function(cs.PROFILE_KERNEL_NAMES[kname]):
                return plain(*a)

        monkeypatch.setattr(mod, attr, counted)
    monkeypatch.setattr(cs, "PROFILE_KERNEL_CAT", "user_annotation")
    monkeypatch.setattr(devprof, "_drain_wall", lambda stream=None: 0.001)
    monkeypatch.setattr(cs, "drain_probe", lambda torch: {})  # a device sleep: the card only
    monkeypatch.setattr(cs, "traced_htod", lambda path: (2**62, 0))
    for name, value in (("RUNNER_ROWS", 5000), ("RUNNER_SIDE_ROWS", 5000), ("RECORD_ROWS", 2000)):
        monkeypatch.setattr(cs, name, value)
    for knob in ("ANOVOS_TPU_EXECUTOR", "ANOVOS_TPU_CHAOS", "ANOVOS_TPU_TRACE", "ANOVOS_TPU_DEVPROF",
                 "ANOVOS_PROFILE"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR_WORKERS", "4")
    root = str(tmp_path)
    runner = cs.phase_runner(torch, 0, root)
    assert runner["schedule"]["mode"] == "concurrent"
    out = cs.phase_record(torch, runner, runner["launches"], root)
    assert set(out["runner"]["devprof"]) == set(runner["schedule"]["deps"])
    assert out["launches"]["masked_moments"] == 2 and out["launches"]["binned_histograms"] == 1
    traced = out["traced"]
    assert traced["mode"] == "concurrent" and traced["h2d_bytes"] >= traced["h2d_least_bytes"] > 0
    assert traced["launching_nodes"] == {"masked_moments": ["anovos_basic_report"],
                                         "binned_histograms": ["anovos_basic_report"]}
    assert traced["profile"]["masked_moments"]["count"] == 2
    assert not (tmp_path / "record").exists()
