"""``chip_smoke.py`` phase 17 (the node cache) rehearsed on the CPU after
phases 9 and 16 at 5,000 and 2,000 rows, as
``tests/test_torch_chip_smoke_record.py`` rehearses phase 16: the CUDA
calls stubbed, ``init_runtime("cuda")`` mapped to the CPU, the plain
kernel versions wrapped to count launches, and the phase's two CLI
processes put on the CPU runtime.  Every check of the phase runs: the
populate run's misses, launches and tree; the full hit's hits, zero
launches and tree; the incremental run's cone, launches and tree against
an uncached run of the edited config; the kill and ``--resume``; the
sweep."""

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)


def test_chip_smoke_phase_17_rehearses_on_the_cpu(monkeypatch, tmp_path):
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
    monkeypatch.setattr(cs, "CACHE_CLI_PRELUDE", "from anovos_tpu_torch.shared.runtime import init_runtime; "
                                                 "init_runtime('cpu'); ")
    for name, value in (("RUNNER_ROWS", 5000), ("RUNNER_SIDE_ROWS", 5000), ("RECORD_ROWS", 2000)):
        monkeypatch.setattr(cs, name, value)
    for knob in ("ANOVOS_TPU_EXECUTOR", "ANOVOS_TPU_CHAOS", "ANOVOS_TPU_TRACE", "ANOVOS_TPU_DEVPROF",
                 "ANOVOS_PROFILE", "ANOVOS_TPU_CACHE", "ANOVOS_TPU_CACHE_MAX_BYTES"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR_WORKERS", "4")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # the CLI processes
    root = str(tmp_path)
    runner = cs.phase_runner(torch, 0, root)
    record = cs.phase_record(torch, runner, runner["launches"], root)
    out = cs.phase_node_cache(torch, record, runner, root)
    assert out["launches"]["masked_moments"] == 4 and out["launches"]["binned_histograms"] == 2
    assert out["hit"]["launches"] == {k: 0 for k in out["hit"]["launches"]}
    assert out["kill_resume"]["cache"]["resumed_from"] == 2
    assert out["sweep"]["after_bytes"] <= out["sweep"]["before_bytes"] // 2
    assert not (tmp_path / "node_cache").exists()
