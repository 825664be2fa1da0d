"""``chip_smoke.py`` phases 9, 10d and 15 rehearsed on the CPU at 5,000
rows: the CUDA calls stubbed, ``init_runtime("cuda")`` mapped to the CPU,
the plain kernel versions wrapped to count launches (they count none).
Phase 9 and 10d run in the default (concurrent) mode; every check of 15a
(the recommender on both weight-free backends, "card" against CPU), 15b
(both configs again in the sequential mode: the same bytes, schedule and
launches) and 15c (a chaos hang degraded by the watchdog, here under a
10 s bound) runs."""

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)


def test_chip_smoke_phase_15_rehearses_on_the_cpu(monkeypatch, tmp_path):
    import torch

    import chip_smoke as cs
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
            return plain(*a)

        monkeypatch.setattr(mod, attr, counted)
    for name, value in (("RUNNER_ROWS", 5000), ("RUNNER_SIDE_ROWS", 5000), ("FULL_ROWS", 5000),
                        ("CHAOS_ROWS", 5000), ("CHAOS_TIMEOUT", 10)):
        monkeypatch.setattr(cs, name, value)
    for knob in ("ANOVOS_TPU_EXECUTOR", "ANOVOS_TPU_CHAOS", "FR_BACKEND"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR_WORKERS", "4")
    root = str(tmp_path)
    runner = cs.phase_runner(torch, 0, root)
    full = cs.phase_full_runner(torch, 0, root)
    assert runner["schedule"]["mode"] == full["schedule"]["mode"] == "concurrent"
    out = cs.phase_executor(torch, 0, runner, full, root)
    for backend in ("tfidf", "hashed"):
        rec = out["recommender"]["backends"][backend]
        assert rec["calls"] == 27 and rec["cosine_max_abs_err"] == 0.0
        assert rec["top_match"]["cust_age"]
    for what, launches in (("configs_basic", {"masked_moments": 2, "binned_histograms": 1}),
                           ("configs_full", {"masked_moments": 8, "binned_histograms": 3})):
        seq = out["sequential"][what]
        assert seq["files_equal"] > 60
        for mode in ("sequential", "concurrent"):
            assert {k: seq[mode]["launches"][k] for k in launches} == launches, (what, mode)
    chaos = out["chaos"]
    assert chaos["bound_s"] == 25.0 and 24.9 <= chaos["degraded_after_s"] <= 27.0
    assert chaos["schedule"]["mode"] == "concurrent"
