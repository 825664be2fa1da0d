#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``anovos_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. build: compile every CUDA kernel of the port from ``anovos_tpu_torch/ops/
   kernels/csrc`` (nvcc, sm_90a, through ``torch.utils.cpp_extension``) and
   print the build seconds;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at edge shapes (ragged row counts, an
   all-masked column, a NaN cutoff row, a normal(1e5, 3) column whose first
   row is null), with the kernel's time, the plain version's and the card's
   lower bound;
3. path: the income schema at 4,000,000 rows written as parquet and read
   back with ``read_dataset``, the eleven ``stats_generator`` measures,
   ``drift_stability.statistics`` (PSI/HD/JSD/KS, bin_size 10, no
   sampling) of the second half against the first, once to warm up and
   once timed, and ``stability_index_computation`` over three slices.
   Results are checked against float64 pandas/numpy references, and every
   kernel must have been launched by this phase.

It then prints a ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.
Without a CUDA device it fails and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROWS = 4_000_000
BIN_SIZE = 10
DROP = ["ifa", "dt_1", "dt_2", "empty", "logfnl"]
# NVIDIA H100 SXM data sheet: HBM3 rate and f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    """(least ms, what bounds it) on the card for this many bytes and f32 ops."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_inputs(torch, k: int, rows: int, gen, nbins: int = BIN_SIZE):
    dev = "cuda"
    X = torch.randn((k, rows), generator=gen, device=dev) * 20 + 50
    X[0] = torch.randn((rows,), generator=gen, device=dev) * 3 + 1e5
    X[1] = torch.randn((rows,), generator=gen, device=dev).abs() * 5
    M = torch.rand((k, rows), generator=gen, device=dev) > 0.1
    M[0, 0] = False  # the large-mean column starts with a null
    M[2] = False  # all-masked column
    X = torch.where(M, X, 0.0)  # a null is stored as 0, as in the Table
    cuts = torch.sort(torch.randn((k, nbins - 1), generator=gen, device=dev) * 20 + 50, dim=1).values
    cuts[0] = torch.linspace(1e5 - 6, 1e5 + 6, nbins - 1, device=dev)
    cuts[min(3, k - 1)] = float("nan")  # dead column: every value in bin 0
    return X.contiguous(), M.contiguous(), cuts.contiguous()


def moments_errors(acc: np.ndarray, ref: np.ndarray) -> dict:
    """Errors of the kernel's (8, k) accumulator against the plain one:
    n/min/max/nonzero must be equal; mean, M2, M3, M4 are checked against
    1e-5 relative plus 1e-5 · n · σ^p plus the shift a rounded 2048-row
    tile mean of the plain version gives them (Δ = 4 ulp of the tile sum
    over 2048; n·Δ², 3·Δ·M2 + n·Δ³, 4·Δ·|M3| + 6·Δ²·M2 + n·Δ⁴).  Returns
    the largest error as a share of its allowance per field."""
    a, e = acc.astype(np.float64), ref.astype(np.float64)
    for row, name in ((0, "n"), (5, "min"), (6, "max"), (7, "nonzero")):
        check(np.array_equal(acc[row], ref[row]), f"masked_moments {name} differs from plain")
    n = np.maximum(e[0], 1)
    sigma = np.sqrt(np.maximum(e[2], 0) / n)
    d = 4 * np.spacing(np.abs(e[1] * 2048).astype(np.float32)).astype(np.float64) / 2048
    allow = {
        "mean": 1e-5 * (np.abs(e[1]) + sigma),
        "M2": 1e-5 * np.abs(e[2]) + 1e-5 * n * sigma ** 2 + n * d ** 2,
        "M3": 1e-5 * np.abs(e[3]) + 1e-5 * n * sigma ** 3 + 3 * d * e[2] + n * d ** 3,
        "M4": 1e-5 * np.abs(e[4]) + 1e-5 * n * sigma ** 4 + 4 * d * np.abs(e[3])
        + 6 * d ** 2 * e[2] + n * d ** 4,
    }
    share = {}
    for row, name in ((1, "mean"), (2, "M2"), (3, "M3"), (4, "M4")):
        err = np.abs(a[row] - e[row])
        ok = err <= allow[name] + 1e-30
        check(bool(ok.all()), f"masked_moments {name} off: {err} > {allow[name]}")
        share[name] = float(np.max(err / (allow[name] + 1e-30)))
    return share


def phase_kernels(torch, seed: int, k_num: int) -> dict:
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols, binned_histograms_plain
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain
    from anovos_tpu_torch.ops.reductions import finalize_moments

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = {}

    # edge shapes: ragged against every block size, tiny, one row
    for rows, k in ((1_234_567, 5), (2049, 4), (1, 4)):
        X, M, cuts = kernel_inputs(torch, k, rows, gen)
        h = binned_histograms_cols(X, M, cuts, BIN_SIZE)
        a = masked_moments_cols(X, M)
        torch.cuda.synchronize()
        check(torch.equal(h, binned_histograms_plain(X, M, cuts, BIN_SIZE)),
              f"binned_histograms differs from plain at ({k}, {rows})")
        check(int(h.sum().item()) == int(M.sum().item()), "histogram total != valid count")
        moments_errors(a.cpu().numpy(), masked_moments_plain(X, M).cpu().numpy())
    print(f"kernels: edge shapes ok (ragged rows, all-masked column, NaN cutoffs, mean 1e5)",
          flush=True)

    # binned histogram at the drift path's shape: one side of the 4M-row
    # bench split, every numeric column
    rows_h = ROWS // 2
    X, M, cuts = kernel_inputs(torch, k_num, rows_h, gen)
    got = binned_histograms_cols(X, M, cuts, BIN_SIZE)
    plain = binned_histograms_plain(X, M, cuts, BIN_SIZE)
    check(torch.equal(got, plain), "binned_histograms differs from plain at the path shape")
    ms = cuda_ms(torch, lambda: binned_histograms_cols(X, M, cuts, BIN_SIZE), 50)
    plain_ms = cuda_ms(torch, lambda: binned_histograms_plain(X, M, cuts, BIN_SIZE), 3)
    # bytes: every value and mask byte read once, cutoffs read, counts
    # written; operations: nbins-1 compares for each valid value
    b_ms, b_by = bound(rows_h * k_num * 5 + cuts.numel() * 4 + k_num * BIN_SIZE * 4,
                       int(M.sum().item()) * (BIN_SIZE - 1))
    out["binned_histograms"] = {"max_abs_err": float((got - plain).abs().max().item()),
                                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "library_ms": None,
                                "shape": [k_num, rows_h, BIN_SIZE]}
    print(f"kernel binned_histograms ({k_num} x {rows_h}, {BIN_SIZE} bins): {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library none; exact", flush=True)

    # masked moments at stats_generator's shape: every numeric column of the
    # 4M-row table
    X, M, _ = kernel_inputs(torch, k_num, ROWS, gen)
    acc = masked_moments_cols(X, M)
    check(torch.equal(masked_moments_cols(X, M), acc), "masked_moments differs between two runs")
    ref = masked_moments_plain(X, M)
    share = moments_errors(acc.cpu().numpy(), ref.cpu().numpy())

    def fin(t):
        f = finalize_moments(t[0], t[0] * t[1], t[2], t[3], t[4], t[5], t[6], t[7])
        return torch.stack([f[s] for s in ("mean", "stddev", "skewness", "kurtosis")])

    diff = (fin(acc) - fin(ref)).abs()
    max_err = float(torch.nan_to_num(diff, nan=0.0).max().item())
    ms = cuda_ms(torch, lambda: masked_moments_cols(X, M), 50)
    plain_ms = cuda_ms(torch, lambda: masked_moments_plain(X, M), 2)
    # operations: the Welford update is about 30 f32 operations for each
    # valid value (csrc/moments.cu)
    b_ms, b_by = bound(ROWS * k_num * 5 + 8 * k_num * 4, int(M.sum().item()) * 30)
    out["masked_moments"] = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                             "shape": [k_num, ROWS], "err_share_of_allowance": share}
    print(f"kernel masked_moments ({k_num} x {ROWS}): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), library none; max |Δ| of mean/stddev/skew/kurt "
          f"{max_err:.3g}, error as share of allowance {share}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def reference_psi(src, tgt, bin_size: int) -> dict:
    """PSI per column in float64 numpy/pandas: equal-range cutoffs from the
    source's min/max, searchsorted side='left', counts over all rows,
    0 → 1e-4 smoothing (bench.py's pandas loop, the reference algorithm)."""
    import pandas as pd

    out = {}
    for col in src.columns:
        s, t = src[col], tgt[col]
        if pd.api.types.is_numeric_dtype(s):
            lo, hi = s.min(), s.max()
            cuts = [lo + j * (hi - lo) / bin_size for j in range(1, bin_size)]
            sb = np.searchsorted(cuts, s.to_numpy(), side="left")
            tb = np.searchsorted(cuts, t.to_numpy(), side="left")
            p = np.bincount(sb[~s.isna().to_numpy()], minlength=bin_size) / len(s)
            q = np.bincount(tb[~t.isna().to_numpy()], minlength=bin_size) / len(t)
        else:
            cats = sorted(set(s.dropna().astype(str)) | set(t.dropna().astype(str)))
            p = s.dropna().astype(str).value_counts().reindex(cats).fillna(0).to_numpy() / len(s)
            q = t.dropna().astype(str).value_counts().reindex(cats).fillna(0).to_numpy() / len(t)
        p = np.where(p <= 0, 1e-4, p)
        q = np.where(q <= 0, 1e-4, q)
        out[col] = float(((p - q) * np.log(p / q)).sum())
    return out


def check_stats(df, frames: dict, num_cols, cat_cols) -> None:
    """The eleven measures against float64 pandas on the same frame."""
    for name, f in frames.items():
        check(len(f) > 0, f"stats {name}: empty frame")
    counts = frames["measures_of_counts"].set_index("attribute")
    for c in df.columns:
        check(int(counts.loc[c, "fill_count"]) == int(df[c].notna().sum()), f"fill_count of {c}")
    uniq = frames["uniqueCount_computation"].set_index("attribute")
    for c in num_cols + cat_cols:
        exp = df[c].dropna().astype(str).nunique() if c in cat_cols else df[c].nunique()
        check(int(uniq.loc[c, "unique_values"]) == int(exp), f"unique_values of {c}")
    cen = frames["measures_of_centralTendency"].set_index("attribute")
    disp = frames["measures_of_dispersion"].set_index("attribute")
    pct = frames["measures_of_percentiles"].set_index("attribute")
    for c in num_cols:
        v = df[c].dropna().to_numpy(np.float64)
        m, sd = v.mean(), v.std(ddof=1)
        check(abs(cen.loc[c, "mean"] - m) <= 1e-4 + 1e-5 * abs(m), f"mean of {c}: {cen.loc[c, 'mean']} vs {m}")
        check(abs(disp.loc[c, "stddev"] - sd) <= 1e-4 + 1e-4 * sd, f"stddev of {c}")
        check(pct.loc[c, "min"] == np.round(v.min(), 4) and pct.loc[c, "max"] == np.round(v.max(), 4),
              f"min/max of {c}")
    modes = frames["mode_computation"].set_index("attribute")
    for c in cat_cols:
        vc = df[c].dropna().astype(str).value_counts()
        best = sorted(vc.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        check(modes.loc[c, "mode"] == best[0] and int(modes.loc[c, "mode_rows"]) == best[1],
              f"mode of {c}")
    shape = frames["measures_of_shape"]
    check(bool(np.isfinite(shape[["skewness", "kurtosis"]].to_numpy(np.float64)).all()),
          "skewness/kurtosis not finite")


def phase_path(torch, seed: int) -> dict:
    import pandas as pd

    from examples._data import synthesize
    from anovos_tpu_torch.data_analyzer import stats_generator as sg
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset
    from anovos_tpu_torch.drift_stability import stability_index_computation, statistics
    from anovos_tpu_torch.drift_stability.drift_detector import drift_device_args
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.drift_kernels import drift_side_full

    t0 = time.perf_counter()
    df = synthesize(ROWS, seed=seed).drop(columns=DROP)
    t_synth = time.perf_counter() - t0
    out = {"rows": ROWS, "synth_s": t_synth}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "income")
        os.makedirs(data_dir)
        df.to_parquet(os.path.join(data_dir, "part-00000.parquet"), index=False)

        kernels.reset_launches()
        t0 = time.perf_counter()
        table = read_dataset(data_dir, "parquet")
        torch.cuda.synchronize()
        out["ingest_s"] = time.perf_counter() - t0
        check(table.nrows == ROWS and table.col_names == list(df.columns), "read_dataset shape")
        num_cols, cat_cols, _ = table.attribute_type_segregation()
        print(f"path: read {ROWS} rows x {table.ncols} columns ({len(num_cols)} numeric) "
              f"in {out['ingest_s']:.2f} s", flush=True)

        t0 = time.perf_counter()
        frames = {fn: getattr(sg, fn)(table) for fn in (
            "global_summary", "missingCount_computation", "nonzeroCount_computation",
            "measures_of_counts", "mode_computation", "measures_of_centralTendency",
            "uniqueCount_computation", "measures_of_cardinality", "measures_of_dispersion",
            "measures_of_percentiles", "measures_of_shape")}
        out["stats_s"] = time.perf_counter() - t0
        check_stats(df, frames, num_cols, cat_cols)
        print(f"path: stats_generator, 11 measures, {out['stats_s']:.2f} s; checked against pandas",
              flush=True)

        half = ROWS // 2
        src, tgt = table.slice_rows(0, half), table.slice_rows(half, ROWS)
        statistics(tgt, src, method_type="all", bin_size=BIN_SIZE, use_sampling=False,
                   source_path=os.path.join(tmp, "warm"))
        t0 = time.perf_counter()
        odf = statistics(tgt, src, method_type="all", bin_size=BIN_SIZE, use_sampling=False,
                         source_path=os.path.join(tmp, "run"))
        out["psi_wall_s"] = time.perf_counter() - t0
        out["psi_drift_rows_per_sec"] = ROWS / out["psi_wall_s"]
        ref = reference_psi(df.iloc[:half].reset_index(drop=True),
                            df.iloc[half:].reset_index(drop=True), BIN_SIZE)
        got = dict(zip(odf["attribute"], odf["PSI"]))
        check(set(got) == set(ref), f"drift columns {sorted(got)} != {sorted(ref)}")
        psi_err = max(abs(got[c] - ref[c]) for c in ref)
        check(psi_err <= 1e-4, f"PSI off the float64 reference by {psi_err}")
        out["psi_max_abs_err_vs_float64"] = psi_err
        for m in ("HD", "JSD", "KS"):
            check(bool(np.isfinite(odf[m].to_numpy(np.float64)).all()), f"{m} not finite")

        print(f"path: drift statistics (4 methods, {len(odf)} columns) {out['psi_wall_s']:.3f} s "
              f"wall, {out['psi_drift_rows_per_sec']:.1f} rows/s; PSI within {psi_err:.2e} "
              f"of float64", flush=True)

        thirds = [(i * ROWS // 3, (i + 1) * ROWS // 3) for i in range(3)]
        t0 = time.perf_counter()
        si = stability_index_computation(*[table.slice_rows(a, b) for a, b in thirds],
                                         appended_metric_path=os.path.join(tmp, "si"))
        out["stability_s"] = time.perf_counter() - t0
        check(list(si["attribute"]) == num_cols, "stability columns")
        hist = pd.read_csv(os.path.join(tmp, "si", "part-00000.csv"))
        for (i, (a, b)) in enumerate(thirds):
            for c in num_cols:
                v = df[c].iloc[a:b].dropna().to_numpy(np.float64)
                row = hist[(hist["idx"] == i + 1) & (hist["attribute"] == c)].iloc[0]
                check(abs(row["mean"] - v.mean()) <= 1e-5 * (abs(v.mean()) + v.std()),
                      f"stability mean of {c}, slice {i}")
                check(abs(row["stddev"] - v.std(ddof=1)) <= 1e-4 * v.std(ddof=1) + 1e-6,
                      f"stability stddev of {c}, slice {i}")
        print(f"path: stability_index_computation over 3 slices {out['stability_s']:.2f} s; "
              f"moments checked against pandas", flush=True)
        out["launches"] = dict(kernels.LAUNCHES)
        for name, n in out["launches"].items():
            check(n > 0, f"kernel {name} was not launched on the main path")
        print(f"path: kernel launches {out['launches']}", flush=True)

        # after the path: the device part of a drift run alone, both sides'
        # histogram pass on resident data (not counted as path launches)
        args_t, args_s = drift_device_args(tgt, src, BIN_SIZE)
        out["psi_device_ms"] = cuda_ms(
            torch, lambda: (drift_side_full(*args_t), drift_side_full(*args_s)), 10)
        print(f"path: drift device pass (both sides) {out['psi_device_ms']:.3f} ms", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.kernels import build
    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    build.load(verbose=True)
    build_s = time.perf_counter() - t0
    print(f"build: {len(build.SOURCES)} sources, one extension module, in {build_s:.2f} s",
          flush=True)

    k_num = 9  # numeric columns of the income schema after the bench's drops
    kres = phase_kernels(torch, args.seed, k_num)
    path = phase_path(torch, args.seed)
    print("path " + json.dumps({k: v for k, v in path.items() if k != "launches"}), flush=True)

    rows = []
    for kname, meta in kernels.KERNELS.items():
        r = kres[kname]
        rows.append({"name": kname, "route": meta["route"], "source": meta["source"],
                     "replaces": meta["replaces"], "launches": path["launches"][kname],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
