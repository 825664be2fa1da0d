#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``anovos_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. build: compile every CUDA kernel of the port from ``anovos_tpu_torch/ops/
   kernels/csrc`` (one nvcc a source for sm_90a, all at once, loaded with
   ctypes), print each kernel's registers and spills, the build seconds and
   the instructions a pair of the neighbour-count kernel's pair loop (its
   SASS, where the toolkit has ``cuobjdump``);
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at unaligned row counts (≡ 1, 2, 3 mod 4,
   1,333,333 among them; an all-masked column, a NaN cutoff row, a
   normal(1e5, 3) column whose first row is null), the moments kernel twice
   at every shape with bit-identical results; each kernel's time as 5
   repeats of 50 launches (min, median, max), warm and with L2 flushed
   before each launch, beside the plain version's time and the card's
   lower bound;
3. path: the income schema at 4,000,000 rows written as parquet and read
   back with ``read_dataset``, the eleven ``stats_generator`` measures,
   ``drift_stability.statistics`` (PSI/HD/JSD/KS, bin_size 10, no
   sampling) of the second half against the first, once to warm up and
   once timed, and ``stability_index_computation`` over three slices.
   Results are checked against float64 pandas/numpy references, and every
   kernel of this path must have been launched by this phase;
4. geo kernels: the DBSCAN neighbour-count kernel equal to its plain version
   at the shapes of the JAX package's Pallas test and at its edges (every
   width 1-8; n = 1, below one source split, a query tile and a split ± 1,
   last splits ragged against the unroll; eps² = 0 on duplicated points,
   an eps beyond the set's diameter, the spacing-eps lattice; NaN,
   infinite and overflowing points and a non-finite eps², which take the
   literal form; calls at changing n), then at 100,000 points with its time
   (5 repeats of 50 launches), the plain version's and the card's lower
   bound;
5. geo path: a 1,000,000-row table of six Gaussian cities (σ = 0.3°) and 2%
   uniform noise, with a lat/lon pair (1% nulls), a precision-7 geohash of
   the same points and an id, written as parquet and read back with
   ``read_dataset``; ``geospatial_autodetection`` with the default knobs
   (host connected components, no neighbour-count launch), the same call
   with ``ANOVOS_DBSCAN_GRID_SAMPLE=16384`` (one neighbour-count launch per
   eps, the batched device labeling) and ``generate_loc_charts_controller``.
   Then the kernels at the shapes and on the data this path gave them (the
   moments kernel on the lat/lon block, the neighbour-count kernel on the
   centred 16,384-point grid sample at every eps) against their plain
   versions, timed.  The neighbour counts and the DBSCAN labels of every
   combo are checked against float64 numpy/scipy, the k-means centers
   against a float64 Lloyd run from the same start, and every expected
   file must exist.

It then prints a ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.
Without a CUDA device it fails and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROWS = 4_000_000
BIN_SIZE = 10
DROP = ["ifa", "dt_1", "dt_2", "empty", "logfnl"]
GEO_ROWS = 1_000_000
GEO_RECORDS = 100_000  # geospatial_autodetection's max_analysis_records default
GEO_B3_SAMPLE = 16_384
GEO_EPS = "0.3,0.5,0.05"
GEO_MIN_SAMPLES = "500,1100,100"
# the kernels each path must launch
PATH_KERNELS = {"income": ("masked_moments", "binned_histograms"),
                "geo_default": ("masked_moments",),
                "geo_grid_16384": ("masked_moments", "neighbor_counts")}
# NVIDIA H100 SXM data sheet: HBM3 rate and f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# kernel timing: repeats of back-to-back launches; the cold-L2 flush buffer
TIME_REPS = 5
TIME_ITERS = 50
COLD_BYTES = 128 * 2**20
# a device sleep (clock cycles, about 10 ms) that the timed launches queue
# behind
QUEUE_CYCLES = 20_000_000
# f32 operations of kernel B1 a value read (csrc/moments.cu push_step, an
# FMA counted as two, as the peak rate counts it): 3 for the count and the
# first valid value, 3 for the step sum, 16 for the centred powers, min,
# max and nonzero, and about 2 for the step's division and Chan merge.  The
# mask selects rather than branches, so masked values cost the same.
B1_OPS_PER_VALUE = 24
# unaligned row counts the kernels are checked at (≡ 1, 2, 3 mod 4, none a
# multiple of 16), with their column counts: the stability slices of the
# 4M-row path, a ragged shape, one row past a B1 work item, a tiny one
UNALIGNED = ((1_333_333, 9), (1_333_334, 9), (1_234_567, 5), (16_387, 3), (4_098, 5),
             (2_049, 4), (7, 4), (1, 4))


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


def kernel_times(torch, fn, cold: bool = False, iters: int = TIME_ITERS,
                 reps: int = TIME_REPS) -> dict:
    """Device time of ``fn`` a launch as ``reps`` repeats of ``iters``
    launches: their min, median and max (ms), and every repeat.  ``fn``
    must not wait for the device.

    Warm: the launches run back to back, timed together, so inputs that fit
    the 50 MB L2 stay there.  Cold: before each launch, outside its timed
    window, a 128 MB buffer is written, so the launch finds its inputs in
    device memory, as the drift caller does after building its inputs.
    Either way the launches are queued behind a device sleep, so the
    device never waits for the host's wrapper calls: the time is the
    device's."""
    fn()
    torch.cuda.synchronize()
    flush = torch.empty(COLD_BYTES // 4, dtype=torch.float32, device="cuda") if cold else None
    per = []
    for _ in range(reps):
        evs = []
        torch.cuda._sleep(QUEUE_CYCLES)
        for _ in range(iters if cold else 1):
            if cold:
                flush.fill_(1.0)
                torch.cuda._sleep(QUEUE_CYCLES // 100)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(1 if cold else iters):
                fn()
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        per.append(sum(a.elapsed_time(b) for a, b in evs) / iters)
    return {"min": min(per), "median": float(np.median(per)), "max": max(per), "repeats": per}


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time a call of ``fn`` (µs) on a shape whose device time is
    negligible: what a wrapper call costs the host, checks, allocation and
    launch included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def spread(t: dict) -> str:
    return f"{t['median']:.5f} ms (min {t['min']:.5f}, max {t['max']:.5f})"


def bound(nbytes: float, ops: float):
    """(least ms, what bounds it) on the card for this many bytes and f32 ops.

    The f32 rate is the data sheet's, which counts an FMA as two
    operations, so a kernel that issues i instructions for work the bound
    counts as o operations can come no closer to it than o / (2 i): for
    B3, (2d + 3) / (2 x its instructions a pair)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b3_loop_sass(lib_path: str):
    """Instructions of B3's folded pair loop at d = 2 (``count_kernel<2>``
    in csrc/neighbor_counts.cu), from ``cuobjdump -sass`` of the built
    library: of the loops (a backward branch and the code from its target
    to it), the one with the most FFMA, which issues one FFMA a pair.
    Returns its pairs, instructions, instructions a pair, opcode mix and
    text, or None where the toolkit has no cuobjdump."""
    from anovos_tpu_torch.ops.kernels import build

    exe = shutil.which("cuobjdump") or os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.isfile(exe):
        return None
    sass = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass)
                if "count_kernelILi2E" in f.split("\n", 1)[0])
    code, labels = [], {}  # (address, opcode, text); label -> address of what follows
    for line in body.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            labels[label.group(1)] = None
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", line)
        if m:
            addr = int(m.group(1), 16)
            for name, at in labels.items():
                labels[name] = addr if at is None else at
            code.append((addr, m.group(2), line.split(";")[0].strip() + " ;"))
    best = None
    for addr, op, text in code:
        if op != "BRA":
            continue
        t = re.search(r"\((\.L_x_\d+)\)", text)
        target = labels.get(t.group(1)) if t else None
        if target is None:
            h = re.search(r"BRA\s+(?:`\()?0x([0-9a-f]+)", text)
            target = int(h.group(1), 16) if h else None
        if target is None or target > addr:
            continue
        loop = [c for c in code if target <= c[0] <= addr]
        if best is None or sum(c[1] == "FFMA" for c in loop) > sum(c[1] == "FFMA" for c in best):
            best = loop
    if best is None:
        return None
    ops = [c[1] for c in best]
    pairs = ops.count("FFMA")
    return {"pairs": pairs, "instructions": len(ops),
            "per_pair": len(ops) / pairs if pairs else None,
            "mix": {op: ops.count(op) for op in sorted(set(ops))}, "text": [c[2] for c in best]}


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


def b2_bound(k: int, rows: int, nbins: int, valid: int):
    """B2's least time: bytes, every value and mask byte read once, the
    cutoffs read and the counts written; operations, a compare and an add
    for each cutoff and value read (the mask selects, it does not branch)
    and one count for each valid value."""
    return bound(rows * k * 5 + k * (nbins - 1) * 4 + k * nbins * 4,
                 rows * k * 2 * (nbins - 1) + valid)


def b1_bound(k: int, rows: int):
    """B1's least time: bytes, every value and mask byte read once and 32
    bytes a column written; operations, B1_OPS_PER_VALUE a value read."""
    return bound(rows * k * 5 + 8 * k * 4, rows * k * B1_OPS_PER_VALUE)


def check_moments_twice(torch, X, M, what: str):
    """B1 on (X, M) twice: the two results are the same bits; returns one."""
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols

    a = masked_moments_cols(X, M)
    b = masked_moments_cols(X, M)
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"masked_moments differs between two runs at {what}")
    return a


def phase_kernels(torch, seed: int, k_num: int) -> dict:
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols, binned_histograms_plain
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain
    from anovos_tpu_torch.ops.reductions import finalize_moments

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = {}

    # unaligned row counts: every column after the first starts off the
    # 16-byte grid (all-masked column, NaN cutoffs, mean 1e5 in each)
    for rows, k in UNALIGNED:
        X, M, cuts = kernel_inputs(torch, k, rows, gen)
        h = binned_histograms_cols(X, M, cuts, BIN_SIZE)
        a = check_moments_twice(torch, X, M, f"({k}, {rows})")
        check(torch.equal(h, binned_histograms_plain(X, M, cuts, BIN_SIZE)),
              f"binned_histograms differs from plain at ({k}, {rows})")
        check(int(h.sum().item()) == int(M.sum().item()), "histogram total != valid count")
        moments_errors(a.cpu().numpy(), masked_moments_plain(X, M).cpu().numpy())
    print("kernels: unaligned shapes ok, rows " + ", ".join(str(r) for r, _ in UNALIGNED)
          + " (all-masked column, NaN cutoffs, mean 1e5; B1 bit-identical over two runs)", flush=True)

    # binned histogram at the drift path's shape: one side of the 4M-row
    # bench split, every numeric column
    rows_h = ROWS // 2
    X, M, cuts = kernel_inputs(torch, k_num, rows_h, gen)
    got = binned_histograms_cols(X, M, cuts, BIN_SIZE)
    plain = binned_histograms_plain(X, M, cuts, BIN_SIZE)
    check(torch.equal(got, plain), "binned_histograms differs from plain at the path shape")
    warm = kernel_times(torch, lambda: binned_histograms_cols(X, M, cuts, BIN_SIZE))
    cold = kernel_times(torch, lambda: binned_histograms_cols(X, M, cuts, BIN_SIZE), cold=True)
    plain_ms = cuda_ms(torch, lambda: binned_histograms_plain(X, M, cuts, BIN_SIZE), 3)
    b_ms, b_by = b2_bound(k_num, rows_h, BIN_SIZE, int(M.sum().item()))
    out["binned_histograms"] = {"max_abs_err": float((got - plain).abs().max().item()),
                                "ms": warm["median"], "plain_ms": plain_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "library_ms": None, "warm": warm, "cold": cold,
                                "shape": [k_num, rows_h, BIN_SIZE]}
    print(f"kernel binned_histograms ({k_num} x {rows_h}, {BIN_SIZE} bins): warm {spread(warm)}, "
          f"cold L2 {spread(cold)}, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
          f"library none; exact", flush=True)

    # masked moments at stats_generator's shape: every numeric column of the
    # 4M-row table
    X, M, _ = kernel_inputs(torch, k_num, ROWS, gen)
    acc = check_moments_twice(torch, X, M, "the path shape")
    ref = masked_moments_plain(X, M)
    share = moments_errors(acc.cpu().numpy(), ref.cpu().numpy())

    def fin(t):
        f = finalize_moments(t[0], t[0] * t[1], t[2], t[3], t[4], t[5], t[6], t[7])
        return torch.stack([f[s] for s in ("mean", "stddev", "skewness", "kurtosis")])

    diff = (fin(acc) - fin(ref)).abs()
    max_err = float(torch.nan_to_num(diff, nan=0.0).max().item())
    warm = kernel_times(torch, lambda: masked_moments_cols(X, M))
    cold = kernel_times(torch, lambda: masked_moments_cols(X, M), cold=True)
    plain_ms = cuda_ms(torch, lambda: masked_moments_plain(X, M), 2)
    b_ms, b_by = b1_bound(k_num, ROWS)
    out["masked_moments"] = {"max_abs_err": max_err, "ms": warm["median"], "plain_ms": plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                             "warm": warm, "cold": cold, "shape": [k_num, ROWS],
                             "err_share_of_allowance": share}
    print(f"kernel masked_moments ({k_num} x {ROWS}): warm {spread(warm)}, cold L2 {spread(cold)}, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), library none; max |Δ| of "
          f"mean/stddev/skew/kurt {max_err:.3g}, error as share of allowance {share}", flush=True)

    # masked moments at a stability slice's shape (3 of the path's 4 launches)
    rows_s = ROWS // 3
    X, M, _ = kernel_inputs(torch, k_num, rows_s, gen)
    warm = kernel_times(torch, lambda: masked_moments_cols(X, M))
    cold = kernel_times(torch, lambda: masked_moments_cols(X, M), cold=True)
    b_ms, b_by = b1_bound(k_num, rows_s)
    out["masked_moments"]["other_shapes"] = [{"path": "stability", "shape": [k_num, rows_s],
                                              "ms": warm["median"], "bound_ms": b_ms,
                                              "bound_by": b_by, "warm": warm, "cold": cold}]
    print(f"kernel masked_moments at a stability slice ({k_num} x {rows_s}): warm {spread(warm)}, "
          f"cold L2 {spread(cold)}, bound {b_ms:.5f} ms ({b_by})", flush=True)

    X, M, cuts = kernel_inputs(torch, 4, 1000, gen)
    out["masked_moments"]["host_us"] = host_us(torch, lambda: masked_moments_cols(X, M))
    out["binned_histograms"]["host_us"] = host_us(
        torch, lambda: binned_histograms_cols(X, M, cuts, BIN_SIZE))
    print(f"kernels: host time a wrapper call at (4, 1000): masked_moments "
          f"{out['masked_moments']['host_us']:.2f} µs, binned_histograms "
          f"{out['binned_histograms']['host_us']:.2f} µs", flush=True)
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
        for name in PATH_KERNELS["income"]:
            check(out["launches"][name] > 0, f"kernel {name} was not launched on the main path")
        print(f"path: kernel launches {out['launches']}", flush=True)

        # after the path: the device part of a drift run alone, both sides'
        # histogram pass on resident data (not counted as path launches)
        args_t, args_s = drift_device_args(tgt, src, BIN_SIZE)
        out["psi_device_ms"] = cuda_ms(
            torch, lambda: (drift_side_full(*args_t), drift_side_full(*args_s)), 10)
        print(f"path: drift device pass (both sides) {out['psi_device_ms']:.3f} ms", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 4: the neighbour-count kernel against its plain version
# ---------------------------------------------------------------------------
def blob_points(n: int, seed: int, d: int = 2) -> np.ndarray:
    """Four 0.3-sd blobs in a ±40 box of width d (the JAX package's Pallas
    test at d = 2), centred in numpy f32 as ops/cluster.py centres them."""
    g = np.random.default_rng(seed)
    X = (g.uniform(-40, 40, (4, d))[g.integers(0, 4, n)] + g.normal(0, 0.3, (n, d))).astype(np.float32)
    return X - X.mean(axis=0, keepdims=True)


def neighbor_counts_bound(n: int, d: int):
    """Bytes: the points read once, the counts written once.  Operations:
    2d + 3 for each of the n² pairs, the least the function needs (d
    products and d − 1 sums of the dot, the doubling folded into the
    subtraction of |q|², the addition of |x|², the compare, the count).
    The kernel issues 6 instructions a pair at d = 2 (csrc/neighbor_counts.cu
    and phase 1's SASS count), a ceiling of 7/12 of this bound."""
    return bound(n * (d + 1) * 4, n * n * (2 * d + 3))


def time_neighbor_counts(torch, Xc, eps2: float, what: str) -> dict:
    """B3 on the card against its plain version on ``Xc``: equal counts,
    then both timed."""
    from anovos_tpu_torch.ops.kernels.neighbor_counts import neighbor_counts_plain, neighbor_counts_rows

    n, d = Xc.shape
    got = neighbor_counts_rows(Xc, eps2)
    plain = neighbor_counts_plain(Xc, eps2)
    check(torch.equal(got, plain), f"neighbor_counts differs from plain at {what}")
    warm = kernel_times(torch, lambda: neighbor_counts_rows(Xc, eps2))
    plain_ms = cuda_ms(torch, lambda: neighbor_counts_plain(Xc, eps2), 3)
    b_ms, b_by = neighbor_counts_bound(n, d)
    return {"max_abs_err": float((got - plain).abs().max().item()), "ms": warm["median"],
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "warm": warm, "shape": [n, d]}


def b3_edge_cases(seed: int):
    """(what, points, eps²) at B3's edges: its launch shape (from the card's
    plan), its data and its inputs that take the literal form."""
    from anovos_tpu_torch.ops.kernels.neighbor_counts import launch_plan

    e16 = float(np.float32(0.4 * 0.4))
    for d in range(1, 9):
        yield f"d={d}", blob_points(3001, seed + d, d), float(np.float32(0.2 * d))
    tile = launch_plan(1, 2, "cuda")[3]
    split = launch_plan(GEO_B3_SAMPLE, 2, "cuda")[2]
    ragged = {}
    for n in range(GEO_B3_SAMPLE - 384, GEO_B3_SAMPLE + 416):
        _, splits, length, _ = launch_plan(n, 2, "cuda")
        if splits > 1:
            ragged.setdefault((n - (splits - 1) * length) % 8, n)
    check({0, 1, 7} <= set(ragged), f"no ragged last split found near {GEO_B3_SAMPLE}: {ragged}")
    sizes = sorted({1, 50, tile - 1, tile + 1, split - 1, split + 1, ragged[0], ragged[1], ragged[7]})
    for n in sizes:
        yield f"n={n}", blob_points(n, seed + n, 2), e16
    g = np.random.default_rng(seed)
    dup = blob_points(1500, seed, 2)[g.integers(0, 1500, 5000)]
    yield "eps2=0, duplicated points", dup, 0.0
    yield "duplicated points", dup, e16
    yield "eps beyond the diameter", dup, float(np.float32(1e4))
    i, j = np.meshgrid(np.arange(40), np.arange(30), indexing="ij")
    lat = (np.stack([i.ravel(), j.ravel()], 1) * 0.125 + g.uniform(-3, 3, (1, 2))).astype(np.float32)
    yield "spacing-eps lattice", lat - lat.mean(axis=0, keepdims=True), float(np.float32(0.125 ** 2))
    # 2·dot overflows where two points near (1.2e19, 1.2e19) meet
    for what, rows in (("a NaN point", {7: np.nan}), ("an infinite point", {11: np.inf}),
                       ("an overflowing dot", {0: 1.2e19, 1: 1.25e19, 2: -1.2e19})):
        X = blob_points(3000, seed, 2)
        for r, v in rows.items():
            X[r] = v
        yield what, X, e16
    yield "an infinite eps2", blob_points(3000, seed, 2), float("inf")


def phase_geo_kernels(torch, seed: int) -> dict:
    from anovos_tpu_torch.ops.kernels.neighbor_counts import neighbor_counts_plain, neighbor_counts_rows

    for n, eps in ((3000, 0.4), (1024, 0.05), (1500, 50.0), (257, 0.3)):
        Xc = torch.from_numpy(blob_points(n, seed + n)).cuda()
        eps2 = float(np.float32(eps * eps))
        got = neighbor_counts_rows(Xc, eps2)
        torch.cuda.synchronize()
        check(torch.equal(got, neighbor_counts_plain(Xc, eps2)),
              f"neighbor_counts differs from plain at n={n}, eps={eps}")
    print("kernels: neighbor_counts equal to plain at the Pallas test's shapes", flush=True)
    edges = []
    for what, X, eps2 in b3_edge_cases(seed):
        Xc = torch.from_numpy(np.ascontiguousarray(X)).cuda()
        got = neighbor_counts_rows(Xc, eps2)
        torch.cuda.synchronize()
        check(torch.equal(got, neighbor_counts_plain(Xc, eps2)), f"neighbor_counts differs from plain at {what}")
        if what == "eps2=0, duplicated points":
            _, inv, mult = np.unique(X, axis=0, return_inverse=True, return_counts=True)
            check(bool((got.cpu().numpy() >= mult[inv.ravel()]).all()), "eps2=0: a point misses a duplicate")
        if what == "eps beyond the diameter":
            check(bool((got == len(X)).all()), "eps beyond the diameter: a count is not n")
        edges.append(what)
    print(f"kernels: neighbor_counts equal to plain at {len(edges)} edge cases: {'; '.join(edges)}", flush=True)

    n, eps = 100_000, 0.4
    r = time_neighbor_counts(torch, torch.from_numpy(blob_points(n, seed)).cuda(),
                             float(np.float32(eps * eps)), f"n={n}")
    r["data"] = f"four blobs, eps {eps}"
    print(f"kernel neighbor_counts ({n} x 2, eps {eps}): {spread(r['warm'])}, plain {r['plain_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library none; exact", flush=True)
    return r


# ---------------------------------------------------------------------------
# phase 5: the geospatial path
# ---------------------------------------------------------------------------
def geo_frame(seed: int):
    """GEO_ROWS rows: six city centres at least 3 degrees apart in a
    continental box, points around them with σ = 0.3°, 2% uniform noise
    over the box, lat/lon with 1% nulls each, a precision-7 geohash of the
    same points (the port's encoder) and an id."""
    import pandas as pd

    from anovos_tpu_torch.data_transformer.geo_utils import geohash_encode

    g = np.random.default_rng(seed)
    centers = []
    while len(centers) < 6:
        c = (g.uniform(28, 46), g.uniform(-120, -75))
        if all(np.hypot(c[0] - a, c[1] - b) >= 3 for a, b in centers):
            centers.append(c)
    pts = np.asarray(centers)[g.integers(0, 6, GEO_ROWS)] + g.normal(0, 0.3, (GEO_ROWS, 2))
    noise = g.random(GEO_ROWS) < 0.02
    pts[noise] = np.stack([g.uniform(25, 49, noise.sum()), g.uniform(-124, -71, noise.sum())], 1)
    lat, lon = pts[:, 0].copy(), pts[:, 1].copy()
    gh = np.array([geohash_encode(a, o, 7) for a, o in zip(lat.tolist(), lon.tolist())], object)
    lat[g.random(GEO_ROWS) < 0.01] = np.nan
    lon[g.random(GEO_ROWS) < 0.01] = np.nan
    return pd.DataFrame({"id": np.arange(GEO_ROWS), "latitude": lat, "longitude": lon, "geohash": gh})


def geo_files(lat: str, lon: str, gh: str, charts_only: bool = False):
    pair, names = f"{lat}_{lon}", []
    for field in (pair, gh):
        names += [f"geo_scatter_{field}", f"geo_heat_{field}"]
    if not charts_only:
        names += ["geospatial_stats.csv", f"geospatial_overall_{pair}.csv", f"geospatial_top_{pair}.csv",
                  f"geospatial_overall_{gh}.csv", f"geospatial_top_{gh}.csv"]
        names += [f"{pre}_{kind}_{pair}.csv" for pre in ("geospatial", "cluster_output")
                  for kind in ("kmeans", "dbscan")]
    return names


def kmeans_float64_check(pts: np.ndarray, km) -> dict:
    """The k-means centers of ``km`` (the analyzer's frame) against a
    float64 Lloyd run over the same points from the same start, with the
    JAX package's stopping rule."""
    from anovos_tpu_torch.ops.cluster import kmeans_init_indices

    X = np.asarray(pts, np.float32).astype(np.float64)
    k = len(km)
    C = X[kmeans_init_indices(len(X), k, 0).numpy()]
    for _ in range(50):
        lbl = ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1).argmin(1)
        cnt = np.bincount(lbl, minlength=k)
        sums = np.stack([np.bincount(lbl, weights=X[:, j], minlength=k) for j in range(2)], 1)
        Cn = np.where(cnt[:, None] > 0, sums / np.maximum(cnt, 1)[:, None], C)
        moved = bool((np.abs(Cn - C) > 1e-6 * (1 + np.abs(C))).any())
        C = Cn
        if not moved:
            break
    cnt = np.bincount(((X[:, None, :] - C[None, :, :]) ** 2).sum(-1).argmin(1), minlength=k)
    err = float(np.abs(km[["lat_center", "lon_center"]].to_numpy(np.float64) - C).max())
    check(err <= 1e-4, f"k-means centers off the float64 Lloyd run by {err}")
    return {"k": k, "center_max_abs_err": err,
            "count_diff": int(np.abs(km["count"].to_numpy() - cnt).sum())}


def dbscan_float64_check(sub: np.ndarray, eps_values, ms_eff, db) -> dict:
    """On the grid sample ``sub`` of the B3 route, against float64 numpy and
    scipy.

    Counts: each eps's neighbour counts (kernel B3) may differ from the
    float64 counts only by band pairs, pairs whose float64 d² lies within
    tol = 8 f32 ulps of |q|² + |x|² (the scale of the f32 expansion's
    rounding) of eps².

    Labels: a float64 DBSCAN that counts only the pairs certainly within
    eps (d² ≤ eps² − tol) and one that counts every pair possibly within
    it (d² ≤ eps² + tol) bracket the port's graph, so for every combo
    (a) lo-core ⊆ port core ⊆ hi-core; (b) points of one lo component
    share one port label; (c) port core points of one label lie in one hi
    component; (d) a labelled non-core point has a core neighbour of its
    label within eps² + tol; (e) a non-core point with a lo-core point
    within eps² − tol is labelled.  The labels are recomputed with the
    port (the analyzer's calls) and must give the analyzer's frame ``db``."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from anovos_tpu_torch.ops.cluster import dbscan_grid, neighbor_counts

    Xc32 = np.asarray(sub, np.float32)
    Xc32 = Xc32 - Xc32.mean(axis=0, keepdims=True)
    X = Xc32.astype(np.float64)
    n, A = len(X), len(eps_values)
    eps2 = [float(np.float32(e * e)) for e in eps_values]
    nrm = (X * X).sum(1)
    counts64 = np.zeros((A, n), np.int64)
    band = np.zeros((A, n), np.int64)
    near_eps_ulps = np.zeros(A, np.int64)
    ei, ej, ed, et = [], [], [], []
    for s in range(0, n, 2048):
        q = X[s:s + 2048]
        t = len(q)
        d2 = (q[:, None, 0] - X[None, :, 0]) ** 2 + (q[:, None, 1] - X[None, :, 1]) ** 2
        tol = 8 * np.spacing((nrm[s:s + t, None] + nrm[None, :]).astype(np.float32)).astype(np.float64)
        diag = (np.arange(t), np.arange(s, s + t))
        for a, e2 in enumerate(eps2):
            ulps = 8 * float(np.spacing(np.float32(e2)))
            counts64[a, s:s + t] = (d2 <= e2).sum(1)
            dev = np.abs(d2 - e2)
            inband = dev <= tol + ulps
            inband[diag] = False
            band[a, s:s + t] = inband.sum(1)
            near_eps_ulps[a] += int((dev <= ulps).sum())
        r, c = np.nonzero(d2 <= max(eps2) + tol)
        keep = r + s != c
        r, c = r[keep], c[keep]
        ei.append((r + s).astype(np.int32))
        ej.append(c.astype(np.int32))
        ed.append(d2[r, c])
        et.append(tol[r, c])
    ei, ej, ed, et = (np.concatenate(v) for v in (ei, ej, ed, et))

    out = {"n": n, "band_pairs": [int(b.sum()) // 2 for b in band],
           "pairs_within_8_ulps_of_eps2": [int(v) // 2 for v in near_eps_ulps],
           "count_mismatches": [], "lo_hi_cluster_counts": [], "combos": 0}
    rows = db.set_index(["eps", "min_samples"])
    ms_values = sorted({int(m) for m in db["min_samples"]})

    def components(edges, core):
        ri, ci = ei[edges & core[ei] & core[ej]], ej[edges & core[ei] & core[ej]]
        g = coo_matrix((np.ones(len(ri), np.int8), (ri, ci)), shape=(n, n))
        return connected_components(g, directed=True, connection="weak")[1]

    def is_function(a_, b_):
        """Every value of a_ comes with one value of b_."""
        pairs = np.unique(np.stack([a_, b_], 1), axis=0)
        return len(pairs) == len(np.unique(a_))

    for a, e in enumerate(eps_values):
        kc = neighbor_counts(sub, float(e))
        diff = np.abs(kc.astype(np.int64) - counts64[a])
        check(bool((diff <= band[a]).all()),
              f"neighbour counts at eps={e} differ from float64 beyond band pairs")
        out["count_mismatches"].append(int((diff > 0).sum()))
        labels = dbscan_grid(sub, float(e), ms_eff, counts=kc)
        lo, hi = ed <= eps2[a] - et, ed <= eps2[a] + et
        c_lo = np.bincount(ei[lo], minlength=n) + 1
        c_hi = np.bincount(ei[hi], minlength=n) + 1
        for b, ms in enumerate(ms_eff):
            lab = labels[b]
            row = rows.loc[(round(float(e), 4), ms_values[b])]
            check(int(row["n_clusters"]) == len(set(lab[lab >= 0]))
                  and float(row["noise_pct"]) == round(float((lab < 0).mean()), 4),
                  f"analyzer frame differs from a rerun at eps={e}, ms={ms}")
            core_lo, core_p, core_hi = c_lo >= ms, kc >= ms, c_hi >= ms
            what = f"DBSCAN at eps={e}, ms={ms} against float64"
            check(bool((core_p >= core_lo).all() and (core_hi >= core_p).all()), f"{what}: (a) core sets")
            check(bool((lab[core_p] >= 0).all()), f"{what}: a core point is noise")
            comp_lo, comp_hi = components(lo, core_lo), components(hi, core_hi)
            check(is_function(comp_lo[core_lo], lab[core_lo]), f"{what}: (b) a lo component split")
            check(is_function(lab[core_p], comp_hi[core_p]), f"{what}: (c) a label spans hi components")
            m = hi & core_p[ej] & ~core_p[ei] & (lab[ei] == lab[ej])
            supported = np.zeros(n, bool)
            supported[ei[m]] = True
            border = ~core_p & (lab >= 0)
            check(bool(supported[border].all()), f"{what}: (d) a border label without a core neighbour")
            m = lo & core_lo[ej] & ~core_p[ei]
            check(bool((lab[ei[m]] >= 0).all()), f"{what}: (e) an unlabelled point next to a core")
            out["lo_hi_cluster_counts"].append(
                [len(np.unique(comp_lo[core_lo])), len(set(lab[lab >= 0])), len(np.unique(comp_hi[core_hi]))])
            out["combos"] += 1
    return out


def geo_path_kernels(torch, table, ll_cols, sub: np.ndarray, eps_values) -> dict:
    """The kernels at the shapes and on the data the geo path gives them,
    against their plain versions: B1 on the lat/lon block of the table (as
    ``ll_gh_cols`` calls it), B3 on the grid sample centred in numpy f32
    (as ``cluster.neighbor_counts`` centres it) at every eps of the grid."""
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain

    X, M = table.numeric_block(ll_cols)
    Xc, Mc = X.t().contiguous(), M.t().contiguous()
    k, rows = Xc.shape
    acc = check_moments_twice(torch, Xc, Mc, "the geo block")
    share = moments_errors(acc.cpu().numpy(), masked_moments_plain(Xc, Mc).cpu().numpy())
    warm = kernel_times(torch, lambda: masked_moments_cols(Xc, Mc))
    cold = kernel_times(torch, lambda: masked_moments_cols(Xc, Mc), cold=True)
    plain_ms = cuda_ms(torch, lambda: masked_moments_plain(Xc, Mc), 2)
    b_ms, b_by = b1_bound(k, rows)
    b1 = {"path": "geo", "shape": [k, rows], "ms": warm["median"], "plain_ms": plain_ms,
          "bound_ms": b_ms, "bound_by": b_by, "warm": warm, "cold": cold,
          "err_share_of_allowance": share}
    print(f"kernel masked_moments at the geo path ({k} x {rows}, lat/lon): warm {spread(warm)}, "
          f"cold L2 {spread(cold)}, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); error as "
          f"share of allowance {share}", flush=True)

    x32 = np.asarray(sub, np.float32)
    xc = torch.from_numpy(x32 - x32.mean(axis=0, keepdims=True)).cuda()
    b3 = []
    for e in eps_values:
        r = time_neighbor_counts(torch, xc, float(np.float32(e * e)), f"the geo grid sample, eps={e}")
        r["eps"] = e
        b3.append(r)
    print("kernel neighbor_counts at the geo path (" + " x ".join(map(str, b3[0]["shape"]))
          + "), equal to plain at every eps: ms " + ", ".join(f"{r['ms']:.4f}" for r in b3)
          + "; plain ms " + ", ".join(f"{r['plain_ms']:.4f}" for r in b3)
          + f"; bound {b3[0]['bound_ms']:.4f} ms ({b3[0]['bound_by']})", flush=True)
    warm = {"min": min(r["warm"]["min"] for r in b3),
            "median": float(np.median([r["warm"]["median"] for r in b3])),
            "max": max(r["warm"]["max"] for r in b3)}
    row = {"path": "geo_grid_16384", "shape": b3[0]["shape"], "warm": warm,
           "ms": float(np.mean([r["ms"] for r in b3])),
           "plain_ms": float(np.mean([r["plain_ms"] for r in b3])),
           "bound_ms": b3[0]["bound_ms"], "bound_by": b3[0]["bound_by"],
           "max_abs_err": max(r["max_abs_err"] for r in b3), "per_eps": b3}
    return {"masked_moments": b1, "neighbor_counts": row}


def phase_geo(torch, seed: int) -> dict:
    import pandas as pd

    from anovos_tpu_torch.data_analyzer import geospatial_analyzer as ga
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset
    from anovos_tpu_torch.ops import kernels

    out = {"rows": GEO_ROWS}
    t0 = time.perf_counter()
    df = geo_frame(seed)
    out["synth_s"] = time.perf_counter() - t0
    lat, lon, gh = "latitude", "longitude", "geohash"
    e0, e1, estep = (float(x) for x in GEO_EPS.split(","))
    eps_values = [float(e) for e in np.arange(e0, e1 + 1e-9, estep)]
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "geo")
        os.makedirs(data_dir)
        df.to_parquet(os.path.join(data_dir, "part-00000.parquet"), index=False)
        t0 = time.perf_counter()
        table = read_dataset(data_dir, "parquet")
        torch.cuda.synchronize()
        out["ingest_s"] = time.perf_counter() - t0
        check(table.nrows == GEO_ROWS and table.col_names == list(df.columns), "geo read_dataset shape")
        print(f"geo: read {GEO_ROWS} rows x {table.ncols} columns in {out['ingest_s']:.2f} s", flush=True)

        out["launches"] = {}
        for path, sample in (("geo_default", None), ("geo_grid_16384", GEO_B3_SAMPLE)):
            master = os.path.join(tmp, path)
            if sample:
                os.environ["ANOVOS_DBSCAN_GRID_SAMPLE"] = str(sample)
            try:
                kernels.reset_launches()
                t0 = time.perf_counter()
                found = ga.geospatial_autodetection(
                    table, "id", master, max_analysis_records=GEO_RECORDS, max_cluster=20,
                    eps=GEO_EPS, min_samples=GEO_MIN_SAMPLES)
                torch.cuda.synchronize()
                out[f"{path}_s"] = time.perf_counter() - t0
                launches = out["launches"][path] = dict(kernels.LAUNCHES)
            finally:
                os.environ.pop("ANOVOS_DBSCAN_GRID_SAMPLE", None)
            check(found == ([lat], [lon], [gh]), f"{path}: detected {found}")
            for name in PATH_KERNELS[path]:
                check(launches[name] > 0, f"kernel {name} was not launched on the {path} path")
            want = len(eps_values) if sample else 0
            check(launches["neighbor_counts"] == want,
                  f"{path}: neighbor_counts launched {launches['neighbor_counts']} times, not {want}")
            missing = [f for f in geo_files(lat, lon, gh) if not os.path.isfile(os.path.join(master, f))]
            check(not missing, f"{path}: files not written: {missing}")
            db = pd.read_csv(os.path.join(master, f"geospatial_dbscan_{lat}_{lon}.csv"))
            check(len(db) == len(eps_values) * 7 and bool(np.isfinite(db["silhouette"]).all()),
                  f"{path}: DBSCAN grid frame")
            out[f"{path}_best_silhouette"] = float(db["silhouette"].max())
            out[f"{path}_clusters_at_best"] = int(db.loc[db["silhouette"].idxmax(), "n_clusters"])
            print(f"geo: geospatial_autodetection, {path} {out[f'{path}_s']:.2f} s, launches "
                  f"{launches}; best silhouette {out[f'{path}_best_silhouette']} with "
                  f"{out[f'{path}_clusters_at_best']} clusters", flush=True)

        charts = os.path.join(tmp, "charts")
        os.makedirs(charts)
        t0 = time.perf_counter()
        ga.generate_loc_charts_controller(table, "id", [lat], [lon], [gh], 100, master_path=charts)
        out["charts_s"] = time.perf_counter() - t0
        missing = [f for f in geo_files(lat, lon, gh, charts_only=True)
                   if not os.path.isfile(os.path.join(charts, f))]
        check(not missing, f"charts not written: {missing}")

        km = pd.read_csv(os.path.join(tmp, "geo_default", f"geospatial_kmeans_{lat}_{lon}.csv"))
        km2 = pd.read_csv(os.path.join(tmp, "geo_grid_16384", f"geospatial_kmeans_{lat}_{lon}.csv"))
        check(km.equals(km2), "k-means frames of the two routes differ")
        db = pd.read_csv(os.path.join(tmp, "geo_grid_16384", f"geospatial_dbscan_{lat}_{lon}.csv"))

    # after the timed runs (these launches are not counted): the kernels at
    # this path's shapes and data, then the float64 checks
    pts = ga._latlon_points(table, lat, lon, GEO_RECORDS)
    sub = pts[np.random.default_rng(2).choice(len(pts), GEO_B3_SAMPLE, replace=False)]
    out["kernels"] = geo_path_kernels(torch, table, [lat, lon], sub, eps_values)
    t0 = time.perf_counter()
    out["kmeans_check"] = kmeans_float64_check(pts, km)
    frac = len(sub) / len(pts)
    m0, m1, mstep = (int(float(x)) for x in GEO_MIN_SAMPLES.split(","))
    ms_eff = [max(2, int(round(m * frac))) for m in range(m0, m1 + 1, mstep)]
    out["dbscan_check"] = dbscan_float64_check(sub, eps_values, ms_eff, db)
    out["float64_checks_s"] = time.perf_counter() - t0
    print(f"geo: k-means vs float64 Lloyd {out['kmeans_check']}; B3 route vs float64 "
          f"{out['dbscan_check']}; charts {out['charts_s']:.2f} s", flush=True)
    check(torch.get_float32_matmul_precision() == "highest" and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmul precision changed")
    return out



def kernel_rows(kres: dict, geo_kernels: dict, b3_blobs: dict, by_path: dict, sass) -> list:
    """The ``{"kernels": [...]}`` rows: each kernel at its own path's shape,
    with its launches there (``by_path``: launch counts per path) and the
    other shapes it was timed at riding along.  B3's library_ms: no single
    PyTorch call counts within-eps neighbours without materialising the
    (n, n) distances.  B3's row also carries its launch plan and its pair
    loop's instructions a pair (``sass``, phase 1) with the ceiling they
    set, (2d + 3) / (2 x instructions)."""
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.kernels.neighbor_counts import launch_plan

    kres["masked_moments"]["other_shapes"].append(geo_kernels["masked_moments"])
    b3 = geo_kernels["neighbor_counts"]
    n, d = b3["shape"]
    per_pair = sass["per_pair"] if sass else None
    kres["neighbor_counts"] = {**b3, "library_ms": None, "other_shapes": [b3_blobs],
                               "max_abs_err": max(b3["max_abs_err"], b3_blobs["max_abs_err"]),
                               "launch_plan": dict(zip(("query_tiles", "source_splits", "split_points",
                                                        "tile_rows"), launch_plan(n, d, "cuda"))),
                               "instructions_per_pair": per_pair,
                               "ceiling_share": (2 * d + 3) / (2 * per_pair) if per_pair else None}
    own_path = {"masked_moments": "income", "binned_histograms": "income",
                "neighbor_counts": "geo_grid_16384"}
    rows = []
    for kname, meta in kernels.KERNELS.items():
        r = kres[kname]
        rows.append({"name": kname, "route": meta["route"], "source": meta["source"],
                     "replaces": meta["replaces"], "launches": by_path[own_path[kname]][kname],
                     "launches_by_path": {p: n[kname] for p, n in by_path.items()},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"],
                     "warm_ms": {q: r["warm"][q] for q in ("min", "median", "max")},
                     "cold_ms": ({q: r["cold"][q] for q in ("min", "median", "max")}
                                 if "cold" in r else None),
                     "host_us": r.get("host_us"),
                     **{k: r[k] for k in ("launch_plan", "instructions_per_pair", "ceiling_share")
                        if k in r},
                     "other_shapes": r.get("other_shapes", [])})
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    from anovos_tpu_torch.ops.kernels import build
    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    try:
        build.load()
    finally:
        for src, log in build.BUILD_LOG.items():
            for line in log.splitlines():
                if "ptxas info" in line and ("Used" in line or "spill" in line):
                    print(f"build: {src}: {line.strip()}", flush=True)
    build_s = time.perf_counter() - t0
    print(f"build: {len(build.SOURCES)} sources, one nvcc each, all at once, in {build_s:.2f} s",
          flush=True)
    sass = b3_loop_sass(str(build.build_dir() / "libneighbor_counts.so"))
    if sass is not None:
        sass.pop("text")
        print(f"build: neighbor_counts pair loop at d = 2 (SASS): {sass['instructions']} instructions "
              f"for {sass['pairs']} pairs, {sass['per_pair']:.4f} a pair; {sass['mix']}", flush=True)
    else:
        print("build: no cuobjdump in the toolkit; neighbor_counts pair loop not counted", flush=True)

    check(torch.get_float32_matmul_precision() == "highest" and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must not run in TF32")
    k_num = 9  # numeric columns of the income schema after the bench's drops
    kres = phase_kernels(torch, args.seed, k_num)
    path = phase_path(torch, args.seed)
    print("path " + json.dumps({k: v for k, v in path.items() if k != "launches"}), flush=True)
    b3_blobs = phase_geo_kernels(torch, args.seed)
    geo = phase_geo(torch, args.seed)
    geo_kernels = geo.pop("kernels")
    print("geo " + json.dumps({k: v for k, v in geo.items() if k != "launches"}), flush=True)
    rows = kernel_rows(kres, geo_kernels, b3_blobs, {"income": path["launches"], **geo["launches"]},
                       sass)
    print(json.dumps({"kernels": rows}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
