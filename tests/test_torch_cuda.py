"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False.  The file imports neither JAX nor
the JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from _torch_port import HIST_CASES, assert_moments_close, hist_inputs, moment_inputs


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda.is_available() is False: the CUDA kernels need an NVIDIA GPU")


@pytest.mark.cuda
def test_cuda_histogram_equals_plain():
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols, binned_histograms_plain

    _require_cuda()
    for rows, k, nbins, nan_rows, dead_cols in HIST_CASES:
        X, M, cuts = hist_inputs(rows, k, nbins, seed=rows, nan_rows=nan_rows, dead_cols=dead_cols)
        Xc = torch.from_numpy(X.T.copy()).cuda()
        Mc = torch.from_numpy(M.T.copy()).cuda()
        c = torch.from_numpy(cuts).cuda()
        got = binned_histograms_cols(Xc, Mc, c, nbins)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), binned_histograms_plain(Xc, Mc, c, nbins).cpu())


@pytest.mark.cuda
def test_cuda_moments_match_plain():
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain

    _require_cuda()
    for rows in (60000, 2049, 1):
        X, M = moment_inputs(rows, seed=rows)
        Xc = torch.from_numpy(X.T.copy()).cuda()
        Mc = torch.from_numpy(M.T.copy()).cuda()
        got = masked_moments_cols(Xc, Mc).cpu().numpy()
        torch.cuda.synchronize()
        exp = masked_moments_plain(Xc, Mc).cpu().numpy()
        # the kernel runs Welford per thread and merges threads and blocks,
        # the plain version merges 2048-row tiles: a looser rtol than the
        # plain-vs-Pallas test, which shares the tile structure
        assert_moments_close(got, exp, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_neighbor_counts_equal_plain():
    """Kernel B3 and its plain version evaluate d² with the same rounded
    operations in the same order: the counts are equal, not just close,
    across the Pallas test's regimes, a ragged block and d = 3."""
    from anovos_tpu_torch.ops.kernels.neighbor_counts import neighbor_counts_plain, neighbor_counts_rows

    _require_cuda()
    for n, eps, d in ((3000, 0.4, 2), (1024, 0.05, 2), (1500, 50.0, 2), (257, 0.3, 2),
                      (2049, 0.7, 3), (1, 0.1, 2)):
        g = np.random.default_rng(n)
        X = g.uniform(-40, 40, (4, d))[g.integers(0, 4, n)] + g.normal(0, 0.3, (n, d))
        X = X.astype(np.float32)
        Xc = torch.from_numpy(X - X.mean(axis=0, keepdims=True)).cuda()
        eps2 = float(np.float32(eps * eps))
        got = neighbor_counts_rows(Xc, eps2)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), neighbor_counts_plain(Xc, eps2).cpu()), (n, eps, d)
        assert int(got.min()) >= 1


# Row counts ≡ 1, 2, 3 (mod 4) and ≢ 0 (mod 16): every column after the
# first starts off the 16-byte grid, so the kernels read a head and a tail
# one value at a time.  1,333,333 and 1,333,334 are the stability slices of
# the 4M-row path; 16,387 and 20,483 end one row past a work item.
UNALIGNED_ROWS = (1_333_333, 1_333_334, 16_387, 20_483, 4_097, 4_098, 4_099, 2_049, 7, 6, 5, 3, 2, 1)


def _cols(X, M):
    return torch.from_numpy(X.T.copy()).cuda(), torch.from_numpy(M.T.copy()).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", UNALIGNED_ROWS)
def test_cuda_moments_unaligned_rows(rows):
    """B1 against its plain version where columns start off the vector
    grid; two calls give the same bits."""
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain

    _require_cuda()
    Xc, Mc = _cols(*moment_inputs(rows, seed=rows))
    got = masked_moments_cols(Xc, Mc)
    again = masked_moments_cols(Xc, Mc)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert_moments_close(got.cpu().numpy(), masked_moments_plain(Xc, Mc).cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", UNALIGNED_ROWS)
def test_cuda_histogram_unaligned_rows(rows):
    """B2 equal to its plain version where columns start off the vector
    grid, with a NaN cutoff row and an all-masked column."""
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols, binned_histograms_plain

    _require_cuda()
    X, M, cuts = hist_inputs(rows, 5, 10, seed=rows, nan_rows=(3,), dead_cols=(2,))
    Xc, Mc = _cols(X, M)
    c = torch.from_numpy(cuts).cuda()
    got = binned_histograms_cols(Xc, Mc, c, 10)
    torch.cuda.synchronize()
    assert torch.equal(got, binned_histograms_plain(Xc, Mc, c, 10))
    assert int(got.sum().item()) == int(M.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("nbins", [1, 2, 10, 32, 33, "MAX_BINS"])
def test_cuda_histogram_bin_counts(nbins):
    """B2 equal to its plain version from one bin to the most the kernel
    takes, on both sides of 32 bins (a counter for every thread up to 32,
    per-warp atomics above), with a NaN cutoff row and an all-masked
    column."""
    from anovos_tpu_torch.ops.kernels.histogram import MAX_BINS, binned_histograms_cols, binned_histograms_plain

    _require_cuda()
    nbins = MAX_BINS if nbins == "MAX_BINS" else nbins
    nan_rows = (1,) if nbins > 1 else ()
    X, M, cuts = hist_inputs(50_001, 4, nbins, seed=nbins, nan_rows=nan_rows, dead_cols=(3,))
    Xc, Mc = _cols(X, M)
    c = torch.from_numpy(cuts).cuda()
    got = binned_histograms_cols(Xc, Mc, c, nbins)
    torch.cuda.synchronize()
    assert torch.equal(got, binned_histograms_plain(Xc, Mc, c, nbins))
    assert got[3].sum().item() == 0


@pytest.mark.cuda
def test_cuda_all_masked_and_empty_columns():
    """An all-masked column gives the empty accumulator and empty bins; a
    table of zero rows too."""
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols, binned_histograms_plain
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain

    _require_cuda()
    for rows in (100_003, 0):
        Xc = torch.randn((3, rows), device="cuda")
        Mc = torch.zeros((3, rows), dtype=torch.bool, device="cuda")
        cuts = torch.full((3, 4), float("nan"), device="cuda")
        acc = masked_moments_cols(Xc, Mc)
        h = binned_histograms_cols(Xc, Mc, cuts, 5)
        torch.cuda.synchronize()
        assert torch.equal(acc, masked_moments_plain(Xc, Mc))
        assert torch.equal(h, binned_histograms_plain(Xc, Mc, cuts, 5))
        assert h.sum().item() == 0


@pytest.mark.cuda
def test_cuda_consecutive_calls_at_other_shapes():
    """Calls at shapes that change from one to the next, then the first
    shape again: no scratch or ticket of one call leaks into the next."""
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols, binned_histograms_plain
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols

    _require_cuda()
    shapes = [(9, 300_001), (2, 5), (13, 70_000), (1, 1_000_003), (9, 300_001)]
    first = None
    for k, rows in shapes:
        X, M, cuts = hist_inputs(rows, k, 10, seed=k * rows, nan_rows=(0,) if k > 1 else ())
        Xc, Mc = _cols(X, M)
        c = torch.from_numpy(cuts).cuda()
        acc = masked_moments_cols(Xc, Mc)
        h = binned_histograms_cols(Xc, Mc, c, 10)
        torch.cuda.synchronize()
        assert torch.equal(h, binned_histograms_plain(Xc, Mc, c, 10)), (k, rows)
        assert torch.equal(acc[0].cpu(), torch.from_numpy(M.sum(axis=0).astype(np.float32))), (k, rows)
        first = acc if first is None else first
    assert torch.equal(acc, first)


@pytest.mark.cuda
def test_cuda_views_off_the_vector_grid():
    """Contiguous views whose data start off a 16-byte boundary: the
    wrappers read them correctly."""
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols, binned_histograms_plain
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain

    _require_cuda()
    X, M, cuts = hist_inputs(3 * 40_001 + 1, 1, 10, seed=5)
    x = torch.from_numpy(X[:, 0].copy()).cuda()[1:].view(3, 40_001)
    m = torch.from_numpy(M[:, 0].copy()).cuda()[1:].view(3, 40_001)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    c = torch.from_numpy(np.repeat(cuts, 3, axis=0)).cuda()
    assert torch.equal(binned_histograms_cols(x, m, c, 10), binned_histograms_plain(x, m, c, 10))
    assert_moments_close(masked_moments_cols(x, m).cpu().numpy(),
                         masked_moments_plain(x, m).cpu().numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# kernel B3: query tiles x source splits, 8 rows a thread, folded compare
# ---------------------------------------------------------------------------
def _b3_equal(X: np.ndarray, eps2: float, what) -> torch.Tensor:
    """B3 on the card equal to its plain version on ``X``; returns the counts."""
    from anovos_tpu_torch.ops.kernels.neighbor_counts import neighbor_counts_plain, neighbor_counts_rows

    Xc = torch.from_numpy(np.ascontiguousarray(X, np.float32)).cuda()
    got = neighbor_counts_rows(Xc, eps2)
    torch.cuda.synchronize()
    assert torch.equal(got, neighbor_counts_plain(Xc, eps2)), what
    return got


def _b3_blobs(n: int, d: int, seed: int) -> np.ndarray:
    g = np.random.default_rng(seed)
    X = (g.uniform(-40, 40, (4, d))[g.integers(0, 4, n)] + g.normal(0, 0.3, (n, d))).astype(np.float32)
    return X - X.mean(axis=0, keepdims=True)


@pytest.mark.cuda
@pytest.mark.parametrize("d", range(1, 9))
def test_cuda_neighbor_counts_every_width(d):
    """Every width the kernel is built for, its packed points 1 to 3
    vectors wide, at a ragged n and an eps that counts tens of neighbours."""
    _require_cuda()
    _b3_equal(_b3_blobs(3001, d, d), float(np.float32(0.2 * d)), d)


@pytest.mark.cuda
def test_cuda_neighbor_counts_ragged_sizes():
    """n = 1, below the least split, a query tile ± 1, the geo grid's
    16,384 and one of its splits ± 1, splits of several staged chunks, and
    sizes near 16,384 whose last split ends 1 past, 1 short of and on the
    kernel's 8-point unroll (the plan comes from the card)."""
    from anovos_tpu_torch.ops.kernels.neighbor_counts import launch_plan

    _require_cuda()
    tile = launch_plan(1, 2, "cuda")[3]
    assert launch_plan(tile, 2, "cuda")[0] == 1 and launch_plan(tile + 1, 2, "cuda")[0] == 2
    split = launch_plan(16_384, 2, "cuda")[2]
    sizes = {1, 2, 7, 50, 63, 64, 65, 100, tile - 1, tile, tile + 1, 16_384,
             split - 1, split, split + 1, 60_001}
    want = {}
    for n in range(16_000, 16_800):
        _, splits, length, _ = launch_plan(n, 2, "cuda")
        last = n - (splits - 1) * length
        if splits > 1:
            want.setdefault(last % 8, n)
    assert {0, 1, 7} <= set(want), want
    sizes |= {want[0], want[1], want[7]}
    assert launch_plan(60_001, 2, "cuda")[2] > 512  # several chunks a split
    for n in sorted(sizes):
        got = _b3_equal(_b3_blobs(n, 2, n), float(np.float32(0.4 * 0.4)), n)
        assert int(got.min()) >= 1, n


@pytest.mark.cuda
def test_cuda_neighbor_counts_zero_eps_and_duplicates():
    """eps² = 0: each point counts itself and its exact duplicates (d² of
    equal points is exactly 0), and on blobs also the close points whose
    expansion rounds to d² <= 0; on small integer points the expansion is
    exact, so the counts are the multiplicities.  A moderate eps on the
    same duplicated blobs."""
    _require_cuda()
    g = np.random.default_rng(3)
    base = _b3_blobs(1500, 2, 3)
    X = base[g.integers(0, len(base), 5000)]  # every point repeated about 3 times
    for pts, exact in ((X, False), (g.integers(-50, 50, (5000, 2)).astype(np.float32), True)):
        got = _b3_equal(pts, 0.0, f"eps2 = 0, exact {exact}").cpu().numpy()
        _, inverse, mult = np.unique(pts, axis=0, return_inverse=True, return_counts=True)
        mult = mult[inverse.ravel()]
        assert bool((got >= mult).all())
        if exact:
            np.testing.assert_array_equal(got, mult)
    _b3_equal(X, float(np.float32(0.3 * 0.3)), "duplicates, eps 0.3")


@pytest.mark.cuda
def test_cuda_neighbor_counts_eps_beyond_diameter():
    """An eps larger than the set's diameter: every count is n."""
    _require_cuda()
    X = _b3_blobs(4099, 2, 4)
    got = _b3_equal(X, float(np.float32(1e4)), "eps beyond the diameter")
    assert bool((got == len(X)).all())


@pytest.mark.cuda
def test_cuda_neighbor_counts_boundary_lattice():
    """The lattice of test_torch_cluster.py::test_b3_boundary_regime
    (spacing = eps), centred: about half of all neighbour pairs sit on the
    threshold, so the last bit of d² decides them."""
    _require_cuda()
    eps = 0.125
    g = np.random.default_rng(11)
    i, j = np.meshgrid(np.arange(40), np.arange(30), indexing="ij")
    X = (np.stack([i.ravel(), j.ravel()], 1) * eps + g.uniform(-3, 3, (1, 2))).astype(np.float32)
    _b3_equal(X - X.mean(axis=0, keepdims=True), float(np.float32(eps * eps)), "boundary lattice")


@pytest.mark.cuda
def test_cuda_neighbor_counts_consecutive_calls():
    """Calls at sizes that change from one to the next: no partial count
    of one call leaks into the next."""
    _require_cuda()
    first = None
    for n in (16_384, 5_000, 300, 16_384):
        got = _b3_equal(_b3_blobs(n, 2, 9)[:n], float(np.float32(0.4 * 0.4)), n)
        if n == 16_384:
            first = got if first is None else first
    assert torch.equal(got, first)


@pytest.mark.cuda
def test_cuda_neighbor_counts_literal_inputs():
    """Inputs where the folded form could differ, which the kernel
    evaluates literally: a NaN point, an infinite point, coordinates whose
    doubled dot product overflows, an infinite and a NaN eps²; and norms
    just under the kernel's 2^126 limit, which take the folded form."""
    _require_cuda()
    X = _b3_blobs(3000, 2, 5)
    for what, rows, eps2 in (("NaN point", {7: np.nan}, 0.16), ("infinite point", {11: np.inf}, 0.16),
                             ("overflowing dot", {0: 1.2e19, 1: 1.25e19, 2: -1.2e19}, 0.16),
                             ("infinite eps2", {}, float("inf")), ("NaN eps2", {}, float("nan"))):
        Y = X.copy()
        for r, v in rows.items():
            Y[r] = v
        _b3_equal(Y, eps2, what)
    near = X * np.float32(6.0e18 / np.abs(X).max())
    assert float((near.astype(np.float64) ** 2).sum(1).max()) < 2.0**126
    _b3_equal(near, float(np.float32(1e36)), "norms under 2^126")


@pytest.mark.cuda
def test_cuda_entry_points_keep_the_current_device():
    """Each wrapper called on the last device leaves the caller's current
    device as it was, and its result equals the plain version's."""
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols, binned_histograms_plain
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain
    from anovos_tpu_torch.ops.kernels.neighbor_counts import neighbor_counts_plain, neighbor_counts_rows

    _require_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    last = torch.cuda.device_count() - 1
    dev = torch.device("cuda", last)
    before = torch.cuda.current_device()
    assert before != last
    X, M, cuts = hist_inputs(50_001, 3, 10, seed=1, nan_rows=(1,))
    Xc = torch.from_numpy(X.T.copy()).to(dev)
    Mc = torch.from_numpy(M.T.copy()).to(dev)
    c = torch.from_numpy(cuts).to(dev)
    acc = masked_moments_cols(Xc, Mc)
    assert torch.cuda.current_device() == before
    h = binned_histograms_cols(Xc, Mc, c, 10)
    assert torch.cuda.current_device() == before
    P = torch.from_numpy(_b3_blobs(5000, 2, 6)).to(dev)
    nc = neighbor_counts_rows(P, 0.16)
    assert torch.cuda.current_device() == before
    torch.cuda.synchronize(dev)
    assert acc.device == dev and h.device == dev and nc.device == dev
    assert torch.equal(h, binned_histograms_plain(Xc, Mc, c, 10))
    assert torch.equal(acc[0], masked_moments_plain(Xc, Mc)[0])
    assert torch.equal(nc, neighbor_counts_plain(P, 0.16))


@pytest.mark.cuda
def test_cuda_row_signature_filter_rows_and_data_sample():
    """The sampling and quality building blocks run on the card: row
    signatures and row filters equal the CPU's, a sample keeps its share
    and is the same for one seed."""
    from examples._data import synthesize
    from anovos_tpu_torch.data_ingest.data_sampling import data_sample
    from anovos_tpu_torch.ops.segment import row_signature
    from anovos_tpu_torch.shared.table import Table

    _require_cuda()
    g = np.random.default_rng(0)
    X = g.integers(-(2**31), 2**31, (100_003, 5), dtype=np.int64).astype(np.int32)
    M = g.random((100_003, 5)) > 0.2
    got = row_signature(torch.from_numpy(X).cuda(), torch.from_numpy(M).cuda())
    assert torch.equal(got.cpu(), row_signature(torch.from_numpy(X), torch.from_numpy(M)))
    df = synthesize(50_000, seed=3)
    ct, pt = Table.from_pandas(df, device="cuda"), Table.from_pandas(df, device="cpu")
    keep = g.random(len(df)) < 0.3
    assert ct.filter_rows(torch.from_numpy(keep).cuda()).to_pandas().equals(pt.filter_rows(keep).to_pandas())
    a = data_sample(ct, fraction=0.2, seed_value=5)
    b = data_sample(ct, fraction=0.2, seed_value=5)
    assert a.columns["age"].data.device.type == "cuda"
    assert a.to_pandas().equals(b.to_pandas())
    assert abs(a.nrows - 10_000) <= 5 * np.sqrt(50_000 * 0.2 * 0.8)
    s = data_sample(ct, strata_cols="race|sex", method_type="stratified", fraction=0.2, seed_value=5)
    assert abs(s.nrows - 10_000) <= 5 * np.sqrt(50_000 * 0.2 * 0.8)


@pytest.mark.cuda
def test_cuda_quality_and_sampled_drift_launch_the_kernels(tmp_path):
    """outlier_detection reaches B1 (its stdev fence) and sampled drift
    statistics reach B2 (its histograms), counted by kernels.LAUNCHES."""
    from examples._data import synthesize
    from anovos_tpu_torch.data_analyzer.quality_checker import outlier_detection
    from anovos_tpu_torch.drift_stability.drift_detector import statistics
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.shared.table import Table

    _require_cuda()
    df = synthesize(300_000, seed=4).drop(columns=["ifa", "dt_1", "dt_2", "empty", "logfnl"])
    ct = Table.from_pandas(df, device="cuda")
    kernels.reset_launches()
    _, stats = outlier_detection(ct, detection_side="both", sample_size=100_000)
    assert kernels.LAUNCHES["masked_moments"] == 1
    assert (stats[["lower_outliers", "upper_outliers"]].to_numpy() >= 0).all()
    kernels.reset_launches()
    odf = statistics(ct.slice_rows(150_000, 300_000), ct.slice_rows(0, 150_000), method_type="all",
                     source_path=str(tmp_path))
    assert kernels.LAUNCHES["binned_histograms"] == 2
    assert np.isfinite(odf[["PSI", "HD", "JSD", "KS"]].to_numpy(np.float64)).all()


@pytest.mark.cuda
def test_cuda_moments_on_the_compensated_view():
    """B1 over the column-major (columns × chunks, 65,536) view the
    compensated moments build: a column with a whole chunk null and a
    tail padded with mask False, equal to the plain version within B1's
    allowance; the empty chunk gives n = 0 and mean 0."""
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain

    _require_cuda()
    chunk, rows = 1 << 16, 3 * (1 << 16) + 777
    X, M = moment_inputs(rows, seed=6)
    M[chunk:2 * chunk, 1] = False
    X[~M] = 0.0
    k, c = X.shape[1], 4
    Xv = torch.zeros((k, c * chunk), dtype=torch.float32, device="cuda")
    Mv = torch.zeros((k, c * chunk), dtype=torch.bool, device="cuda")
    Xv[:, :rows] = torch.from_numpy(X.T.copy()).cuda()
    Mv[:, :rows] = torch.from_numpy(M.T.copy()).cuda()
    Xv, Mv = Xv.view(k * c, chunk), Mv.view(k * c, chunk)
    got = masked_moments_cols(Xv, Mv).cpu().numpy()
    torch.cuda.synchronize()
    exp = masked_moments_plain(Xv, Mv).cpu().numpy()
    assert_moments_close(got, exp, rtol=1e-5)
    empty = 1 * c + 1
    assert got[0, empty] == 0 and got[1, empty] == 0 and got[2, empty] == 0


@pytest.mark.cuda
def test_cuda_correlation_matrix_with_tf32_on_globally():
    """TF32 enabled for the whole process: correlation_matrix still
    computes in f32, within 1e-5 of float64 complete-case Pearson."""
    import pandas as pd

    from anovos_tpu_torch.data_analyzer.association_evaluator import correlation_matrix
    from anovos_tpu_torch.shared.table import Table

    _require_cuda()
    g = np.random.default_rng(8)
    n = 200_000
    a = g.normal(0, 1, n)
    df = pd.DataFrame({"a": a, "b": 0.9 * a + g.normal(0, 0.4, n), "c": g.exponential(3, n),
                       "d": 2015 + np.round(3 * a + g.normal(0, 1, n))})
    df.loc[g.random(n) < 0.05, "b"] = np.nan
    t = Table.from_pandas(df, device="cuda")
    flags = torch.backends.cuda.matmul
    before = flags.fp32_precision
    flags.fp32_precision = "tf32"
    try:
        got = correlation_matrix(t).set_index("attribute")
        assert flags.fp32_precision == "tf32"
    finally:
        flags.fp32_precision = before
    ref = df.astype(np.float32).astype(np.float64).dropna().corr()
    np.testing.assert_allclose(got.loc[ref.index, ref.columns].to_numpy(), ref.to_numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_hll_registers_equal_the_cpu():
    from anovos_tpu_torch.ops.hll import hll_registers

    _require_cuda()
    g = np.random.default_rng(2)
    X = g.normal(0, 5, (300_000, 3)).astype(np.float32)
    X[::9, 0] = -0.0
    X[::10, 0] = 0.0
    M = g.random((300_000, 3)) > 0.05
    C = g.integers(-9, 90_000, (300_000, 2)).astype(np.int32)
    for A in (X, C):
        B = M[:, : A.shape[1]]
        for p in (4, 9, 16):
            cpu = hll_registers(torch.from_numpy(A), torch.from_numpy(B), p)
            gpu = hll_registers(torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda(), p)
            assert torch.equal(gpu.cpu(), cpu), p


@pytest.mark.cuda
def test_cuda_timeseries_path_stays_on_the_card_and_equals_the_cpu(tmp_path):
    """ts_preprocess, ts_analyzer and the datetime transformers on a CUDA
    Table: every column they return lives on the card, and the results
    equal the same calls on the CPU (sums within 1e-6 relative: the card
    adds in another order)."""
    import os

    import pandas as pd

    from examples._data import synthesize
    from anovos_tpu_torch.data_analyzer.ts_analyzer import ts_analyzer
    from anovos_tpu_torch.data_ingest.ts_auto_detection import ts_preprocess
    from anovos_tpu_torch.data_transformer import datetime as dt
    from anovos_tpu_torch.shared.table import Table

    _require_cuda()
    df = synthesize(50_000, seed=6).drop(columns=["empty", "logfnl"])
    runs = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        t = ts_preprocess(Table.from_pandas(df, device=dev), "ifa", output_path=str(out))
        ts_analyzer(t, "ifa", max_days=3600, output_path=str(out))
        t = dt.timeUnits_extraction(t, "dt_1", "all")
        t = dt.window_aggregator(t, "age|fnlwgt", "mean|stddev|min|median", "dt_1", "rolling", 3,
                                 partition_col="workclass")
        t = dt.window_aggregator(t, "age", "sum|max", "dt_2", "expanding")
        t = dt.lagged_ts(t, "dt_1", lag=1, output_type="ts_diff")
        t = dt.is_monthEnd(dt.start_of_quarter(t, "dt_2", output_mode="append"), "dt_1")
        agg = dt.aggregator(t, "age|fnlwgt", "count|sum|mean|median|stddev", "dt_1", "%Y-%m")
        runs[dev] = (t, agg, out)
    (tg, ag, og), (tc, ac, oc) = runs["cuda"], runs["cpu"]
    assert tg.col_names == tc.col_names
    assert all(c.data.device.type == "cuda" and c.mask.device.type == "cuda" for c in tg.columns.values())
    pd.testing.assert_frame_equal(ag, ac, rtol=1e-6)
    pd.testing.assert_frame_equal(tg.to_pandas(), tc.to_pandas(), rtol=1e-6)
    names = sorted(os.listdir(oc))
    assert sorted(os.listdir(og)) == names and len(names) == 2 * 10 + 3
    for n in names:
        if n.startswith("ts_num_"):
            pd.testing.assert_frame_equal(pd.read_csv(og / n), pd.read_csv(oc / n), rtol=1e-6)
        else:
            assert (og / n).read_text() == (oc / n).read_text(), n


@pytest.mark.cuda
def test_cuda_transformers_stay_on_the_card_and_equal_the_cpu():
    """configs_full's six transformer steps, the scalers and boxcox on the
    card: every returned column on the card, equal to the same calls on
    the CPU within 1e-5 relative plus 1e-5 (f32 moments summed in another
    order move a z-score near 0 by about 1e-7 of its σ); PCA's latents
    sign-aligned, within 1e-4 of the column's largest value."""
    import pandas as pd

    from examples._data import synthesize
    from anovos_tpu_torch.data_transformer import transformers as tr
    from anovos_tpu_torch.shared.table import Table

    _require_cuda()
    df = synthesize(50_000, seed=8).drop(columns=["ifa", "dt_1", "dt_2", "empty", "logfnl"])
    chain = [("feature_transformation", {"method_type": "sqrt"}),
             ("attribute_binning", {"method_type": "equal_frequency", "bin_size": 10}),
             ("outlier_categories", {"drop_cols": ["income"], "coverage": 0.9, "max_category": 20}),
             ("cat_to_num_supervised", {"label_col": "income", "event_label": ">50K"}),
             ("IQR_standardization", {}), ("PCA_latentFeatures", {"explained_variance_cutoff": 0.95})]
    runs = {}
    for dev in ("cuda", "cpu"):
        t = Table.from_pandas(df, device=dev)
        side = [tr.z_standardization(t), tr.normalization(t), tr.boxcox_transformation(t, output_mode="append")]
        for fn, kw in chain:
            t = getattr(tr, fn)(t, **kw)
        runs[dev] = [t] + side
    for g, c in zip(runs["cuda"], runs["cpu"]):
        assert g.col_names == c.col_names
        assert all(col.data.is_cuda and col.mask.is_cuda for col in g.columns.values())
        gp, cp = g.to_pandas(), c.to_pandas()
        lat = [n for n in gp.columns if n.startswith("latent_")]
        pd.testing.assert_frame_equal(gp.drop(columns=lat), cp.drop(columns=lat), rtol=1e-5, atol=1e-5)
        for n in lat:
            a, b = gp[n].to_numpy(), cp[n].to_numpy()
            a = a * np.sign((a * b).sum())
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), n


def _imputer_frame():
    import pandas as pd

    g = np.random.default_rng(14)
    n = 20_000
    x = g.normal(10, 3, n)
    df = pd.DataFrame({"x": x, "y": 0.5 * x + g.normal(0, 1, n), "z": g.exponential(2, n)})
    df.loc[g.random(n) < 0.1, "y"] = np.nan
    df.loc[g.random(n) < 0.05, "z"] = np.nan
    return df


@pytest.mark.cuda
def test_cuda_imputers_equal_the_cpu():
    """The ridge and ALS on the card equal the CPU within 1e-4 of the
    column's σ (f32 products in another order); KNN equals it on at least
    99% of the imputed cells within 1e-5 relative: elsewhere two donors
    lie within f32 rounding of the K-th distance and the devices round
    them apart (both are float64's pick only where f32 decides it, as
    chip_smoke.py 10c checks)."""
    from anovos_tpu_torch.data_transformer import imputers as imp
    from anovos_tpu_torch.shared.table import Table

    _require_cuda()
    df = _imputer_frame()
    out = {}
    for dev in ("cuda", "cpu"):
        t = Table.from_pandas(df, device=dev)
        out[dev] = [imp.imputation_sklearn(t, method_type="KNN").to_pandas(),
                    imp.imputation_sklearn(t, method_type="regression").to_pandas(),
                    imp.imputation_matrixFactorization(t).to_pandas()]
    (kg, rg, mg), (kc, rc, mc) = out["cuda"], out["cpu"]
    for c in ("y", "z"):
        hole = df[c].isna().to_numpy()
        a, b = kg[c].to_numpy()[hole], kc[c].to_numpy()[hole]
        assert (np.abs(a - b) <= 1e-5 * np.abs(b)).mean() >= 0.99, c
        sd = df[c].std()
        for g_, c_ in ((rg, rc), (mg, mc)):
            np.testing.assert_allclose(g_[c], c_[c], rtol=0, atol=1e-4 * sd, err_msg=c)


@pytest.mark.cuda
def test_cuda_autoencoder_latents_with_tf32_on_equal_the_cpu():
    """The autoencoder's latents from the same parameters, with TF32
    switched on globally around the call (the model pins IEEE f32), equal
    a CPU forward within 1e-5·(1 + |x|)."""
    from anovos_tpu_torch.models.autoencoder import AutoEncoder

    _require_cuda()
    g = np.random.default_rng(15)
    ae = AutoEncoder(3, 2)
    net = ae.init_params()
    X = torch.from_numpy(g.normal(0, 1, (5000, 3)).astype(np.float32))
    flags = torch.backends.cuda.matmul
    before = flags.fp32_precision
    flags.fp32_precision = "tf32"
    try:
        got = ae.latent(ae.net_from_state(net.state_dict(), "cuda"), X.cuda()).cpu().numpy()
        assert flags.fp32_precision == "tf32"
    finally:
        flags.fp32_precision = before
    exp = ae.latent(net, X).numpy()
    assert np.all(np.abs(got - exp) <= 1e-5 * (1 + np.abs(exp)))


@pytest.mark.cuda
def test_cuda_streaming_passes_equal_the_cpu(tmp_path, monkeypatch):
    """describe, quality and drift streaming on the card (pinned staging,
    non-blocking uploads, a window of events) against the same calls on
    the CPU: counts, extremes, quantiles and outlier counts equal, moments
    within 1e-4 (the moments kernel against its plain tile merge), drift
    metrics within 1e-4; B1 and B2 launched."""
    import pandas as pd

    from anovos_tpu_torch.data_analyzer import quality_checker as qc
    from anovos_tpu_torch.drift_stability import drift_detector as dd
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops import streaming as st
    from anovos_tpu_torch.shared.runtime import get_runtime, init_runtime

    _require_cuda()
    g = np.random.default_rng(8)
    for side, n in (("tgt", 5), ("src", 3)):
        (tmp_path / side).mkdir()
        for i in range(n):
            a = g.normal(i, 2.0, 30_000)
            a[g.random(30_000) < 0.1] = np.nan
            pd.DataFrame({"a": a, "b": g.exponential(5.0, 30_000), "c": g.choice(["x", "y", "z"], 30_000)}) \
                .to_parquet(tmp_path / side / f"part-{i:05d}.parquet", index=False)
    tgt, src = str(tmp_path / "tgt"), str(tmp_path / "src")
    monkeypatch.setenv("ANOVOS_STREAM_INFLIGHT", "3")
    prev = get_runtime().device
    runs = {}
    try:
        for dev in ("cuda", "cpu"):
            init_runtime(dev)
            kernels.reset_launches()
            runs[dev] = (st.describe_streaming(tgt, "parquet", chunk_rows=25_000),
                         qc.missing_stats_streaming(tgt, "parquet", chunk_rows=25_000),
                         dd.statistics_streaming(tgt, "parquet", src, method_type="all", chunk_rows=25_000,
                                                 source_path=str(tmp_path / dev)),
                         dict(kernels.LAUNCHES))
    finally:
        init_runtime(prev)
    (dg, mg, fg, lg), (dc, mc, fc, _lc) = runs["cuda"], runs["cpu"]
    # describe 6 chunks + drift source 4; drift source 4 + target 6
    assert lg["masked_moments"] == 6 + 4 and lg["binned_histograms"] == 4 + 6
    exact = ["count", "min", "max", "nonzero"] + [c for c in dc.columns if c.endswith("%")]
    pd.testing.assert_frame_equal(dg[["attribute"] + exact], dc[["attribute"] + exact])
    for c in ("mean", "stddev", "variance", "skewness", "kurtosis"):
        np.testing.assert_allclose(dg[c], dc[c], rtol=0, atol=1e-4)
    pd.testing.assert_frame_equal(mg, mc)
    assert list(fg["flagged"]) == list(fc["flagged"])
    for m in ("PSI", "HD", "JSD", "KS"):
        np.testing.assert_allclose(fg[m], fc[m], rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_continuum_step_equals_the_cpu(tmp_path):
    """One continuum step over six daily parts (a drift baseline, nulls, a
    categorical column) on the card and on the CPU: the missing and
    categorical CSVs byte-equal, the drift metrics within 1e-4 and the
    flags equal, the stats within 1e-4 of the CPU's (the moments kernel
    against its plain tile merge), and B1 and B2 launched once a
    partition (B2: the target days and the fit's re-decode of the
    baseline)."""
    import pandas as pd

    from anovos_tpu_torch.continuum.watcher import ContinuumConfig, step
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.shared.runtime import get_runtime, init_runtime

    _require_cuda()
    g = np.random.default_rng(15)
    feed = tmp_path / "feed"
    feed.mkdir()
    for i in range(6):
        a = g.normal(10 + i, 2.0, 40_000)
        a[g.random(40_000) < 0.05] = np.nan
        pd.DataFrame({"a": a, "b": g.exponential(5.0, 40_000), "cat": g.choice(["x", "y", "z"], 40_000)}) \
            .to_parquet(feed / (f"base-{i}.parquet" if i < 2 else f"day-{i}.parquet"), index=False)
    prev = get_runtime().device
    launches = {}
    try:
        for dev in ("cuda", "cpu"):
            init_runtime(dev)
            kernels.reset_launches()
            step(ContinuumConfig.from_dict({"dataset_path": str(feed), "state_dir": str(tmp_path / dev / "state"),
                                            "output_path": str(tmp_path / dev / "out"),
                                            "drift": {"baseline": "base-*", "method_type": "all"}}))
            launches[dev] = dict(kernels.LAUNCHES)
    finally:
        init_runtime(prev)
    assert launches["cuda"]["masked_moments"] == 6 and launches["cuda"]["binned_histograms"] == 4 + 2
    out = {dev: tmp_path / dev / "out" for dev in ("cuda", "cpu")}
    for name in ("continuum_missing.csv", "continuum_categorical.csv"):
        assert (out["cuda"] / name).read_bytes() == (out["cpu"] / name).read_bytes(), name
    # each device fits its own cutoffs (the card's may differ by an ulp)
    got, exp = (pd.read_csv(out[d] / "continuum_drift.csv") for d in ("cuda", "cpu"))
    assert got["flagged"].tolist() == exp["flagged"].tolist()
    for c in ("PSI", "HD", "JSD", "KS"):
        np.testing.assert_allclose(got[c], exp[c], rtol=0, atol=1e-4 + 1e-12, err_msg=c)
    got, exp = (pd.read_csv(out[d] / "continuum_stats.csv") for d in ("cuda", "cpu"))
    for c in ("count", "min", "max", "nonzero", "distinct_approx"):
        assert got[c].tolist() == exp[c].tolist(), c
    for c in ("mean", "stddev", "variance", "skewness", "kurtosis"):
        np.testing.assert_allclose(got[c], exp[c], rtol=1e-5, atol=1e-4, err_msg=c)


@pytest.mark.cuda
def test_cuda_concurrent_runner_equals_sequential(tmp_path, monkeypatch):
    """The JAX scheduler gate's demo config (stats, quality treatments,
    IV, drift, charts, the report, the writes) through the port's runner
    on the card in both modes: every file byte-equal, the HTML included;
    B1 and B2 launched as often in each mode; in the concurrent mode the
    device nodes ran on their workers' CUDA streams, in the sequential
    mode none did."""
    from examples._data import synthesize

    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.shared.runtime import get_runtime, init_runtime
    from test_torch_scheduler import _demo_cfg, tree_hashes

    _require_cuda()
    pq = tmp_path / "parquet"
    pq.mkdir()
    synthesize(50_000).to_parquet(pq / "part-0.parquet")
    prev = get_runtime().device
    trees, launches, streams = {}, {}, {}
    try:
        init_runtime("cuda")
        for mode in ("sequential", "concurrent"):
            d = tmp_path / mode
            d.mkdir()
            monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", mode)
            monkeypatch.setenv("ANOVOS_TPU_EXECUTOR_WORKERS", "4")
            monkeypatch.chdir(d)
            kernels.reset_launches()
            workflow.main(_demo_cfg(str(pq)), "local")
            launches[mode] = dict(kernels.LAUNCHES)
            streams[mode] = sum(n["stream"] for n in workflow.LAST_RUN_SUMMARY["nodes"].values())
            trees[mode] = tree_hashes(str(d))
    finally:
        init_runtime(prev)
    assert "report_stats/ml_anovos_report.html" in trees["sequential"]
    assert trees["sequential"] == trees["concurrent"]
    assert launches["sequential"] == launches["concurrent"]
    assert launches["concurrent"]["masked_moments"] > 0 and launches["concurrent"]["binned_histograms"] > 0
    assert streams["sequential"] == 0 and streams["concurrent"] > 0


@pytest.mark.cuda
def test_cuda_sequential_run_attributes_every_node(tmp_path, monkeypatch):
    """The scheduler gate's demo config through the port's runner on the
    card in the sequential mode: the manifest's backend is cuda, every
    node (those that launched B1 or B2 among them, attributed as the
    launches happen) has a devprof entry whose parts sum to at most its
    wall.  (Those nodes fetch their results before they end, so their device time is the
    sync's jitter above the floor: a few microseconds or 0;
    ``test_cuda_drain_books_the_work_in_flight`` holds the drain to work
    that is in flight.)"""
    from examples._data import synthesize

    from anovos_tpu_torch import obs, workflow
    from anovos_tpu_torch.obs import devprof
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.shared.runtime import get_runtime, init_runtime
    from test_torch_scheduler import _demo_cfg

    _require_cuda()
    pq = tmp_path / "parquet"
    pq.mkdir()
    synthesize(50_000).to_parquet(pq / "part-0.parquet")
    launching = set()
    count = kernels.count_launch

    def counted(name):
        if name in ("masked_moments", "binned_histograms"):
            launching.add(devprof.current_node())
        count(name)

    monkeypatch.setattr(kernels, "count_launch", counted)
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    monkeypatch.delenv("ANOVOS_TPU_DEVPROF", raising=False)
    monkeypatch.chdir(tmp_path)
    prev = get_runtime().device
    try:
        init_runtime("cuda")
        workflow.main(_demo_cfg(str(pq)), "local")
    finally:
        init_runtime(prev)
    man = obs.load_manifest(workflow.LAST_MANIFEST_PATH)
    assert man["backend"] == "cuda" and set(man["devprof"]) == set(man["scheduler"]["nodes"])
    assert launching and None not in launching and launching <= set(man["devprof"])
    for e in man["devprof"].values():
        assert e["device_time_s"] + e["dispatch_s"] + e["transfer_s"] + e["host_s"] <= e["wall_s"] + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sequential", "concurrent"])
def test_cuda_drain_books_the_work_in_flight(mode, monkeypatch):
    """A scheduler node that returns with a device sleep still queued on
    its stream: under ANOVOS_TPU_DEVPROF=full the drain that ends it books
    at least 0.8x the sleep's CUDA-event time as device time, and at most
    the node's wall."""
    from anovos_tpu_torch.obs import devprof
    from anovos_tpu_torch.parallel.scheduler import DagScheduler
    from anovos_tpu_torch.shared.runtime import get_runtime, init_runtime

    _require_cuda()
    monkeypatch.setenv("ANOVOS_TPU_DEVPROF", "full")
    events = []

    def body():
        stream = torch.cuda.current_stream()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(stream)
        torch.cuda._sleep(20_000_000)
        b.record(stream)
        events.append((a, b))

    prev = get_runtime().device
    try:
        init_runtime("cuda")
        sched = DagScheduler(name="drain")
        sched.add("in_flight", body, placement="device")
        devprof.reset()
        summary = sched.run(mode=mode, max_workers=1)
    finally:
        init_runtime(prev)
    a, b = events[0]
    slept = a.elapsed_time(b) / 1e3
    r = devprof.results()["in_flight"]
    assert summary["nodes"]["in_flight"]["stream"] == (mode == "concurrent")
    assert 0.8 * slept <= r["device_time_s"] <= r["wall_s"], (slept, r)
