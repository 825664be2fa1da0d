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
