"""Kernel B3's plain version (ops/kernels/neighbor_counts.py) and the
port's ``cluster.neighbor_counts`` against the JAX package's
``neighbor_counts_pallas`` in interpret mode and its ops/cluster.py, on
seeded numpy inputs.

Both packages evaluate d² = (|q|² − 2·q·x) + |x|² in f32, but XLA on the
CPU contracts the sums into FMAs while the port rounds every product, so
a pair whose d² lies within the f32 rounding band of eps² may count in
one package and not in the other.  ``band_counts`` finds those pairs in
float64, and the tests allow exactly the differences they explain.

The port's clustering tests are split over small files (this one,
test_torch_dbscan.py, test_torch_kmeans.py): ``--dist loadfile`` starts
the files with the most tests first, and a large file of these CPU-heavy
tests ran beside the suite's wall-clock tests.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import band_counts, blobs, centred, torch_cpu_runtime  # noqa: F401  (autouse fixture)


def assert_counts_explained(got, exp, band, what):
    diff = np.abs(got.astype(np.int64) - exp.astype(np.int64))
    assert np.all(diff <= band), f"{what}: {int((diff > band).sum())} counts differ beyond band pairs"
    if band.sum() == 0:
        np.testing.assert_array_equal(got, exp, err_msg=what)


# ---------------------------------------------------------------------------
# kernel B3: plain version vs the Pallas kernel and the XLA tile pass
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,eps", [(3000, 0.4), (1024, 0.05), (1500, 50.0), (257, 0.3)])
def test_b3_plain_matches_pallas_and_xla(n, eps):
    """The shapes of tests/test_pallas_kernels.py: four 0.3-sd blobs in a
    ±40 box, from nearly isolated points to blobs that all touch.
    Counts are exact except where band pairs explain the difference."""
    from anovos_tpu.ops.cluster import neighbor_counts as jax_counts
    from anovos_tpu.ops.pallas_kernels import neighbor_counts_pallas
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.cluster import neighbor_counts
    from anovos_tpu_torch.ops.kernels.neighbor_counts import neighbor_counts_plain, neighbor_counts_rows

    g = np.random.default_rng(n)
    X = blobs(n, n, g.uniform(-40, 40, size=(4, 2)), 0.3)
    Xc = centred(X)
    eps2 = float(np.float32(eps * eps))
    before = dict(kernels.LAUNCHES)
    got = neighbor_counts_rows(torch.from_numpy(Xc), eps2).numpy()
    assert kernels.LAUNCHES == before  # a CPU tensor runs the plain version, no launch
    assert got.dtype == np.int32 and got.min() >= 1
    np.testing.assert_array_equal(neighbor_counts(X, eps), got)
    np.testing.assert_array_equal(neighbor_counts_plain(torch.from_numpy(Xc), eps2, tile=256).numpy(), got)
    band = band_counts(Xc, eps)
    pallas = np.asarray(neighbor_counts_pallas(jnp.asarray(Xc), jnp.asarray(eps * eps, jnp.float32),
                                               interpret=True))
    assert_counts_explained(got, pallas, band, "vs neighbor_counts_pallas")
    assert_counts_explained(got, jax_counts(X, eps), band, "vs cluster.neighbor_counts")
    exact = np.array([(((Xc.astype(np.float64) - p) ** 2).sum(1) <= np.float32(eps * eps)).sum()
                      for p in Xc.astype(np.float64)])
    assert_counts_explained(got, exact, band, "vs float64")


def test_b3_boundary_regime():
    """A lattice whose spacing IS eps: about half of all neighbour pairs
    sit on the threshold.  Every difference from the JAX package must be
    explained by a pair inside the band, and the band must be populated."""
    from anovos_tpu.ops.cluster import neighbor_counts as jax_counts
    from anovos_tpu_torch.ops.cluster import neighbor_counts

    eps = 0.125
    g = np.random.default_rng(11)
    i, j = np.meshgrid(np.arange(40), np.arange(30), indexing="ij")
    X = (np.stack([i.ravel(), j.ravel()], 1) * eps + g.uniform(-3, 3, (1, 2))).astype(np.float32)
    band = band_counts(centred(X), eps)
    assert band.sum() > len(X)  # the boundary regime: most points have pairs on the threshold
    got, exp = neighbor_counts(X, eps), jax_counts(X, eps)
    assert_counts_explained(got, exp, band, "boundary lattice")


def test_b3_wrapper_refuses_other_devices():
    from anovos_tpu_torch.ops.kernels.neighbor_counts import neighbor_counts_rows

    with pytest.raises(ValueError):
        neighbor_counts_rows(torch.empty((4, 2), device="meta"), 0.1)
    with pytest.raises(ValueError):
        neighbor_counts_rows(torch.zeros(4), 0.1)
