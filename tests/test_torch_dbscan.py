"""The port's DBSCAN labelings (ops/cluster.py: dbscan_grid, dbscan_fit,
the host grid) against the JAX package's, on seeded numpy inputs.

Both packages evaluate d² = (|q|² − 2·q·x) + |x|² in f32, but XLA on the
CPU contracts the sums into FMAs while the port rounds every product, so
a pair whose d² lies within the f32 rounding band of eps² may count in
one package and not in the other.  These tests use lattice points whose pair distances all
stay far from every eps (``lattice_points``), assert that premise, and
then ask for equal labels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import (  # noqa: F401  (torch_cpu_runtime: autouse fixture)
    GRID_EPS, assert_no_band_pairs, canon, centred, lattice_points, torch_cpu_runtime)


# ---------------------------------------------------------------------------
# DBSCAN: labels exactly equal on inputs without band pairs
# ---------------------------------------------------------------------------
def _dbscan_points():
    return lattice_points(1600, 5, [(0.0, 0.0), (1.5, 0.5), (-1.0, 1.8)], sd=0.25, noise=0.05)


def test_dbscan_grid_matches_jax():
    from anovos_tpu.ops.cluster import dbscan_grid as jgrid
    from anovos_tpu_torch.ops.cluster import dbscan_grid

    X = _dbscan_points()
    eps_list = GRID_EPS[:2]
    assert_no_band_pairs(X, eps_list)
    for eps in eps_list:
        ms = [5, 40, 90, 200]
        got, exp = dbscan_grid(X, eps, ms), jgrid(X, eps, ms)
        np.testing.assert_array_equal(got, exp)
        assert (got >= 0).any() and (got < 0).any()


def test_dbscan_grid_over_batch_max_takes_dbscan_fit(monkeypatch):
    """Above ANOVOS_DBSCAN_BATCH_MAX both packages label per combo."""
    from anovos_tpu.ops.cluster import dbscan_grid as jgrid
    from anovos_tpu_torch.ops.cluster import dbscan_grid

    monkeypatch.setenv("ANOVOS_DBSCAN_BATCH_MAX", "512")
    X = _dbscan_points()
    assert_no_band_pairs(X, [0.3])
    np.testing.assert_array_equal(dbscan_grid(X, 0.3, [10, 60], tile=512),
                                  jgrid(X, 0.3, [10, 60], tile=512))


@pytest.mark.parametrize("min_samples", [3, 30, 120, 5000])
def test_dbscan_fit_matches_jax(min_samples):
    from anovos_tpu.ops.cluster import dbscan_fit as jfit
    from anovos_tpu_torch.ops.cluster import dbscan_fit

    X = _dbscan_points()
    assert_no_band_pairs(X, [0.35])
    got = dbscan_fit(X, 0.35, min_samples, tile=512)
    np.testing.assert_array_equal(got, jfit(X, 0.35, min_samples, tile=512))
    if min_samples == 5000:
        assert (got == -1).all()


def test_dbscan_host_grid_multi_matches_jax():
    """Each package's pairwise_d2 into its own host grid, and one shared
    matrix into both (the host code alone); the host grid agrees with the
    device labeling of dbscan_grid."""
    from anovos_tpu.ops.cluster import dbscan_host_grid_multi as jhost
    from anovos_tpu.ops.cluster import pairwise_d2 as jd2
    from anovos_tpu_torch.ops.cluster import dbscan_grid, dbscan_host_grid, dbscan_host_grid_multi, pairwise_d2

    X = _dbscan_points()
    assert_no_band_pairs(X, GRID_EPS)
    Xc = centred(X)
    D2 = pairwise_d2(torch.from_numpy(Xc)).numpy()
    D2j = np.asarray(jd2(jnp.asarray(Xc)))
    # both round the expansion: within 8 ulps of the largest |q|² + |x|²
    smax = np.float32(2 * (Xc.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(D2, D2j, rtol=0, atol=8 * float(np.spacing(smax)))
    ms = [4, 25, 60, 150, 400]
    got = dbscan_host_grid_multi(D2, GRID_EPS, ms)
    np.testing.assert_array_equal(got, jhost(D2j, GRID_EPS, ms))
    np.testing.assert_array_equal(dbscan_host_grid_multi(D2j, GRID_EPS, ms), jhost(D2j, GRID_EPS, ms))
    np.testing.assert_array_equal(dbscan_host_grid(D2, GRID_EPS[1], ms), got[1])
    for a, eps in enumerate(GRID_EPS[:2]):
        dev = dbscan_grid(X, eps, ms)
        for b in range(len(ms)):
            np.testing.assert_array_equal(canon(got[a, b]), canon(dev[b]))
    assert dbscan_host_grid_multi(D2, [], ms).shape == (0, len(ms), len(X))
