"""The port's k-means (ops/cluster.py: Lloyd rounds, kmeans_fit, the
elbow sweep) against the JAX package's, on seeded numpy inputs.  The
port starts k-means from a torch.Generator draw, the JAX package from
jax.random: the Lloyd rounds are compared from JAX's own start, the
public functions by partition and chosen k.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import blobs, canon, centred, torch_cpu_runtime  # noqa: F401  (autouse fixture)


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,seed", [(4, 0), (2, 1), (4, 3)])
def test_lloyd_from_jax_init_matches(k, seed):
    """The port's Lloyd rounds (float64) from the centers jax.random.choice
    draws in kmeans_fit (f32): the same centers within 1e-5 relative and
    the same labels.  The blobs are far apart, so no point sits within the
    f32 distances' rounding of two centers."""
    from anovos_tpu.ops.cluster import kmeans_fit as jfit
    from anovos_tpu_torch.ops.cluster import _center_dists, _lloyd

    X = blobs(3000, 20 + seed, [(30, -100), (36, -100), (30, -92), (37, -91)], 0.4, noise=0.02,
              lo=25, hi=40)
    jc, jl, _ = jfit(jnp.asarray(X), k, seed=seed)
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), len(X), (k,), replace=False))
    Xt = torch.from_numpy(X).double()
    C = _lloyd(Xt, Xt[torch.from_numpy(idx.copy())], 50)
    np.testing.assert_allclose(C.float().numpy(), np.asarray(jc), rtol=1e-5)
    np.testing.assert_array_equal(_center_dists(Xt, C, None).argmin(1).numpy(), np.asarray(jl))


def test_inertia_sweep_batches_candidates(monkeypatch):
    """The elbow sweep runs every candidate k in one batched Lloyd round, so
    it takes at most ``iters`` rounds in all (not up to max_k times as
    many, each round a dozen tensor operations), and each candidate ends
    where its own ``_lloyd`` run ends.  Batched products may round in
    another order than single ones: within 1e-12 relative."""
    from anovos_tpu_torch.ops import cluster as pc

    X = torch.from_numpy(centred(blobs(3000, 5, [(0, 0), (4, 1), (-3, 3)], 0.5, noise=0.02))).double()
    max_k, iters = 12, 15
    rounds = []
    step = pc._lloyd_step
    monkeypatch.setattr(pc, "_lloyd_step", lambda *a: rounds.append(1) or step(*a))
    got = pc._kmeans_inertia_sweep(X, max_k, iters=iters).numpy()
    monkeypatch.undo()
    assert 1 < len(rounds) <= iters
    C0 = X[pc.kmeans_init_indices(len(X), max_k)]
    exp = []
    for k in range(1, max_k + 1):
        active = torch.arange(max_k) < k
        C = pc._lloyd(X, C0, iters, active)
        exp.append(float(torch.clamp_min(pc._center_dists(X, C, active).amin(dim=1).sum(), 0.0)))
    np.testing.assert_allclose(got, exp, rtol=1e-12)


def test_kmeans_fit_partition_matches_jax():
    """The public kmeans_fit starts from a torch.Generator draw: other
    center ids than the JAX package's, the same partition on separated
    blobs."""
    from anovos_tpu.ops.cluster import kmeans_fit as jfit
    from anovos_tpu_torch.ops.cluster import kmeans_fit

    X = blobs(2000, 9, [(30, -100), (34, -96)], 0.4)
    C, lbl, inertia = kmeans_fit(X, 2)
    jc, jl, ji = jfit(jnp.asarray(X), 2)
    np.testing.assert_array_equal(canon(lbl.numpy()), canon(np.asarray(jl)))
    order, jorder = np.argsort(C.numpy()[:, 0]), np.argsort(np.asarray(jc)[:, 0])
    np.testing.assert_allclose(C.numpy()[order], np.asarray(jc)[jorder], rtol=1e-5)
    np.testing.assert_allclose(float(inertia), float(ji), rtol=1e-3)


@pytest.mark.parametrize("centers,max_k", [([(0, 0), (6, 1)], 20), ([(40, -100), (35, -95)], 8)])
def test_kmeans_elbow_same_k(centers, max_k, monkeypatch):
    """Two separated blobs: both packages' sweeps put the knee at 2, though
    they start from different centers (a k = 2 Lloyd run on two blobs ends
    at the same partition from any start)."""
    from anovos_tpu.ops.cluster import kmeans_elbow as jelbow
    from anovos_tpu_torch.ops.cluster import kmeans_elbow

    monkeypatch.setenv("ANOVOS_KMEANS_ELBOW_SAMPLE", "2000")
    c = np.asarray(centers, float)
    X = blobs(3000, max_k, centers, 0.4, noise=0.01, lo=c.min(0) - 2, hi=c.max(0) + 2)
    k, inertias = kmeans_elbow(X, max_k=max_k)
    jk, jin = jelbow(X, max_k=max_k)
    assert k == jk == 2
    assert len(inertias) == len(jin) == max_k
    np.testing.assert_allclose(inertias[:2], np.asarray(jin)[:2], rtol=1e-4)
