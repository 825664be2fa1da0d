"""The compensated (chunked, float64-merged) moments of the port against
the JAX package's: ``compensated_moments`` at 1024-row chunks with a
ragged tail and an empty chunk, the merge's identity, the three
stats_generator frames that carry moments under
``ANOVOS_COMPENSATED_MOMENTS=1``, and the ``auto`` threshold.

Both packages centre each chunk in f32 and merge in float64; the port
shifts each column by its first valid value first (exact in f32), so its
chunk means keep more bits.  Where the JAX package's f32 chunk sums keep
the mean to a small share of the spread, the two agree to 1e-6 relative,
or 1e-6 of the column's spread for a mean near 0, a few times PERF.md's
compensated band against float64.  Where they do not (a normal(1e5, 3)
column in 1024-row chunks: each chunk mean off by ~0.01 of a spread of
3), the port stays within that band of float64 and the JAX package does
not; a test pins the difference."""

import numpy as np
import pytest

from _torch_port import income_frame, jax_and_port, moment_inputs, torch_cpu_runtime  # noqa: F401

KEYS = ("mean", "variance", "stddev", "skewness", "kurtosis")


def assert_near(got, exp, rtol, atol, what):
    """|got − exp| ≤ atol + rtol·|exp| elementwise (atol may be per
    element); NaN where exp is NaN."""
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(exp)), what
    ok = np.isnan(exp) | (np.abs(got - exp) <= atol + rtol * np.abs(exp))
    assert ok.all(), f"{what}: {got[~ok]} vs {exp[~ok]}"


def comp_inputs(rows=20_000, seed=8, offset=10.0):
    """moment_inputs with the large-mean column at ``offset`` (spread 3)."""
    X, M = moment_inputs(rows, seed)
    X[:, 0] = X[:, 0] - np.float32(1e5) + np.float32(offset)
    M[1024:2048, 1] = False  # a whole chunk of column 1 is null
    X[~M] = 0.0
    return X, M


def f64_moments(X, M):
    out = {k: [] for k in KEYS}
    for j in range(X.shape[1]):
        v = X[M[:, j], j].astype(np.float64)
        d = v - v.mean()
        m2 = (d * d).mean()
        for k, val in zip(KEYS, (v.mean(), v.var(ddof=1), v.std(ddof=1), (d ** 3).mean() / m2 ** 1.5,
                                 (d ** 4).mean() / m2 ** 2 - 3.0)):
            out[k].append(val)
    return {k: np.array(v) for k, v in out.items()}


def test_compensated_moments_match_jax():
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops.describe import compensated_moments as jcomp
    from anovos_tpu_torch.ops.describe import compensated_moments as pcomp

    X, M = comp_inputs()
    exp = jcomp(jnp.asarray(X), jnp.asarray(M), chunk=1024)
    got = pcomp(torch.from_numpy(X), torch.from_numpy(M), chunk=1024)
    np.testing.assert_array_equal(got["count"], exp["count"])
    for k in KEYS:
        floor = 1e-6 * (np.sqrt(exp["variance"]) if k == "mean" else 1.0)
        assert_near(got[k], exp[k], 1e-6, floor, k)


def test_large_offset_keeps_its_bits():
    """normal(1e5, 3) in 1024-row chunks: the port within 1e-7 (mean, or
    1e-7 of the spread near 0) and 1e-6 (variance) relative of float64 on the same f32 inputs, the JAX
    package's variance more than ten times as far off."""
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops.describe import compensated_moments as jcomp
    from anovos_tpu_torch.ops.describe import compensated_moments as pcomp

    X, M = comp_inputs(offset=1e5)
    ref = f64_moments(X, M)
    got = pcomp(torch.from_numpy(X), torch.from_numpy(M), chunk=1024)
    exp = jcomp(jnp.asarray(X), jnp.asarray(M), chunk=1024)
    assert_near(got["mean"], ref["mean"], 1e-7, 1e-7 * np.sqrt(ref["variance"]), "mean")
    assert_near(got["variance"], ref["variance"], 1e-6, 0, "variance")
    err_p = abs(got["variance"][0] - ref["variance"][0])
    err_j = abs(exp["variance"][0] - ref["variance"][0])
    assert err_j > 10 * err_p and err_j > 1e-5 * ref["variance"][0]


def test_empty_chunk_merges_as_identity():
    """A chunk with no valid value comes out of the moments kernel's
    plain version as n = 0, mean and central sums 0: merging it leaves
    the other side's statistics exactly as they were."""
    import torch

    from anovos_tpu_torch.ops.streaming import _chunk_stats, _combine, _pairwise_merge

    X, M = comp_inputs(4096)
    Xc = torch.from_numpy(np.ascontiguousarray(X[:2048].T))
    Mc = torch.from_numpy(np.ascontiguousarray(M[:2048].T))
    Mc[2] = False
    parts = _chunk_stats(Xc, Mc)
    empty = {k: v[2:3] for k, v in parts.items()}
    full = {k: v[0:1] for k, v in parts.items()}
    assert empty["n"][0] == 0 and empty["mean"][0] == 0 and empty["M2"][0] == 0
    for merged in (_combine(full, empty), _combine(empty, full), _pairwise_merge([empty, full, empty])):
        for k in ("n", "mean", "M2", "M3", "M4", "min", "max", "nonzero"):
            assert merged[k][0] == full[k][0], k


@pytest.mark.parametrize("fn", ["measures_of_centralTendency", "measures_of_dispersion",
                                "measures_of_shape"])
def test_compensated_frames_match_jax(fn, monkeypatch):
    """Frames under ANOVOS_COMPENSATED_MOMENTS=1 equal the JAX package's
    to one step of their 4 decimals (and 1e-6 relative)."""
    import pandas as pd

    from anovos_tpu.data_analyzer import stats_generator as jsg
    from anovos_tpu_torch.data_analyzer import stats_generator as psg

    monkeypatch.setenv("ANOVOS_COMPENSATED_MOMENTS", "1")
    jt, pt = jax_and_port(income_frame(3000, seed=4))
    exp, got = getattr(jsg, fn)(jt), getattr(psg, fn)(pt)
    assert list(got.columns) == list(exp.columns) and list(got["attribute"]) == list(exp["attribute"])
    for c in exp.columns[1:]:
        if not pd.api.types.is_numeric_dtype(exp[c]):
            assert got[c].astype(str).tolist() == exp[c].astype(str).tolist(), c
            continue
        g, e = got[c].to_numpy(np.float64), exp[c].to_numpy(np.float64)
        atol = 1e-4 * (2 * np.nan_to_num(np.sqrt(np.abs(e))) + 1) if c == "variance" else 1e-4
        assert_near(g, e, 1e-6, atol * (1 + 1e-6), c)


def test_compensated_mode_and_threshold(monkeypatch):
    """auto switches at 2^24 logical rows, as in the JAX package; 1 and 0
    force it; the mode is part of the describe cache key."""
    import torch

    from anovos_tpu.ops.describe import _compensated_enabled as jon
    from anovos_tpu_torch.ops import describe as pd_
    from anovos_tpu_torch.shared.table import Table

    for mode in ("auto", "1", "0", "always", "never"):
        monkeypatch.setenv("ANOVOS_COMPENSATED_MOMENTS", mode)
        for rows in ((1 << 24) - 1, 1 << 24):
            assert pd_._compensated_enabled(rows) == jon(rows), (mode, rows)
    monkeypatch.setenv("ANOVOS_COMPENSATED_MOMENTS", "auto")
    assert not pd_._compensated_enabled((1 << 24) - 1) and pd_._compensated_enabled(1 << 24)

    g = np.random.default_rng(0)
    t = Table.from_numpy({"x": (1e5 + g.normal(0, 3, 5000)).astype(np.float32)}, device="cpu")
    plain, _ = pd_.table_describe(t, ["x"], [])
    monkeypatch.setenv("ANOVOS_COMPENSATED_MOMENTS", "1")
    comp, _ = pd_.table_describe(t, ["x"], [])
    assert comp["mean"].dtype == np.float64 and plain["mean"].dtype == np.float32
    direct = pd_.compensated_moments(*t.numeric_block(["x"]))
    assert comp["variance"][0] == direct["variance"][0]
    assert len(t._describe_cache) == 2
    del torch
