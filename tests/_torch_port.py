"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: the same seeded host inputs go through both."""

import json
import os

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def torch_cpu_runtime():
    """The port runs on the CPU in these tests (its plain kernel versions)."""
    from anovos_tpu_torch.shared.runtime import init_runtime

    return init_runtime("cpu")


def port_table_from_jax(jt):
    """The port's Table holding exactly the JAX Table's columns."""
    from anovos_tpu_torch.shared.convert import table_from_numpy_columns

    cols = {}
    for name, c in jt.columns.items():
        exact = None
        if c.is_wide:
            exact = (np.asarray(c.wide_hi), np.asarray(c.wide_lo), c.wide_kind)
        cols[name] = (np.asarray(c.data), np.asarray(c.mask), c.vocab, c.dtype_name, exact)
    return table_from_numpy_columns(cols, jt.nrows)


def income_frame(n: int, seed: int = 7):
    """The income schema of examples/_data.py at ``n`` rows, with the
    columns the drift bench drops removed."""
    from examples._data import synthesize

    return synthesize(n, seed=seed).drop(columns=["ifa", "dt_1", "dt_2", "empty", "logfnl"])


def assert_frames_close(got, exp, exact_cols=(), rtol=0.0, atol=0.0):
    """Same columns and rows; ``exact_cols`` equal, the numeric rest within
    rtol/atol, everything else equal as strings."""
    import pandas as pd

    assert list(got.columns) == list(exp.columns)
    assert len(got) == len(exp)
    for c in got.columns:
        g, e = got[c], exp[c]
        if c not in exact_cols and pd.api.types.is_numeric_dtype(e) and pd.api.types.is_numeric_dtype(g):
            np.testing.assert_allclose(g.to_numpy(np.float64), e.to_numpy(np.float64),
                                       rtol=rtol, atol=atol, equal_nan=True, err_msg=c)
        else:
            assert [None if pd.isna(v) else str(v) for v in g] == \
                [None if pd.isna(v) else str(v) for v in e], c


def hist_inputs(rows, k, nbins, seed, nan_rows=(), dead_cols=()):
    g = np.random.default_rng(seed)
    X = g.normal(50, 20, (rows, k)).astype(np.float32)
    M = g.random((rows, k)) > 0.1
    cuts = np.sort(g.normal(50, 20, (k, nbins - 1)), axis=1).astype(np.float32)
    # values sitting exactly on a cutoff must go to the lower bin
    X[: min(rows, nbins - 1), 0] = cuts[0, : min(rows, nbins - 1)]
    for j in nan_rows:
        cuts[j] = np.nan
    for j in dead_cols:
        M[:, j] = False
    return X, M, cuts


HIST_CASES = [
    (5000, 6, 10, (), ()),
    (2049, 3, 10, (1,), ()),  # ragged tile + NaN cutoff row → bin 0
    (1, 2, 10, (), (1,)),  # one row, all-masked column
    (4097, 4, 2, (), (0,)),
    (3000, 5, 32, (4,), (2,)),
]


def assert_close(got, exp, rtol, atol, what):
    """|got - exp| <= atol + rtol·|exp| elementwise, atol per column."""
    err = np.abs(got.astype(np.float64) - exp.astype(np.float64))
    bound = np.asarray(atol, np.float64) + rtol * np.abs(exp.astype(np.float64))
    assert np.all(err <= bound), f"{what}: err {err} > bound {bound}"


def moment_inputs(rows, seed):
    g = np.random.default_rng(seed)
    X = np.stack([g.normal(1e5, 3.0, rows), g.exponential(5, rows), g.normal(0, 1, rows),
                  np.where(g.random(rows) < 0.3, 0.0, g.gamma(2, 3, rows))], 1).astype(np.float32)
    M = g.random((rows, 4)) > 0.1
    M[0, 0] = False  # the large-mean column starts with a null
    M[:, 2] = False if rows < 3000 else M[:, 2]
    X[~M] = 0.0  # a null is stored as 0, as in the Table
    return X, M


def assert_moments_close(got, exp, rtol):
    """Two (8, k) moment accumulators [n, mean, M2, M3, M4, min, max,
    nonzero]: n/min/max/nonzero equal; mean within rtol·(|mean| + σ); M2,
    M3, M4 within rtol relative plus rtol · n · σ^p (central sums of
    near-symmetric data sit near 0, where a relative band alone says
    nothing) plus the shift a rounded tile mean gives them.

    The plain version and the Pallas kernel take a two-pass sum over each
    2048-row tile; the summation order moves a tile mean by a few ulps of
    the tile sum over 2048, Δ ≤ 4 · spacing(|mean| · 2048) / 2048 (0.03 for
    a normal(1e5, 3) column, 2e-6 for a mean near 5), and a central sum
    around a mean off by Δ moves by its binomial terms: n·Δ² for M2,
    3·Δ·M2 + n·Δ³ for M3, 4·Δ·|M3| + 6·Δ²·M2 + n·Δ⁴ for M4."""
    for row in (0, 5, 6, 7):
        np.testing.assert_array_equal(got[row], exp[row])
    e = exp.astype(np.float64)
    n = np.maximum(e[0], 1)
    sigma = np.sqrt(np.maximum(e[2], 0) / n)
    d = 4 * np.spacing(np.abs(e[1] * 2048).astype(np.float32)).astype(np.float64) / 2048
    assert_close(got[1], exp[1], rtol, rtol * sigma, "mean")
    assert_close(got[2], exp[2], rtol, rtol * n * sigma ** 2 + n * d ** 2, "M2")
    assert_close(got[3], exp[3], rtol, rtol * n * sigma ** 3 + 3 * d * e[2] + n * d ** 3, "M3")
    assert_close(got[4], exp[4], rtol,
                 rtol * n * sigma ** 4 + 4 * d * np.abs(e[3]) + 6 * d ** 2 * e[2] + n * d ** 4, "M4")


# -- geospatial slice: point sets and the f32 band of eps² ----------------

# the step of lattice_points: 29/1024 degrees keeps every lattice d²
# = step²·(i² + j²) at least 1.7e-4 away from f32(eps²) for every eps of
# the analyzer's default grid 0.3, 0.35, ..., 0.5
STEP = 29 / 1024
GRID_EPS = [float(e) for e in np.arange(0.3, 0.5 + 1e-9, 0.05)]


def centred(X):
    """The points as both packages centre them: numpy f32 on the host."""
    X = np.asarray(X, np.float32)
    return X - X.mean(axis=0, keepdims=True)


def band_counts(Xc, eps, rows=1024):
    """Per point, the pairs (self excluded) whose float64 d² lies within 8
    f32 ulps of |q|² + |x|² (the scale of the expansion's rounding) of
    f32(eps²): the pairs rounding can move across the threshold."""
    eps2 = np.float32(eps * eps)
    X = np.asarray(Xc, np.float32).astype(np.float64)
    nrm = (X * X).sum(1)
    out = np.zeros(len(X), np.int64)
    for s in range(0, len(X), rows):
        d2 = ((X[s:s + rows, None, :] - X[None, :, :]) ** 2).sum(-1)
        S = (nrm[s:s + rows, None] + nrm[None, :]).astype(np.float32)
        tol = 8 * np.spacing(S).astype(np.float64) + 8 * float(np.spacing(eps2))
        inband = np.abs(d2 - float(eps2)) <= tol
        inband[np.arange(len(d2)), np.arange(s, s + len(d2))] = False
        out[s:s + rows] = inband.sum(1)
    return out


def blobs(n, seed, centers, sd, noise=0.0, lo=-5.0, hi=5.0):
    g = np.random.default_rng(seed)
    centers = np.asarray(centers, float)
    k = len(centers)
    X = centers[g.integers(0, k, n)] + g.normal(0, sd, (n, centers.shape[1]))
    nn = int(round(noise * n))
    if nn:
        X[:nn] = g.uniform(lo, hi, (nn, centers.shape[1]))
    return X.astype(np.float32)


def lattice_points(n, seed, centers, sd=0.3, noise=0.02, base=(12.0, 20.0)):
    """Blobs + uniform noise snapped to a STEP lattice around ``base``: f32
    holds every coordinate exactly, so pair distances are step²·(i² + j²)
    up to the centring's rounding."""
    X = blobs(n, seed, centers, sd, noise, lo=-3.0, hi=3.0).astype(np.float64)
    return (np.asarray(base) + np.round(X / STEP) * STEP).astype(np.float32)


def assert_no_band_pairs(X, eps_list):
    """The premise of the exact-label DBSCAN tests, for once- and
    twice-centred points (dbscan_grid centres, then neighbor_counts centres
    again): no pair lies in the f32 band of any eps."""
    for Xc in (centred(X), centred(centred(X))):
        for eps in eps_list:
            assert band_counts(Xc, eps).sum() == 0, f"pairs in the f32 band of eps={eps}"


def canon(labels):
    """Labels renamed by first appearance (noise stays -1)."""
    out = np.full(len(labels), -1, np.int64)
    seen = {}
    for i, v in enumerate(labels):
        if v >= 0:
            out[i] = seen.setdefault(v, len(seen))
    return out


# -- the geospatial analyzer's outputs --------------------------------------

# 4-decimal outputs of two packages whose f32 roundings differ can land
# one unit apart
ATOL = 1e-4 * (1 + 1e-6)


def geo_frame(n, seed, gh_precision=7):
    """Two 0.3-degree cities 3 degrees apart plus 1% noise on the lattice,
    lat/lon with 1% nulls each, a geohash of the same points and an id."""
    import pandas as pd

    from anovos_tpu_torch.data_transformer.geo_utils import geohash_encode

    X = lattice_points(n, seed, [(0.0, 0.0), (2.4, 1.8)], sd=0.3, noise=0.01, base=(4.0, 6.0))
    g = np.random.default_rng(seed + 1)
    lat, lon = X[:, 0].astype(np.float64), X[:, 1].astype(np.float64)
    gh = [geohash_encode(a, o, gh_precision) for a, o in zip(lat, lon)]
    lat[g.random(n) < 0.01] = np.nan
    lon[g.random(n) < 0.01] = np.nan
    return pd.DataFrame({"id": np.arange(n), "latitude": lat, "longitude": lon, "geohash": gh})


def assert_dirs_match(got_dir, exp_dir):
    """Same files; CSVs with equal integer/string columns and floats within
    ATOL (k-means rows sorted by center first); chart JSON equal."""
    import pandas as pd

    names = sorted(os.listdir(exp_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        if os.path.isdir(os.path.join(exp_dir, name)):
            continue
        gp, ep = os.path.join(got_dir, name), os.path.join(exp_dir, name)
        if not name.endswith(".csv"):
            with open(gp) as fg, open(ep) as fe:
                assert json.load(fg) == json.load(fe), name
            continue
        got, exp = pd.read_csv(gp), pd.read_csv(ep)
        assert list(got.columns) == list(exp.columns) and len(got) == len(exp), name
        if "lat_center" in exp.columns:
            got = got.sort_values(["lat_center", "lon_center"]).reset_index(drop=True)
            exp = exp.sort_values(["lat_center", "lon_center"]).reset_index(drop=True)
            got, exp = got.drop(columns="cluster"), exp.drop(columns="cluster")
        for c in exp.columns:
            if pd.api.types.is_float_dtype(exp[c]) and pd.api.types.is_float_dtype(got[c]):
                np.testing.assert_allclose(got[c], exp[c], rtol=0, atol=ATOL, equal_nan=True,
                                           err_msg=f"{name}:{c}")
            else:
                assert got[c].astype(str).tolist() == exp[c].astype(str).tolist(), f"{name}:{c}"


# -- quality checks: config/configs_full.yaml's arguments and their table -----

QUALITY_TOKENS = ["n/a", "unknown", "###", "aaa", "abc"]

def _quality_config():
    import pathlib

    import yaml

    path = pathlib.Path(__file__).resolve().parents[1] / "config" / "configs_full.yaml"
    return yaml.safe_load(path.read_text())["quality_checker"]


# config/configs_full.yaml's quality_checker block: {check: its arguments},
# in the file's order
QUALITY_CONFIG = _quality_config()


def quality_frame(n=2000, seed=5):
    """The income schema with 2% null ages, 5% null workclass, rows that
    are mostly null, 100 exact duplicate rows, the auto rules' tokens in a
    string column, a float column with '111.0' values and an almost-constant
    column ("ifa" is id-like)."""
    import pandas as pd

    from examples._data import synthesize

    df = synthesize(n, seed=seed).drop(columns=["dt_1", "dt_2", "logfnl"])
    g = np.random.default_rng(seed)
    df.loc[g.random(n) < 0.05, "workclass"] = None
    df["tokens"] = g.choice(["alpha", "beta", "gamma"] + QUALITY_TOKENS, n,
                            p=[0.3, 0.3, 0.3] + [0.02] * 5)
    df["score"] = np.where(g.random(n) < 0.1, 111.0, g.normal(50, 10, n).round(2))
    df["flat"] = np.where(g.random(n) < 0.99, 1.0, 2.0)
    df.loc[g.random(n) < 0.01, ["age", "fnlwgt", "workclass", "education", "occupation",
                                "race", "sex", "capital-gain", "capital-loss", "hours-per-week",
                                "native-country", "latitude", "longitude", "geohash",
                                "education-num", "marital-status", "relationship",
                                "score", "tokens"]] = None
    df = pd.concat([df, df.iloc[:100]], ignore_index=True)
    return df


def quality_tables():
    """quality_frame() as a JAX Table and a port Table on the CPU."""
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    df = quality_frame()
    return JTable.from_pandas(df), Table.from_pandas(df, device="cpu")


def quality_both(name, jt, pt, **kw):
    """(port's (table, stats), JAX's (table, stats)) of one check."""
    from anovos_tpu.data_analyzer import quality_checker as jq
    from anovos_tpu_torch.data_analyzer import quality_checker as pq

    jo, js = getattr(jq, name)(jt, **kw)
    po, ps = getattr(pq, name)(pt, **kw)
    return (po, ps), (jo, js)


def assert_quality_same(got, exp, rtol=0.0, atol=0.0):
    """Equal stats frames and treated tables (names, dtypes, values)."""
    (po, ps), (jo, js) = got, exp
    assert_frames_close(ps, js, rtol=rtol, atol=atol)
    assert po.col_names == jo.col_names and po.nrows == jo.nrows
    assert po.dtypes() == jo.dtypes()
    assert_frames_close(po.to_pandas(), jo.to_pandas(), rtol=rtol)


# -- ingest: join sides and frames in both packages ---------------------------

JOIN_KEYS = ["kcat", "kf", "kbig"]


def join_sides(seed):
    """Left and right frames sharing the three key kinds: strings with
    nulls, f32 values with nulls, int64 ids above 2^32 (exact); some keys
    repeat on the right, some exist on one side only."""
    import pandas as pd

    g = np.random.default_rng(seed)
    pool = np.arange(40)
    lk, rk = g.choice(pool[:30], 60), g.choice(pool[10:], 50)

    def frame(k, prefix):
        kf = (k * 0.5).astype(np.float64)
        kcat = np.array([f"key{v}" for v in k], dtype=object)
        kcat[::9] = None
        kf[::8] = np.nan
        return pd.DataFrame({"kcat": kcat, "kf": kf, "kbig": k.astype(np.int64) + 2**40,
                             f"{prefix}_num": g.normal(0, 1, len(k)),
                             f"{prefix}_cat": g.choice(["x", "y", "z"], len(k)),
                             f"{prefix}_int": g.integers(0, 9, len(k)).astype(np.int32)})

    return frame(lk, "a"), frame(rk, "b")


def jax_and_port(df):
    """One frame as a JAX Table and a port Table on the CPU."""
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    return JTable.from_pandas(df), Table.from_pandas(df, device="cpu")


def thread_names():
    import threading

    return {t.name for t in threading.enumerate()}


def assert_no_thread_left(before, settle_s=10.0, prefix=""):
    """No thread name (starting with ``prefix``) that was not there before
    the test is left after it: a thread that is ending (a scheduler worker
    polls its queue every 50 ms) gets ``settle_s`` to go."""
    import time

    deadline = time.monotonic() + settle_s
    while True:
        left = {n for n in thread_names() - before if n.startswith(prefix)}
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert not left, f"threads left behind: {sorted(left)}"


@pytest.fixture
def failover_isolated():
    """For a test that flips a runtime: afterwards both packages' failover
    state, chaos plan (and its wedge flag), degradation registry and flight
    recorder are reset, the port's CPU runtime and JAX's default device put
    back, and it asserts that no flip, no wedge and no ``anovos-torch-*``
    thread outlives the test in the shared worker."""
    import jax

    from anovos_tpu.obs import flight as jflight
    from anovos_tpu.resilience import chaos as jchaos
    from anovos_tpu.resilience import failover as jfailover
    from anovos_tpu.resilience import policy as jpolicy
    from anovos_tpu_torch.obs import flight
    from anovos_tpu_torch.resilience import chaos, failover, policy
    from anovos_tpu_torch.shared.runtime import get_runtime, init_runtime

    before = thread_names()
    jax_default = jax.config.jax_default_device
    yield
    for mod in (chaos, jchaos, failover, jfailover):
        mod.reset()
    for mod in (policy, jpolicy):
        mod.reset_degraded()
    for mod in (flight, jflight):
        mod.reset()
    jax.config.update("jax_default_device", jax_default)
    init_runtime("cpu")
    assert failover.failover_count() == 0 and not failover._STATE["flipped"]
    assert not chaos.backend_wedged() and not jchaos.backend_wedged()
    assert get_runtime().device.type == "cpu"
    assert_no_thread_left(before, prefix="anovos-torch-")


def free_port() -> int:
    """A port the OS hands out for port 0, closed again: for the knobs that
    take a port number."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
