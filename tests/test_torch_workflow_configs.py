"""The port's YAML runner against the JAX package's on
``config/configs_sales_supervised.yaml`` and
``config/configs_segmentation_unsupervised.yaml``, each on a synthesized
frame with the config's column names (the reference datasets are not in
the repo), its read paths pointed at CSVs of that frame and its
dictionaries set to ``NA``: the whole output trees (``report_stats``,
``intermediate_data`` and the final dataset) compared as in
``tests/test_torch_workflow.py``.

The segmentation config trains the autoencoder: the test cuts its epochs
from 30 to 2 (keeps the run short) and starts the port from the JAX
package's initial weights and batch orders (its own come from a
``torch.Generator``).  Its latents are held to lr · steps · (1 + |x|)
(0.012 here): every dense bias but the output's is a shift the next
BatchNorm removes, so its gradient is 0 in exact arithmetic and each
package moves it by Adam's lr a step in the direction of its own rounding
noise, which eval-mode BatchNorm passes on (its running mean follows only
0.01 of it a step).  The label encoding and everything before it are
exact."""

import os

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)
from test_torch_workflow import assert_chart_close, assert_csv_close, load_config, run_both, tree

ROWS = 2000
AE_EPOCHS = 2


def sales_frame(n: int, seed: int) -> pd.DataFrame:
    """The sales dataset's columns (BigMart): ids, item and outlet
    attributes with nulls, and the 'sales' label ('>2k' / '<=2k') rising
    with the item's MRP."""
    g = np.random.default_rng(seed)
    mrp = g.uniform(30, 270, n).round(2)
    df = pd.DataFrame({
        "Item_Identifier": [f"FD{i % 1500:04d}" for i in range(n)],
        "Item_Weight": g.normal(12.8, 4.6, n).round(3),
        "Item_Fat_Content": g.choice(["Low Fat", "Regular", "LF", "reg"], n, p=[0.6, 0.32, 0.05, 0.03]),
        "Item_Visibility": g.gamma(2.0, 0.033, n).round(6),
        "Item_Type": g.choice(["Dairy", "Soft Drinks", "Meat", "Fruits and Vegetables", "Household",
                               "Baking Goods", "Snack Foods", "Frozen Foods"], n),
        "Item_MRP": mrp,
        "Outlet_Identifier": g.choice([f"OUT0{i:02d}" for i in range(10)], n),
        "Outlet_Establishment_Year": g.choice([1985, 1987, 1997, 1998, 1999, 2002, 2004, 2007, 2009], n),
        "Outlet_Size": g.choice(["Small", "Medium", "High"], n),
        "Outlet_Location_Type": g.choice(["Tier 1", "Tier 2", "Tier 3"], n),
        "Outlet_Type": g.choice(["Grocery Store", "Supermarket Type1", "Supermarket Type2",
                                 "Supermarket Type3"], n),
        "sales": np.where(mrp * g.uniform(5, 25, n) > 2000, ">2k", "<=2k"),
    })
    df.loc[g.random(n) < 0.17, "Item_Weight"] = np.nan
    df.loc[g.random(n) < 0.28, "Outlet_Size"] = None
    return df


def segmentation_frame(n: int, seed: int) -> pd.DataFrame:
    """The segmentation dataset's columns: an id, demographics with nulls,
    a spending score and the segment."""
    g = np.random.default_rng(seed)
    df = pd.DataFrame({
        "ID": np.arange(458000, 458000 + n),
        "Gender": g.choice(["Male", "Female"], n),
        "Ever_Married": g.choice(["Yes", "No"], n),
        "Age": g.integers(18, 90, n),
        "Graduated": g.choice(["Yes", "No"], n),
        "Profession": g.choice(["Artist", "Healthcare", "Entertainment", "Engineer", "Doctor", "Lawyer",
                                "Executive", "Marketing", "Homemaker"], n),
        "Work_Experience": g.choice([0.0, 1.0, 2.0, 4.0, 8.0, 9.0, 14.0], n),
        "Spending_Score": g.choice(["Low", "Average", "High"], n),
        "Family_Size": g.choice([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 9.0], n),
        "Var_1": g.choice([f"Cat_{i}" for i in range(1, 8)], n),
        "Segmentation": g.choice(["A", "B", "C", "D"], n),
    })
    for c, p in (("Ever_Married", 0.02), ("Graduated", 0.01), ("Profession", 0.015),
                 ("Work_Experience", 0.1), ("Family_Size", 0.04), ("Var_1", 0.01)):
        df.loc[g.random(n) < p, c] = None if df[c].dtype == object else np.nan
    return df


def _csv_dir(root: str, name: str, df: pd.DataFrame) -> str:
    d = os.path.join(root, "data", name)
    os.makedirs(d)
    df.to_csv(os.path.join(d, "part-00000.csv"), index=False)
    return d


def sales_config(root: str) -> dict:
    cfg = load_config("configs_sales_supervised.yaml")
    cfg["input_dataset"]["read_dataset"]["file_path"] = _csv_dir(root, "main", sales_frame(ROWS, 1))
    drift = cfg["drift_detector"]
    drift["drift_statistics"]["source_dataset"]["read_dataset"]["file_path"] = _csv_dir(
        root, "source", sales_frame(ROWS, 2))
    num = sales_frame(ROWS, 3).select_dtypes("number")
    for i in range(3):
        drift["stability_index"][f"dataset{i + 1}"]["read_dataset"]["file_path"] = _csv_dir(
            root, f"si{i}", num.iloc[i * ROWS // 3:(i + 1) * ROWS // 3])
    cfg["report_generation"]["dataDict_path"] = "NA"
    cfg["report_generation"]["metricDict_path"] = "NA"
    return cfg


def segmentation_config(root: str) -> dict:
    cfg = load_config("configs_segmentation_unsupervised.yaml")
    cfg["input_dataset"]["read_dataset"]["file_path"] = _csv_dir(root, "main", segmentation_frame(ROWS, 4))
    cfg["transformers"]["numerical_latentFeatures"]["autoencoder_latentFeatures"]["epochs"] = AE_EPOCHS
    cfg["report_generation"]["dataDict_path"] = "NA"
    return cfg


def assert_trees_close(runs: dict, sub: str, latent_rule=None) -> list:
    got_dir, exp_dir = (os.path.join(runs[p], sub) for p in ("port", "jax"))
    names = [n for n in tree(exp_dir) if not n.endswith("ml_anovos_report.html")]
    assert [n for n in tree(got_dir) if not n.endswith("ml_anovos_report.html")] == names
    for rel in names:
        gp, ep = os.path.join(got_dir, rel), os.path.join(exp_dir, rel)
        if rel.endswith(".parquet"):
            got, exp = pd.read_parquet(gp), pd.read_parquet(ep)
            if latent_rule and any(c.startswith("latent_") for c in exp.columns):
                latent_rule(got, exp)
            else:
                pd.testing.assert_frame_equal(got, exp, obj=rel)
        elif rel.endswith(".csv") and os.path.getsize(ep):
            assert_csv_close(gp, ep)
        elif rel.endswith(".csv") or os.path.basename(rel) == "_SUCCESS":
            assert os.path.getsize(gp) == os.path.getsize(ep) == 0, rel
        else:
            assert_chart_close(gp, ep)
    return names


@pytest.fixture(scope="module")
def sales_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sales"))
    return run_both(sales_config(root), root)


@pytest.mark.parametrize("sub", ["report_stats", "intermediate_data", "output"])
def test_sales_supervised_trees_match_jax(sales_runs, sub):
    names = assert_trees_close(sales_runs, sub)
    assert names
    if sub == "report_stats":
        for n in ("correlation_matrix.csv", "IV_calculation.csv", "drift_statistics.csv",
                  "stability_index.csv", "eventDist_Item_Type"):
            assert n in names, n
    assert sales_runs["degraded"] == {}


def jax_autoencoder_draws(monkeypatch):
    """The port's autoencoder started from the JAX package's initial
    weights (``jax.random``, seed 0) and batch orders (``jax.random``
    permutations of the fit's key chain)."""
    import jax
    import torch

    from anovos_tpu.models.autoencoder import AutoEncoder as JAE
    from anovos_tpu_torch.models import autoencoder as pae

    def init_params(self, device=None):
        tree = jax.tree_util.tree_map(np.asarray, JAE(self.n_inputs, self.n_bottleneck, seed=self.seed,
                                                      compute_dtype="f32").init_params())
        return self.net_from_state(pae.params_from_jax(tree), device)

    keys = {}

    def epoch_order(n, generator, device):
        key = keys.get(id(generator), jax.random.PRNGKey(0))
        key, sub = jax.random.split(key)
        keys[id(generator)] = key
        return torch.from_numpy(np.asarray(jax.random.permutation(sub, n)).astype(np.int64)).to(device)

    monkeypatch.setattr(pae.AutoEncoder, "init_params", init_params)
    monkeypatch.setattr(pae, "epoch_order", epoch_order)


@pytest.fixture(scope="module")
def segmentation_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("segmentation"))
    with pytest.MonkeyPatch.context() as mp:
        jax_autoencoder_draws(mp)
        return run_both(segmentation_config(root), root)


def _latents_rule(got: pd.DataFrame, exp: pd.DataFrame) -> None:
    lat = [c for c in exp.columns if c.startswith("latent_")]
    assert list(got.columns) == list(exp.columns) and len(lat) == 5
    pd.testing.assert_frame_equal(got.drop(columns=lat), exp.drop(columns=lat))
    band = 1e-3 * AE_EPOCHS * (int(ROWS * 0.8) // 256)  # lr · steps
    for c in lat:
        np.testing.assert_allclose(got[c], exp[c], rtol=band, atol=band, err_msg=c)


@pytest.mark.parametrize("sub", ["report_stats", "output"])
def test_segmentation_unsupervised_trees_match_jax(segmentation_runs, sub):
    names = assert_trees_close(segmentation_runs, sub, _latents_rule)
    assert names
    assert segmentation_runs["degraded"] == {}
    assert "transformers, autoencoder_latentFeatures" in segmentation_runs["block_times"]
