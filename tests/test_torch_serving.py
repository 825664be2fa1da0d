"""The port's serving subsystem (``anovos_tpu_torch/serving``) against the
JAX package's (``anovos_tpu/serving``), case by case as
``tests/test_serving.py`` holds the JAX one, on the same seeded
``demo_frame`` data:

* ``fitted_state`` → JSON → ``from_state`` → apply byte-identical to the
  port's batch fit + apply, per family and for the whole demo chain, and
  equal to the JAX package's apply of the same state;
* bundles: the port's ``fit_bundle`` document has JAX's keys, chain and
  schema; the CAS round trip, idempotence and the three refusals; a bundle
  either package exported loads in the other;
* the server: concurrent mixed-width clients get byte-equal responses to
  the port's batch apply of their rows and JAX's apply of the same state;
  hostile payloads get JAX's error codes; after the warm-up no hand kernel
  launches and no allocator segment appears (the port's counterpart of
  the zero-compile test);
* the slice as a whole: a bundle JAX exported, loaded, warmed and served
  by the port, against JAX's ``ApplyProgram.apply_frame``;
* the serve-fault scenario with every gate, a timeout burning error
  budget, ``ANOVOS_SERVE_BF16`` refused, the serving knobs outside the node
  cache's key, and the CLI's ``export`` and ``smoke`` in-process.

Bands (those of ``tests/test_torch_state.py``): exact, except boxcox within
2e-6 relative and sqrt within 2.4e-7 relative; the z scaler's moments,
fitted in f32 by each package, within 1e-6 of the column's scale.

Every test leaves the process as it found it: no thread, no flight
recorder arming, no telemetry provider or listener, no chaos plan.  Knobs
are set with ``monkeypatch`` only; counters are read as deltas.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_no_thread_left, free_port, thread_names, torch_cpu_runtime  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# columns whose served values follow the power transforms' bands
BOXCOX_RTOL = 2e-6
SQRT_RTOL = 2.4e-7
SERVING_KNOBS = ("ANOVOS_SERVE_BATCH_WINDOW_MS", "ANOVOS_SERVE_MAX_BATCH", "ANOVOS_SERVE_BF16")


def _process_state():
    from anovos_tpu_torch.obs import flight, telemetry
    from anovos_tpu_torch.resilience import chaos

    return {"flight": (flight.enabled(), flight.destination()), "providers": sorted(telemetry._providers()),
            "listener": telemetry.current(), "chaos": chaos.plan()}


@pytest.fixture(autouse=True)
def _leaves_the_process_as_it_found_it(monkeypatch):
    """Each test starts with the knobs unset, the flight recorder disarmed
    and a healthy live plane (no degraded section, quarantined part or
    heartbeat that an earlier test file in the same worker left: a runner's
    run leaves its recorder armed and its sections in the registry), and
    must leave no thread, recorder arming, provider, listener or chaos plan
    behind."""
    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.obs import flight, telemetry
    from anovos_tpu_torch.resilience.policy import reset_degraded

    for knob in SERVING_KNOBS + ("ANOVOS_TPU_TELEMETRY", "ANOVOS_TPU_TRACE_ROTATE", "ANOVOS_TPU_CHAOS",
                                 "ANOVOS_TPU_FLIGHTREC", "ANOVOS_TPU_DEVPROF"):
        monkeypatch.delenv(knob, raising=False)
    flight.reset()
    reset_degraded()
    guard.reset()
    telemetry.clear_heartbeat()
    before, threads = _process_state(), thread_names()
    yield
    assert_no_thread_left(threads)
    assert _process_state() == before


@pytest.fixture(scope="module")
def fit_df():
    from anovos_tpu_torch.serving.demo import demo_frame
    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime("cpu")  # the module's fixtures fit before the first test's runtime fixture
    return demo_frame(600, seed=7)


@pytest.fixture(scope="module")
def tables(fit_df):
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    return JTable.from_pandas(fit_df), Table.from_pandas(fit_df, device="cpu")


def _frames_equal(a: pd.DataFrame, b: pd.DataFrame) -> bool:
    if list(a.columns) != list(b.columns) or len(a) != len(b):
        return False
    for c in a.columns:
        na_a, na_b = a[c].isna(), b[c].isna()
        if not (na_a == na_b).all() or not (a[c][~na_a].values == b[c][~na_b].values).all():
            return False
    return True


def _assert_frames_in_bands(got: pd.DataFrame, exp: pd.DataFrame, rtol: dict):
    """Same columns, rows and nulls; values equal but for ``rtol``'s
    columns, within their relative band."""
    assert list(got.columns) == list(exp.columns) and len(got) == len(exp)
    for c in exp.columns:
        na_g, na_e = got[c].isna().to_numpy(), exp[c].isna().to_numpy()
        assert (na_g == na_e).all(), c
        g, e = got[c].to_numpy()[~na_g], exp[c].to_numpy()[~na_e]
        if c in rtol:
            np.testing.assert_allclose(g.astype(np.float64), e.astype(np.float64), rtol=rtol[c], atol=0,
                                       err_msg=c)
        else:
            assert (g == e).all(), c


def _assert_payloads_in_bands(got: dict, exp: dict, rtol: dict):
    assert list(got) == list(exp)
    for c, e in exp.items():
        g = got[c]
        assert len(g) == len(e) and [v is None for v in g] == [v is None for v in e], c
        if c in rtol:
            np.testing.assert_allclose([v for v in g if v is not None], [v for v in e if v is not None],
                                       rtol=rtol[c], atol=0, err_msg=c)
        else:
            assert g == e, c


def _demo_bands(bundle) -> dict:
    """The bands of the demo chain's output columns: boxcox's (and sqrt's,
    where a stage takes one) columns."""
    out = {}
    for s in bundle.chain:
        append = s["apply_config"].get("output_mode") == "append"
        if s["family"] == "boxcox_transformation":
            out.update({(c + "_boxcox" if append else c): BOXCOX_RTOL for c in s["cols"]})
        elif s["family"] == "feature_transformation" and s["apply_config"].get("method_type") == "sqrt":
            out.update({(c + "_sqrt" if append else c): SQRT_RTOL for c in s["cols"]})
    return out


# ---------------------------------------------------------------------------
# fitted_state / from_state round trip, per family
# ---------------------------------------------------------------------------
FAMILY_CASES = [
    ("attribute_binning", {"list_of_cols": ["age", "hours"], "bin_size": 6}),
    ("attribute_binning", {"list_of_cols": ["age"], "method_type": "equal_frequency", "bin_size": 4,
                           "bin_dtype": "categorical", "output_mode": "append"}),
    ("z_standardization", {"list_of_cols": ["age", "fnlwgt"]}),
    ("IQR_standardization", {"list_of_cols": ["hours"]}),
    ("normalization", {"list_of_cols": ["fnlwgt", "hours"], "output_mode": "append"}),
    ("imputation_MMM", {"list_of_cols": ["age", "workclass"], "method_type": "median"}),
    ("cat_to_num_unsupervised", {"list_of_cols": ["workclass", "education"], "method_type": "label_encoding"}),
    ("cat_to_num_supervised", {"list_of_cols": ["workclass"], "label_col": "label", "event_label": "1",
                               "output_mode": "append"}),
    ("outlier_categories", {"list_of_cols": ["education"], "coverage": 0.8, "max_category": 4}),
    ("boxcox_transformation", {"list_of_cols": ["hours"]}),
    ("feature_transformation", {"list_of_cols": ["hours"], "method_type": "sqrt", "output_mode": "append"}),
]


@pytest.mark.parametrize("family,cfg", FAMILY_CASES, ids=[f"{f}-{i}" for i, (f, _) in enumerate(FAMILY_CASES)])
def test_family_roundtrip_byte_parity(tables, tmp_path, family, cfg):
    """The port's batch fit + apply ≡ its fitted_state → JSON → from_state →
    apply, byte for byte; and the port's apply of that state equals the JAX
    package's apply of it within the family's band."""
    from anovos_tpu.data_transformer import transformers as jtr
    from anovos_tpu_torch.data_transformer import transformers as ptr

    jt, pt = tables
    kwargs = dict(cfg)
    if ptr._STATE_MODEL_FMT.get(family):
        kwargs["model_path"] = str(tmp_path / "m")
    batch = getattr(ptr, family)(pt, **kwargs).to_pandas()
    state = json.loads(json.dumps(ptr.fitted_state(pt, family, cfg)))
    served = ptr.from_state(state).apply(pt).to_pandas()
    assert _frames_equal(batch, served), family
    band = {"boxcox_transformation": BOXCOX_RTOL, "feature_transformation": SQRT_RTOL}.get(family)
    rtol = {c: band for c in served.columns if band and pd.api.types.is_float_dtype(served[c])}
    _assert_frames_in_bands(served, jtr.from_state(state).apply(jt).to_pandas(), rtol)


def test_fitted_state_rejects_unknown_family(tables):
    from anovos_tpu.data_transformer import transformers as jtr
    from anovos_tpu_torch.data_transformer import transformers as ptr

    for T, t in zip((jtr, ptr), tables):
        with pytest.raises(ValueError, match="not a servable"):
            T.fitted_state(t, "expression_parser", {})


def test_from_state_rejects_version_mismatch(tables):
    from anovos_tpu.data_transformer import transformers as jtr
    from anovos_tpu_torch.data_transformer import transformers as ptr

    for T, t in zip((jtr, ptr), tables):
        state = T.fitted_state(t, "z_standardization", {"list_of_cols": ["age"]})
        state["state_version"] = 99
        with pytest.raises(ValueError, match="version"):
            T.from_state(state)


def test_supervised_apply_needs_no_label_column(tables):
    """The pre-existing-model path needs no label column (requests carry
    features, never labels), in either package, with equal results."""
    from anovos_tpu.data_transformer import transformers as jtr
    from anovos_tpu_torch.data_transformer import transformers as ptr

    jt, pt = tables
    cfg = {"list_of_cols": ["workclass"], "label_col": "label", "event_label": "1"}
    state = json.loads(json.dumps(ptr.fitted_state(pt, "cat_to_num_supervised", cfg)))
    out = ptr.from_state(state).apply(pt.drop(["label"]))
    assert "workclass" in out.col_names and "label" not in out.col_names
    _assert_frames_in_bands(out.to_pandas(), jtr.from_state(state).apply(jt.drop(["label"])).to_pandas(), {})


# ---------------------------------------------------------------------------
# bundles: documents, the CAS round trip, refusals
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bundle_store(tables, tmp_path_factory):
    from anovos_tpu_torch.serving import fit_bundle, save_bundle
    from anovos_tpu_torch.serving.demo import DEMO_CHAIN

    cache = str(tmp_path_factory.mktemp("bundle_cas"))
    bundle = fit_bundle(tables[1], DEMO_CHAIN, source="test")
    return cache, save_bundle(bundle, cache), bundle


def test_fit_bundle_document_matches_jax(tables, bundle_store):
    """The port's document has JAX's keys and format, JAX's schema, and
    JAX's chain: equal states but for the z scaler's f32 moments (within
    1e-6 of the column's scale); only the row-bucket entry is the port's."""
    from anovos_tpu.serving import BUNDLE_FORMAT_VERSION as JFORMAT
    from anovos_tpu.serving import fit_bundle as jfit
    from anovos_tpu.serving.demo import DEMO_CHAIN as JCHAIN
    from anovos_tpu.serving.demo import demo_frame as jdemo
    from anovos_tpu_torch.serving import BUNDLE_FORMAT_VERSION
    from anovos_tpu_torch.serving.demo import DEMO_CHAIN, demo_frame

    assert DEMO_CHAIN == JCHAIN and BUNDLE_FORMAT_VERSION == JFORMAT == 1
    assert demo_frame(600, 7).equals(jdemo(600, 7))
    got = bundle_store[2].doc
    exp = jfit(tables[0], JCHAIN, source="test").doc
    assert sorted(got) == sorted(exp)
    assert got["schema"] == exp["schema"]
    assert [k for k in got if got[k] != exp[k]] == ["created_unix", "chain", "shape_buckets"]
    assert got["shape_buckets"]["enabled"] is True and "8 * 2^k" in got["shape_buckets"]["scheme"]
    scale = float(np.nanmax(np.abs(demo_frame(600, 7)["age"])))
    for g, e in zip(got["chain"], exp["chain"]):
        if g["family"] != "z_standardization":
            assert g == e, g["family"]
            continue
        gt, et = g["model"]["tables"]["z_standardization"], e["model"]["tables"]["z_standardization"]
        assert {k: v for k, v in g.items() if k != "model"} == {k: v for k, v in e.items() if k != "model"}
        assert gt["attribute"] == et["attribute"]
        np.testing.assert_allclose(gt["mean"] + gt["stddev"], et["mean"] + et["stddev"], rtol=0,
                                   atol=1e-6 * scale)


def test_bundle_save_load_roundtrip(bundle_store):
    from anovos_tpu_torch.serving import list_bundles, load_bundle
    from anovos_tpu_torch.serving.demo import DEMO_CHAIN

    cache, version, bundle = bundle_store
    loaded = load_bundle(cache, version)
    assert loaded.version == version and loaded.doc == bundle.doc
    assert [s["family"] for s in loaded.chain] == [n for n, _ in DEMO_CHAIN]
    # the label is fit-time material, never a required request column
    assert "label" not in loaded.input_names
    assert [b["version"] for b in list_bundles(cache)] == [version]


def test_bundle_save_is_idempotent(bundle_store, tables):
    from anovos_tpu_torch.serving import fit_bundle, save_bundle
    from anovos_tpu_torch.serving.demo import DEMO_CHAIN

    cache, version, _ = bundle_store
    assert save_bundle(fit_bundle(tables[1], DEMO_CHAIN, source="test"), cache) == version


def test_bundle_missing_version_refused(bundle_store):
    from anovos_tpu.serving import BundleVersionError as JError
    from anovos_tpu.serving import load_bundle as jload
    from anovos_tpu_torch.serving import BundleVersionError, load_bundle

    cache, _, _ = bundle_store
    for load, err in ((load_bundle, BundleVersionError), (jload, JError)):
        with pytest.raises(err, match="not found"):
            load(cache, "0" * 64)


def test_bundle_format_version_mismatch_refused(tables, tmp_path):
    """A format-999 document, exported by either package, is refused by the
    port's load_bundle."""
    import anovos_tpu.serving.bundle as JB
    import anovos_tpu_torch.serving.bundle as B

    for pkg, t in ((B, tables[1]), (JB, tables[0])):
        cache = str(tmp_path / pkg.__name__)
        bundle = pkg.fit_bundle(t, [("z_standardization", {"list_of_cols": ["age"]})])
        bundle.doc["bundle_format"] = 999
        bundle.version = pkg._digest(bundle.doc)  # re-address the altered doc
        version = pkg.save_bundle(bundle, cache)
        with pytest.raises(B.BundleVersionError, match="format version"):
            B.load_bundle(cache, version)


def test_bundle_tampered_payload_refused(tables, tmp_path):
    import anovos_tpu_torch.serving.bundle as B
    from anovos_tpu_torch.cache.store import CacheStore

    cache = str(tmp_path / "cas")
    version = B.save_bundle(B.fit_bundle(tables[1], [("z_standardization", {"list_of_cols": ["age"]})]), cache)
    path = os.path.join(CacheStore(cache).payload_dir(B._NODE_PREFIX + version), B._DOC_NAME)
    with open(path) as f:
        doc = json.load(f)
    doc["chain"][0]["apply_config"]["output_mode"] = "append"
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(B.BundleVersionError, match="digest mismatch"):
        B.load_bundle(cache, version)


def test_row_buckets_and_padding_match_jax(fit_df):
    """The same buckets as JAX's program; padding by cycling keeps every
    live row first and unchanged."""
    from anovos_tpu.serving import ApplyProgram as JProgram
    from anovos_tpu_torch.serving import ApplyProgram

    for max_rows in (1, 8, 9, 64, 100, 256):
        assert ApplyProgram.row_buckets(max_rows) == JProgram.row_buckets(max_rows)
        for n in (1, 7, 8, 9, 33, max_rows):
            assert ApplyProgram.bucket_rows(n, max_rows) == JProgram.bucket_rows(n, max_rows)
    live = fit_df.iloc[:5].reset_index(drop=True)
    padded = ApplyProgram.pad_frame(live, 16)
    assert len(padded) == 16 and padded.iloc[:5].equals(live)
    assert padded.iloc[5:10].reset_index(drop=True).equals(live)
    assert ApplyProgram.pad_frame(live, 3) is live


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def warmed(bundle_store):
    from anovos_tpu_torch.serving import ApplyProgram, load_bundle

    cache, version, _ = bundle_store
    program = ApplyProgram(load_bundle(cache, version))
    program.warm(64)
    return program


def _payload(src: pd.DataFrame, start: int, width: int) -> dict:
    from anovos_tpu_torch.serving import frame_to_payload

    return {"columns": frame_to_payload(src.iloc[start:start + width])}


def _jax_program(bundle):
    """The JAX package's apply program over the same bundle document."""
    import anovos_tpu.serving as J

    return J.ApplyProgram(J.FeatureBundle(doc=bundle.doc, version=bundle.version))


def test_server_concurrent_mixed_width_parity(warmed, fit_df, tmp_path):
    """Four clients, 24 requests of widths 1, 3, 8 and 17 through 64-row
    micro-batches: every response is byte-equal to the port's batch apply of
    its rows, and equal (in the bands) to JAX's apply of them."""
    from anovos_tpu_torch.obs import get_metrics
    from anovos_tpu_torch.serving import FeatureServer, coerce_payload, frame_to_payload

    src = fit_df[warmed.bundle.input_names]
    batches0 = get_metrics().counter("serve_batches_total").value()
    server = FeatureServer(warmed, window_ms=20, max_batch=64, obs_dir=str(tmp_path))
    server.start(warm=False)
    try:
        widths = (1, 3, 8, 17)
        payloads = [_payload(src, (i * 19) % 400, widths[i % len(widths)]) for i in range(24)]
        results: list = [None] * len(payloads)

        def client(cid):
            for r in range(6):
                results[cid * 6 + r] = server.serve(payloads[cid * 6 + r])

        threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = server.stats()
    finally:
        server.close()
    jprog = _jax_program(warmed.bundle)
    import anovos_tpu.serving as J

    for i, (p, resp) in enumerate(zip(payloads, results)):
        assert resp is not None and "error" not in resp, (i, resp)
        frame, err = coerce_payload(warmed.input_columns, p, 64)
        assert err is None
        assert resp["columns"] == frame_to_payload(warmed.apply_frame(frame)), f"request {i}"
        jframe, jerr = J.coerce_payload(jprog.input_columns, p, 64)
        assert jerr is None
        _assert_payloads_in_bands(resp["columns"], frame_to_payload(jprog.apply_frame(jframe)),
                                  _demo_bands(warmed.bundle))
    assert stats["served"] == len(payloads) and stats["p50_ms"] is not None and stats["p99_ms"] is not None
    # the requests went through fewer micro-batches than requests
    assert 1 <= get_metrics().counter("serve_batches_total").value() - batches0 <= len(payloads)


def test_server_refuses_hostile_payloads_and_survives(warmed, fit_df, tmp_path):
    """The nine hostile payloads of tests/test_serving.py get the JAX
    package's error codes, the server goes on serving correctly, and the
    quarantine counter moves by reason."""
    import anovos_tpu.serving as J
    from anovos_tpu_torch.obs import get_metrics
    from anovos_tpu_torch.serving import FeatureServer, coerce_payload, frame_to_payload

    src = fit_df[warmed.bundle.input_names]
    ok_payload = _payload(src, 0, 2)
    quarantine = get_metrics().counter("serve_requests_quarantined_total")
    before = {r: quarantine.value(reason=r) for r in ("hostile_values", "schema_drift")}
    server = FeatureServer(warmed, window_ms=5, max_batch=64, obs_dir=str(tmp_path))
    server.start(warm=False)
    try:
        cols = ok_payload["columns"]
        hostile = {
            "hostile_values": {"columns": {**cols, "age": [float("inf"), 1.0]}},
            "hostile_values ": {"columns": {**cols, "age": [1e39, None]}},
            "schema_drift": {"columns": {**cols, "bogus": [1.0, 2.0]}},
            "schema_drift ": {"columns": {k: v for k, v in cols.items() if k != "age"}},
            "wrong_dtype": {"columns": {**cols, "age": ["nope", 1.0]}},
            "wrong_dtype ": {"columns": {**cols, "workclass": [1.0, 2.0]}},
            "bad_shape": {"columns": {**cols, "age": [1.0]}},
            "bad_shape ": {"columns": frame_to_payload(pd.concat([src.iloc[:60]] * 2, ignore_index=True))},
            "bad_request": {"rows": [1, 2]},
        }
        for expect_code, payload in hostile.items():
            resp = server.serve(payload)
            assert "error" in resp and resp["error"]["code"] == expect_code.strip(), (expect_code, resp)
            _, jerr = J.coerce_payload(warmed.input_columns, payload, 64)
            assert jerr == resp, expect_code
        resp = server.serve(ok_payload)
        assert "error" not in resp
        frame, _ = coerce_payload(warmed.input_columns, ok_payload, 64)
        assert resp["columns"] == frame_to_payload(warmed.apply_frame(frame))
        assert server.stats()["quarantined"] == len(hostile)
    finally:
        server.close()
    for reason in ("hostile_values", "schema_drift"):
        assert quarantine.value(reason=reason) - before[reason] == 2


def _count_plain_launches(monkeypatch):
    """Count each plain kernel version's calls as a launch, as the kernels
    count theirs on the card."""
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.kernels import histogram, moments, neighbor_counts

    for mod, attr, name in ((moments, "masked_moments_plain", "masked_moments"),
                            (histogram, "binned_histograms_plain", "binned_histograms"),
                            (neighbor_counts, "neighbor_counts_plain", "neighbor_counts")):
        def counted(*a, plain=getattr(mod, attr), name=name):
            kernels.count_launch(name)
            return plain(*a)

        monkeypatch.setattr(mod, attr, counted)


def test_no_launch_after_warm(monkeypatch, bundle_store, fit_df, tmp_path):
    """The port's counterpart of JAX's zero-compile contract: a fit launches
    B1 (the counting works), the warm-up records what each bucket launched,
    and after it requests at every bucket launch no hand kernel and add no
    allocator segment."""
    from anovos_tpu_torch.serving import ApplyProgram, FeatureServer, fit_bundle, load_bundle
    from anovos_tpu_torch.serving.demo import DEMO_CHAIN
    from anovos_tpu_torch.shared.table import Table

    _count_plain_launches(monkeypatch)
    l0, _ = ApplyProgram.device_counters()
    fit_bundle(Table.from_pandas(fit_df.iloc[:200], device="cpu"), DEMO_CHAIN)
    assert ApplyProgram.device_counters()[0] > l0
    cache, version, _ = bundle_store
    program = ApplyProgram(load_bundle(cache, version))
    src = fit_df[program.bundle.input_names]
    server = FeatureServer(program, window_ms=2, max_batch=64, obs_dir=str(tmp_path))
    server.start(warm=True)
    try:
        stats = program.warm_stats
        assert stats["buckets"] == [8, 16, 32, 64]
        assert set(stats["launches_per_bucket"]) == set(stats["segments_per_bucket"]) == {"8", "16", "32", "64"}
        assert all(v >= 0 for v in stats["wall_s_per_bucket"].values())
        mark = ApplyProgram.device_counters()
        for start, width in ((0, 1), (7, 9), (40, 17), (100, 33), (200, 64)):
            assert "error" not in server.serve(_payload(src, start, width))
        assert ApplyProgram.device_counters() == mark
    finally:
        server.close()


def test_full_coverage_bundle_parity(tables, fit_df, tmp_path):
    """The whole demo chain: the port's batch run of it equals, byte for
    byte, a fresh ApplyProgram over the bundle read back from the store (no
    fit-time state), and JAX's ApplyProgram over the same document gives the
    same frame within the bands."""
    from anovos_tpu_torch.data_transformer import transformers as T
    from anovos_tpu_torch.serving import ApplyProgram, fit_bundle, load_bundle, save_bundle
    from anovos_tpu_torch.serving.demo import DEMO_CHAIN, demo_frame
    from anovos_tpu_torch.shared.table import Table

    df = demo_frame(500, seed=7)
    t = Table.from_pandas(df, device="cpu")
    batch = t
    for name, cfg in DEMO_CHAIN:
        batch = getattr(T, name)(batch, **cfg, **({"model_path": str(tmp_path / name)}
                                                  if T._STATE_MODEL_FMT.get(name) else {}))
    batch = batch.to_pandas()
    cache = str(tmp_path / "cas")
    version = save_bundle(fit_bundle(t, DEMO_CHAIN), cache)
    program = ApplyProgram(load_bundle(cache, version))
    served = program.apply_table(Table.from_pandas(df, device="cpu")).to_pandas()
    assert _frames_equal(batch, served)
    from anovos_tpu.shared.table import Table as JTable

    jserved = _jax_program(program.bundle).apply_table(JTable.from_pandas(df)).to_pandas()
    _assert_frames_in_bands(served, jserved, _demo_bands(program.bundle))


def test_jax_exported_bundle_served_by_the_port(tables, fit_df, tmp_path):
    """The slice as a whole: a bundle the JAX package fitted and exported,
    loaded by the port's load_bundle, warmed and served by its FeatureServer
    to mixed-width requests, against JAX's apply_frame of the same rows."""
    import anovos_tpu.serving as J
    from anovos_tpu.serving.demo import DEMO_CHAIN
    from anovos_tpu_torch.serving import ApplyProgram, FeatureServer, frame_to_payload, load_bundle

    cache = str(tmp_path / "cas")
    version = J.save_bundle(J.fit_bundle(tables[0], DEMO_CHAIN, source="jax"), cache)
    bundle = load_bundle(cache, version)
    jprog = J.ApplyProgram(J.load_bundle(cache, version))
    server = FeatureServer(ApplyProgram(bundle), window_ms=10, max_batch=32, obs_dir=str(tmp_path / "obs"))
    server.start(warm=True)
    try:
        src = fit_df[bundle.input_names]
        widths = (1, 3, 8, 17, 32)
        payloads = [_payload(src, 37 * i, widths[i % 5]) for i in range(10)]
        results: list = [None] * len(payloads)

        def client(cid):
            for i in range(cid, len(payloads), 2):
                results[i] = server.serve(payloads[i])

        threads = [threading.Thread(target=client, args=(c,)) for c in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        server.close()
    for i, (p, resp) in enumerate(zip(payloads, results)):
        assert resp is not None and "error" not in resp, (i, resp)
        frame, err = J.coerce_payload(jprog.input_columns, p, 32)
        assert err is None
        _assert_payloads_in_bands(resp["columns"], frame_to_payload(jprog.apply_frame(frame)), _demo_bands(bundle))


def test_close_restores_what_start_set_up(warmed, tmp_path, monkeypatch):
    """start() arms the flight recorder (when nothing had), joins the live
    plane, registers the serving provider and starts the batcher thread
    (never JAX's name); close() undoes each, and puts back a provider that
    was registered before.  A start that fails undoes what it set up."""
    from anovos_tpu_torch.obs import flight, telemetry
    from anovos_tpu_torch.serving import FeatureServer
    from anovos_tpu_torch.serving.server import BATCHER_THREAD

    earlier = {"health": lambda: ("ok", [])}
    telemetry.register_provider("serving", **earlier)
    monkeypatch.setenv("ANOVOS_TPU_TELEMETRY", str(free_port()))
    try:
        server = FeatureServer(warmed, window_ms=2, max_batch=64, obs_dir=str(tmp_path))
        server.start(warm=False)
        try:
            assert flight.enabled() and flight.destination() == str(tmp_path / "obs")
            assert telemetry.current() is not None
            assert telemetry._providers()["serving"]["statusz"] == server._statusz_fragment
            names = thread_names()
            assert BATCHER_THREAD in names and "anovos-serve-batcher" not in names
        finally:
            server.close()
            server.close()
        assert not flight.enabled() and telemetry.current() is None
        assert telemetry._providers()["serving"] == earlier
        assert BATCHER_THREAD not in thread_names()

        class Broken:
            input_columns = warmed.input_columns

            def warm(self, max_rows):
                raise RuntimeError("warm-up failed")

        with pytest.raises(RuntimeError, match="warm-up failed"):
            FeatureServer(Broken(), max_batch=8, obs_dir=str(tmp_path / "b")).start(warm=True)
        assert not flight.enabled() and telemetry.current() is None
        assert telemetry._providers()["serving"] == earlier
    finally:
        telemetry.unregister_provider("serving")


def test_jax_start_leaves_its_flight_recorder_armed(warmed, tmp_path):
    """The JAX server's start() arms the flight recorder for the whole
    process and its close() leaves it armed (anovos_tpu/serving/server.py
    :238-242); the port's close() disarms what its start() armed."""
    import anovos_tpu.serving as J
    from anovos_tpu.obs import flight as jflight
    from anovos_tpu_torch.obs import flight
    from anovos_tpu_torch.serving import FeatureServer

    jflight.reset()  # a JAX runner's run in this worker leaves it armed
    assert not flight.enabled()
    try:
        jserver = J.FeatureServer(_jax_program(warmed.bundle), window_ms=2, max_batch=8,
                                  obs_dir=str(tmp_path / "jax"))
        jserver.start(warm=False)
        jserver.close()
        assert jflight.enabled()
    finally:
        jflight.reset()
    server = FeatureServer(warmed, window_ms=2, max_batch=8, obs_dir=str(tmp_path / "port"))
    server.start(warm=False)
    assert flight.enabled()
    server.close()
    assert not flight.enabled()


def test_frame_to_payload_takes_the_string_dtype():
    """pandas' string dtype (text's default from pandas 3 on) serializes as
    the JAX package serializes an object column; JAX's frame_to_payload
    raises on it (np.issubdtype of an extension dtype)."""
    import anovos_tpu.serving as J
    from anovos_tpu_torch.serving import frame_to_payload

    df = pd.DataFrame({"s": pd.array(["a", None, "b"], dtype=pd.StringDtype()), "x": [1.0, np.nan, 2.5],
                       "i": np.array([1, 2, 3], np.int32),
                       "t": pd.to_datetime(pd.Series(["2020-01-01 00:00:00", None, "2021-02-03 04:05:06"]))})
    as_object = df.copy()
    as_object["s"] = pd.Series(["a", None, "b"], dtype=object)
    assert as_object["s"].dtype == object
    got = frame_to_payload(df)
    assert got == J.frame_to_payload(as_object) == frame_to_payload(as_object)
    assert got["s"] == ["a", None, "b"] and got["x"] == [1.0, None, 2.5] and got["i"] == [1, 2, 3]
    assert got["t"] == ["2020-01-01T00:00:00", None, "2021-02-03T04:05:06"]
    with pytest.raises(TypeError):
        J.frame_to_payload(df)


def test_serve_timeout_burns_error_budget():
    """tests/test_telemetry.py:559 on the port: a request that times out
    awaiting its batch is a client-visible failure in the rolling windows,
    the timeout counter and the latency tail."""
    import queue as _q
    from collections import deque

    from anovos_tpu_torch.obs import get_metrics, telemetry
    from anovos_tpu_torch.serving import FeatureServer

    class _FakeProgram:
        input_columns = [{"name": "a", "kind": "num"}]

    server = FeatureServer.__new__(FeatureServer)
    server.program = _FakeProgram()
    server.max_batch = 8
    server._queue = _q.Queue()
    server._lock = threading.Lock()
    server._quarantined = 0
    server._latencies = deque(maxlen=128)
    server.rolling = telemetry.RollingWindow(windows=(60.0,), budget=0.01)
    timeouts0 = get_metrics().counter("serve_requests_timeout_total").value()
    # no batcher thread running: the request times out
    resp = server.serve({"columns": {"a": [1.0]}}, timeout_s=0.05)
    assert resp["error"]["code"] == "timeout"
    s = server.rolling.summary()["60s"]
    assert s["count"] == 1 and s["errors"] == 1 and s["error_budget_burn"] > 0
    assert get_metrics().counter("serve_requests_timeout_total").value() - timeouts0 == 1
    assert len(server._latencies) == 1 and server._latencies[0] >= 0.05


def test_serve_bf16_knob_raises(bundle_store, monkeypatch):
    from anovos_tpu_torch.serving import ApplyProgram, load_bundle

    cache, version, _ = bundle_store
    monkeypatch.setenv("ANOVOS_SERVE_BF16", "1")
    with pytest.raises(NotImplementedError, match="ANOVOS_SERVE_BF16"):
        ApplyProgram(load_bundle(cache, version))
    assert os.environ.get("ANOVOS_TPU_BF16") is None


def test_serving_knobs_stay_out_of_the_cache_key(monkeypatch):
    """Serving never runs as a scheduler node: its knobs are on neither
    knob list and leave env_fingerprint unchanged, as in JAX."""
    from anovos_tpu.cache.fingerprint import KNOWN_ENV_KNOBS as JKNOWN
    from anovos_tpu_torch.cache.fingerprint import EXEMPT_ENV_KNOBS, KNOWN_ENV_KNOBS, env_fingerprint
    from anovos_tpu_torch.obs.telemetry import UNPORTED_KNOBS

    before = env_fingerprint()
    for knob, value in zip(SERVING_KNOBS, ("50", "32", "0")):
        assert knob not in KNOWN_ENV_KNOBS and knob not in EXEMPT_ENV_KNOBS and knob not in JKNOWN
        assert knob not in UNPORTED_KNOBS
        monkeypatch.setenv(knob, value)
    assert env_fingerprint() == before


def test_serving_knobs_set_the_batcher(warmed, monkeypatch):
    from anovos_tpu_torch.serving import FeatureServer

    monkeypatch.setenv("ANOVOS_SERVE_BATCH_WINDOW_MS", "12.5")
    monkeypatch.setenv("ANOVOS_SERVE_MAX_BATCH", "32")
    server = FeatureServer(warmed)
    assert server.window_s == 0.0125 and server.max_batch == 32
    assert FeatureServer(warmed, window_ms=3, max_batch=16).max_batch == 16


# ---------------------------------------------------------------------------
# the serve-fault scenario and the CLI
# ---------------------------------------------------------------------------
def test_serve_fault_scenario(tmp_path):
    """The port's copy of tools/chaos_run.py's serve-fault scenario, on the
    JAX scenario's plan, passes every gate in-process."""
    from anovos_tpu_torch.serving.demo import SERVE_FAULT_SPEC, run_serve_fault
    from tools.chaos_run import SCENARIOS

    assert SERVE_FAULT_SPEC == SCENARIOS["serve-fault"]
    rec = run_serve_fault(str(tmp_path), rows=400)
    assert rec["ok"], rec
    assert all(rec["gates"].values()) and len(rec["gates"]) == 9
    assert rec["parity"] and rec["clean_flightrec"] == 0 and rec["injections"] == 3
    assert [d["trigger"] for d in rec["flightrec"]] == ["serve_fatal"]
    assert rec["clean_healthz"] == "ok" and rec["chaos_healthz"] == "degraded"
    assert rec["quarantined"] == 4 and rec["served_after_fatal"] >= 12
    with open(tmp_path / "chaos" / "obs" / rec["flightrec"][0]["file"]) as f:
        dump = json.load(f)
    assert dump["node"] == "serving/apply" and dump["extra"]["requests"] == 1
    assert dump["extra"]["batch_rows"] == 17 and "ChaosError" in dump["extra"]["error"]


def test_serve_fault_needs_a_healthy_process(tmp_path):
    """A degraded section left in the process fails the scenario before it
    starts, naming it, instead of failing its clean leg's /healthz gate."""
    from anovos_tpu_torch.resilience.policy import record_degraded, reset_degraded
    from anovos_tpu_torch.serving.demo import run_serve_fault

    record_degraded("stats_generator/global_summary", "an earlier run's failure")
    try:
        with pytest.raises(RuntimeError, match="degraded section stats_generator/global_summary"):
            run_serve_fault(str(tmp_path), rows=200)
    finally:
        reset_degraded()
    assert not os.listdir(tmp_path)


def test_export_cli_in_process(tmp_path, capsys):
    """``python -m anovos_tpu_torch.serving export`` on a parquet dataset
    and a YAML chain: the bundle it commits is the one fit_bundle gives."""
    import yaml

    from anovos_tpu_torch.serving import fit_bundle, list_bundles, load_bundle
    from anovos_tpu_torch.serving.__main__ import main
    from anovos_tpu_torch.serving.demo import DEMO_CHAIN, demo_frame
    from anovos_tpu_torch.shared.table import Table

    data = tmp_path / "data"
    data.mkdir()
    df = demo_frame(300, seed=3)
    df.to_parquet(data / "part-00000.parquet", index=False)
    chain = tmp_path / "chain.yaml"
    chain.write_text(yaml.safe_dump([{"name": n, "config": c} for n, c in DEMO_CHAIN[:4]]))
    assert main(["export", "--data", str(data), "--chain", str(chain), "--cache", str(tmp_path / "cas")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["stages"] == [n for n, _ in DEMO_CHAIN[:4]]
    assert out["input_columns"] == ["age", "fnlwgt", "workclass", "education"]
    bundle = load_bundle(str(tmp_path / "cas"), out["bundle_version"])
    assert bundle.doc["source"] == str(data)
    assert [b["version"] for b in list_bundles(str(tmp_path / "cas"))] == [out["bundle_version"]]
    direct = fit_bundle(Table.from_pandas(pd.read_parquet(data), device="cpu"), DEMO_CHAIN[:4])
    assert direct.doc["chain"] == bundle.doc["chain"] and direct.doc["schema"] == bundle.doc["schema"]


def test_smoke_cli_in_process(tmp_path, capsys):
    """``smoke --telemetry`` in-process on the CPU runtime: the serve
    figures, byte parity, no error, the warm record, the overhead legs."""
    from anovos_tpu_torch.serving.__main__ import main

    rc = main(["smoke", "--rows", "300", "--clients", "2", "--requests", "5", "--workdir", str(tmp_path),
               "--telemetry"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, out
    for key in ("serve_qps", "serve_p50_ms", "serve_p99_ms", "serve_cold_start_s"):
        assert out[key] is not None and out[key] > 0, key
    assert out["serve_parity_ok"] and out["serve_errors"] == 0 and out["serve_requests"] == 10
    assert out["backend"] == "cpu" and out["serve_warm"]["buckets"] == [8, 16, 32, 64, 128, 256]
    assert out["telemetry_baseline"] == "off" and out["healthz_status"] == "ok"
    assert out["scrape_failures"] == 0 and out["scrape_count"] > 0
    assert out["serve_errors_baseline_leg"] == out["serve_errors_with_telemetry"] == 0


def test_cli_without_a_card_exits_at_init_runtime(tmp_path):
    """The entry point runs on the card: in a process with no runtime set
    and no CUDA it stops at init_runtime, never serving on the CPU."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("ANOVOS_")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "-m", "anovos_tpu_torch.serving", "smoke", "--rows", "100",
                        "--workdir", str(tmp_path)], capture_output=True, text=True, env=env, timeout=300,
                       cwd=REPO)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device requested but torch.cuda.is_available() is False" in p.stderr
