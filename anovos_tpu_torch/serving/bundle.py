"""Versioned feature bundles: fitted transformer state in the CAS store
(counterpart of ``anovos_tpu/serving/bundle.py``).

A bundle is ONE JSON document holding everything an apply-only server
needs: the ordered chain of ``fitted_state`` docs (one per transformer:
binning edges, scaler params, boxcox λs, encoder maps, imputer fills),
the input schema (which request columns are required, their kinds and
dtypes, a vocab sample for warm-up synthesis), and the row-bucket policy
the server pads micro-batches onto.

Versioning is content addressing: the bundle version is the sha256 of
the document's canonical JSON (sorted keys, no whitespace), so two
exports of identical fitted state dedupe to one version and a tampered
payload can never load under its old version.  Storage rides the node
cache's :class:`~anovos_tpu_torch.cache.store.CacheStore`: the document
lands in the store's payload dir under a ``bundle-<version>`` node
manifest, committed with the store's tmp+rename ordering and swept by the
same LRU ``gc``.  The document layout, the digest and the store layout
are the JAX package's, so either package loads the other's bundles.

``BUNDLE_FORMAT_VERSION`` is the FORMAT contract: :func:`load_bundle`
refuses a document whose format version it does not speak
(:class:`BundleVersionError`), so a new server never misreads an old
bundle silently, and vice versa.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

from anovos_tpu_torch.cache.store import CacheStore

__all__ = [
    "BUNDLE_FORMAT_VERSION",
    "BundleVersionError",
    "FeatureBundle",
    "fit_bundle",
    "save_bundle",
    "load_bundle",
    "list_bundles",
]

BUNDLE_FORMAT_VERSION = 1
_NODE_PREFIX = "bundle-"
_DOC_NAME = "bundle.json"
_VOCAB_SAMPLE = 256  # categories recorded per cat column for warm synthesis
# the server's row buckets (serving/program.ApplyProgram.row_buckets); eager
# torch compiles nothing, so there is no shape-bucket knob to record
_ROW_BUCKETS = {"enabled": True, "scheme": "rows 8 * 2^k up to the server's max batch"}


class BundleVersionError(RuntimeError):
    """The bundle's format version (or content digest) does not match:
    refusing to serve from state this build cannot faithfully interpret."""


@dataclasses.dataclass
class FeatureBundle:
    """An in-memory bundle: the JSON document plus its content version."""

    doc: dict
    version: str

    @property
    def chain(self) -> List[dict]:
        return list(self.doc["chain"])

    @property
    def input_columns(self) -> List[dict]:
        """Required request columns: ``[{name, kind, dtype_name, vocab?}]``."""
        return list(self.doc["schema"]["input_columns"])

    @property
    def input_names(self) -> List[str]:
        return [c["name"] for c in self.input_columns]


def _canonical(doc: dict) -> str:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


# export metadata, excluded from the content address: re-exporting the
# SAME fitted state must dedupe to the same version even though the wall
# clock (and the operator's dataset path string) moved
_VOLATILE_KEYS = ("created_unix", "source")


def _digest(doc: dict) -> str:
    addressed = {k: v for k, v in doc.items() if k not in _VOLATILE_KEYS}
    return hashlib.sha256(_canonical(addressed).encode()).hexdigest()


def fit_bundle(idf, chain: Sequence[Union[Tuple[str, dict], dict]],
               source: Optional[str] = None) -> FeatureBundle:
    """Fit ``chain`` on ``idf`` and assemble the bundle document.

    ``chain`` entries are ``(transformer_name, config)`` pairs (or dicts
    with ``name``/``config`` keys, the YAML-friendly form).  Each stage is
    fitted on the running table through
    :func:`~anovos_tpu_torch.data_transformer.transformers.fitted_state`,
    then the table is advanced with the stage's apply-only form
    (:func:`from_state`), so later stages see exactly what the server
    will compute."""
    from anovos_tpu_torch.data_transformer import transformers as T

    states: List[dict] = []
    working = idf
    orig = dict(idf.columns)
    for entry in chain:
        if isinstance(entry, dict):
            name, config = entry["name"], entry.get("config") or {}
        else:
            name, config = entry[0], entry[1] or {}
        state = T.fitted_state(working, name, config)
        states.append(state)
        working = T.from_state(state).apply(working)

    needed = {c for s in states for c in s["cols"]}
    input_columns: List[dict] = []
    for name in idf.col_names:
        if name not in needed:
            continue
        col = orig[name]
        entry = {"name": name, "kind": col.kind, "dtype_name": col.dtype_name}
        if col.kind == "cat" and col.vocab is not None:
            entry["vocab"] = [str(v) for v in col.vocab[:_VOCAB_SAMPLE]]
        input_columns.append(entry)

    doc = {
        "bundle_format": BUNDLE_FORMAT_VERSION,
        "anovos_version": _anovos_version(),
        "created_unix": round(time.time(), 3),
        "source": source or "",
        "chain": states,
        "schema": {
            "input_columns": input_columns,
            "output_columns": list(working.col_names),
            "fit_rows": int(idf.nrows),
        },
        "shape_buckets": dict(_ROW_BUCKETS),
    }
    return FeatureBundle(doc=doc, version=_digest(doc))


def _anovos_version() -> str:
    from anovos_tpu_torch.version import __version__

    return __version__


def _store(cache: Union[str, CacheStore]) -> CacheStore:
    return cache if isinstance(cache, CacheStore) else CacheStore(cache)


def save_bundle(bundle: FeatureBundle, cache: Union[str, CacheStore]) -> str:
    """Commit the bundle into the CAS store; returns the bundle version.

    Content-addressed and idempotent: re-exporting identical fitted state
    commits the same version.  The store's commit ordering (payload dir,
    then node manifest) keeps a torn export invisible."""
    store = _store(cache)
    doc_json = _canonical(bundle.doc)

    def write_payload(tmp_dir: str) -> None:
        with open(os.path.join(tmp_dir, _DOC_NAME), "w") as f:
            f.write(doc_json)

    store.commit(_NODE_PREFIX + bundle.version, "serving_bundle", paths=(),
                 payload_write=write_payload)
    return bundle.version


def load_bundle(cache: Union[str, CacheStore], version: str) -> FeatureBundle:
    """Load and verify one bundle by version.

    Refuses (``BundleVersionError``) when the version is absent, the
    payload's content digest no longer matches the requested version, or
    the document's ``bundle_format`` is not the one this build speaks."""
    store = _store(cache)
    if store.lookup(_NODE_PREFIX + version) is None:
        raise BundleVersionError(f"bundle {version!r} not found in store {store.root}")
    path = os.path.join(store.payload_dir(_NODE_PREFIX + version), _DOC_NAME)
    try:
        with open(path) as f:
            doc = json.loads(f.read())
    except (OSError, ValueError) as e:
        raise BundleVersionError(f"bundle {version!r} payload unreadable: {e}") from e
    if _digest(doc) != version:
        raise BundleVersionError(
            f"bundle {version!r} content digest mismatch: the stored document was altered "
            "after export; refusing to serve from it")
    fmt = doc.get("bundle_format")
    if fmt != BUNDLE_FORMAT_VERSION:
        raise BundleVersionError(
            f"bundle {version!r} has format version {fmt!r}; this build speaks "
            f"{BUNDLE_FORMAT_VERSION}: re-export the bundle with a matching build instead of "
            "serving a misread model")
    return FeatureBundle(doc=doc, version=version)


def list_bundles(cache: Union[str, CacheStore]) -> List[Dict[str, object]]:
    """Committed bundles in the store: ``[{version, created_unix, source,
    stages}]``."""
    store = _store(cache)
    out: List[Dict[str, object]] = []
    try:
        names = sorted(os.listdir(store.nodes_dir))
    except OSError:
        return out
    for fname in names:
        if not (fname.startswith(_NODE_PREFIX) and fname.endswith(".json")):
            continue
        version = fname[len(_NODE_PREFIX):-len(".json")]
        try:
            bundle = load_bundle(store, version)
        except BundleVersionError:
            continue
        out.append({
            "version": version,
            "created_unix": bundle.doc.get("created_unix"),
            "source": bundle.doc.get("source", ""),
            "stages": [s["family"] for s in bundle.chain],
        })
    return out
