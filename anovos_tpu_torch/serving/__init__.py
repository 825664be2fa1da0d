"""``anovos_tpu_torch.serving``: versioned feature bundles and online
serving on the card (counterpart of ``anovos_tpu/serving``).

* **bundle** (``serving.bundle``): every fitted transformer's state
  (binning edges, z/IQR/min-max scaler params, boxcox λs, encoder vocab
  maps, imputer fills, outlier keep-sets, through
  ``data_transformer.transformers.fitted_state``/``from_state``) plus the
  input schema and the row buckets, persisted as ONE versioned,
  content-addressed document in the node cache's store.  The version IS
  the sha256 of the canonical JSON; a format-version mismatch refuses to
  load.  The layout is the JAX package's.
* **program** (``serving.program``): the apply-only row→features pipeline
  rebuilt from a bundle; ``warm()`` drives the apply path once a row
  bucket at server start and records each bucket's wall, hand-kernel
  launches and new allocator segments.  ``ANOVOS_SERVE_BF16=1`` raises.
* **server** (``serving.server``): a threaded request loop with a
  micro-batching queue (``ANOVOS_SERVE_BATCH_WINDOW_MS`` /
  ``ANOVOS_SERVE_MAX_BATCH``) that pads request batches onto the row
  buckets, refuses hostile payloads (±inf, f32 overflow, schema drift,
  wrong dtypes) with structured per-request errors, books latency and QPS
  in ``obs`` and the live plane's rolling windows, attributes each apply
  through ``devprof``, and writes a ``serve_fatal`` flight postmortem when
  a micro-batch fails after its retry.
* **demo** (``serving.demo``): the demo frame and chain, and
  ``run_serve_fault``, the fault gate.

``python -m anovos_tpu_torch.serving export|smoke`` is the CLI.  None of
the serving knobs is on the node cache's ``KNOWN_ENV_KNOBS``: serving
never runs as a scheduler node.
"""

from anovos_tpu_torch.serving.bundle import (  # noqa: F401
    BUNDLE_FORMAT_VERSION,
    BundleVersionError,
    FeatureBundle,
    fit_bundle,
    list_bundles,
    load_bundle,
    save_bundle,
)
from anovos_tpu_torch.serving.program import ApplyProgram  # noqa: F401
from anovos_tpu_torch.serving.server import (  # noqa: F401
    FeatureServer,
    coerce_payload,
    frame_to_payload,
)
