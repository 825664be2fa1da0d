"""The apply program: bundle → row→features pipeline (counterpart of
``anovos_tpu/serving/program.py``).

``ApplyProgram`` rebuilds a bundle's transformer chain in apply-only form
(:func:`~anovos_tpu_torch.data_transformer.transformers.from_state`, the
batch functions' pre-existing-model branches, so a served apply runs the
very code of a batch re-apply) and owns the serving row buckets:

* **row buckets**: micro-batch row counts round up to geometric size
  classes (8, 16, 32, ... up to the server's max batch), so every batch
  the server applies has one of a few shapes.  Padding replicates
  existing rows (every servable transform is row-independent, so the
  replicas' outputs are sliced off) rather than adding null rows, which
  would change the inferred dtypes.
* **warm()**: at server start, drive the whole apply path once a bucket
  on schema-synthesized rows.  Eager torch compiles nothing; what the
  warm-up settles is the CUDA caching allocator's segments (the first
  apply at a shape pays the ``cudaMalloc`` of its blocks) and any
  first-call work of the libraries.  Per bucket it records the wall, the
  hand-kernel launches (:data:`anovos_tpu_torch.ops.kernels.LAUNCHES`) and
  the allocator segments the bucket added
  (``torch.cuda.memory_stats()['segment.all.allocated']``, 0 on a CPU
  runtime): the port's counterpart of the JAX package's compiles a
  bucket.  After it, a request-time apply at any bucket is expected to
  launch no hand kernel and add no segment
  (:meth:`device_counters` reads both).

There is no CUDA-graph capture: every apply crosses pandas at both ends
and each model-based family reads its model files from the
``FittedTransformer``'s temporary directory, so no part of the chain runs
without the host.

``ANOVOS_SERVE_BF16=1`` raises: in the JAX package it routes MXU matmuls
through the bf16 sweep for the whole process; the servable chain has no
matmul, and the port keeps f32 with TF32 off.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import pandas as pd

from anovos_tpu_torch.serving.bundle import FeatureBundle

logger = logging.getLogger("anovos_tpu_torch.serving.program")

__all__ = ["ApplyProgram"]

_BUCKET_FLOOR = 8


def _segments() -> int:
    """CUDA caching-allocator segments allocated so far on the runtime's
    card (0 on a CPU runtime)."""
    from anovos_tpu_torch.shared.runtime import peek_runtime

    rt = peek_runtime()
    if rt is None or rt.device.type != "cuda":
        return 0
    import torch

    return int(torch.cuda.memory_stats(rt.device).get("segment.all.allocated", 0))


def _launches() -> int:
    from anovos_tpu_torch.ops import kernels

    return sum(kernels.LAUNCHES.values())


class ApplyProgram:
    """Apply-only pipeline for one bundle, with a warm-up a row bucket."""

    def __init__(self, bundle: FeatureBundle):
        from anovos_tpu_torch.data_transformer import transformers as T

        if os.environ.get("ANOVOS_SERVE_BF16", "") == "1":
            raise NotImplementedError(
                "ANOVOS_SERVE_BF16=1 routes the JAX package's MXU matmuls through its bf16 sweep; "
                "the servable chain has no matmul and the port serves in f32 with TF32 off: unset it")
        self.bundle = bundle
        self.transformers = [T.from_state(s) for s in bundle.chain]
        self.input_columns: List[dict] = bundle.input_columns
        self.warmed_buckets: List[int] = []
        self.warm_stats: Dict[str, object] = {}

    # -- row buckets ----------------------------------------------------------
    @staticmethod
    def row_buckets(max_rows: int) -> List[int]:
        """Geometric batch-size classes up to (and covering) ``max_rows``."""
        out = [_BUCKET_FLOOR]
        while out[-1] < max_rows:
            out.append(out[-1] * 2)
        return out

    @classmethod
    def bucket_rows(cls, n: int, max_rows: int) -> int:
        buckets = cls.row_buckets(max_rows)
        for b in buckets:
            if b >= n:
                return b
        return buckets[-1]

    @staticmethod
    def pad_frame(df: pd.DataFrame, rows: int) -> pd.DataFrame:
        """Pad ``df`` up to ``rows`` by cycling its own rows: the live rows
        stay first and unchanged, and the replicas keep the frame's dtypes."""
        if len(df) >= rows:
            return df
        idx = np.arange(rows) % len(df)
        return df.iloc[idx].reset_index(drop=True)

    # -- the apply path -------------------------------------------------------
    def apply_table(self, idf):
        for ft in self.transformers:
            idf = ft.apply(idf)
        return idf

    def apply_frame(self, df: pd.DataFrame) -> pd.DataFrame:
        """Coerced request frame → feature frame (live rows only)."""
        from anovos_tpu_torch.shared.table import Table

        n = len(df)
        out = self.apply_table(Table.from_pandas(df))
        return out.to_pandas().iloc[:n]

    @staticmethod
    def device_counters() -> Tuple[int, int]:
        """(hand-kernel launches, allocator segments) so far: a request
        path after :meth:`warm` should move neither."""
        return _launches(), _segments()

    # -- warm-up --------------------------------------------------------------
    def synthetic_frame(self, rows: int) -> pd.DataFrame:
        """Schema-shaped rows for the warm-up: numeric columns a spread of
        finite values plus a null, categorical columns the fitted vocab
        sample plus a null, so the warmed applies see the dtypes and the
        category counts that coerced live requests produce."""
        data: Dict[str, object] = {}
        for col in self.input_columns:
            name, kind = col["name"], col["kind"]
            if kind == "cat":
                vocab = list(col.get("vocab") or ["a", "b"])
                vals = [vocab[i % len(vocab)] for i in range(rows)]
                if rows > 1:
                    vals[-1] = None
                data[name] = np.array(vals, dtype=object)
            elif kind == "ts":
                base = np.datetime64("2020-01-01T00:00:00")
                data[name] = base + np.arange(rows).astype("timedelta64[s]")
            else:
                vals = np.linspace(1.0, 2.0, rows).astype(np.float64)
                if rows > 1:
                    vals[-1] = np.nan
                data[name] = vals
        return pd.DataFrame(data)

    def warm(self, max_rows: int) -> dict:
        """Drive the whole apply path once for every row bucket; returns the
        cold-start record (wall, buckets, and per bucket its wall, its
        hand-kernel launches and the allocator segments it added)."""
        t0 = time.perf_counter()
        walls: Dict[str, float] = {}
        launches: Dict[str, int] = {}
        segments: Dict[str, int] = {}
        buckets = self.row_buckets(max_rows)
        for b in buckets:
            l0, s0 = self.device_counters()
            tb = time.perf_counter()
            self.apply_frame(self.synthetic_frame(b))
            walls[str(b)] = round(time.perf_counter() - tb, 4)
            l1, s1 = self.device_counters()
            launches[str(b)], segments[str(b)] = l1 - l0, s1 - s0
        wall = time.perf_counter() - t0
        self.warmed_buckets = buckets
        self.warm_stats = {
            "warm_wall_s": round(wall, 3),
            "buckets": buckets,
            "wall_s_per_bucket": walls,
            "launches_per_bucket": launches,
            "segments_per_bucket": segments,
        }
        logger.info("serving warm-up: %d bucket(s) %s in %.2fs (launches %s, new segments %s)",
                    len(buckets), buckets, wall, launches, segments)
        return dict(self.warm_stats)
