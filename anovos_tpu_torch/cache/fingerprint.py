"""Canonical config hashing and dataset fingerprints (counterpart of
``anovos_tpu/cache/fingerprint.py`` ``canonical``, ``digest`` and
``dataset_fingerprint``).  The digest of the same inputs is the JAX
package's, byte for byte."""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

__all__ = ["canonical", "digest", "dataset_fingerprint"]


def canonical(obj) -> str:
    """Deterministic JSON of a config slice; ``None``-valued dict entries
    are dropped recursively (the runner ignores them)."""

    def strip(o):
        if isinstance(o, dict):
            return {str(k): strip(v) for k, v in o.items() if v is not None}
        if isinstance(o, (list, tuple)):
            return [strip(v) for v in o]
        return o

    return json.dumps(strip(obj), sort_keys=True, default=str, separators=(",", ":"))


def digest(*parts: str) -> str:
    """sha256 hex of the parts, each followed by a NUL byte (an
    unambiguous part boundary); str parts are UTF-8 encoded."""
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode() if isinstance(p, str) else p)
        h.update(b"\x00")
    return h.hexdigest()


def _stat_sig(path: str) -> str:
    st = os.stat(path)
    return f"{path}:{st.st_size}:{st.st_mtime_ns}"


def dataset_fingerprint(spec: Optional[dict]) -> str:
    """Fingerprint of an input-dataset spec: the canonical spec plus a
    (path, size, mtime_ns) signature of every file under its read path.
    Stat-based, not content-hashed: a touch without a content change
    costs one spurious recompute, never a wrong hit."""
    spec = spec or {}
    sigs = []
    path = ((spec.get("read_dataset") or {}).get("file_path")
            if isinstance(spec.get("read_dataset"), dict) else None)
    if path and os.path.isdir(path):
        for dirpath, dirs, files in os.walk(path):
            dirs.sort()
            for f in sorted(files):
                try:
                    sigs.append(_stat_sig(os.path.join(dirpath, f)))
                except OSError:
                    pass
    elif path and os.path.isfile(path):
        try:
            sigs.append(_stat_sig(path))
        except OSError:
            pass
    return digest(canonical(spec), *sigs)
