"""The node-result store's commit and lookup (counterpart of
``anovos_tpu/cache/store.py``, the same on-disk layout).

Layout under the store root::

    nodes/<fingerprint>.json  # node manifest — the COMMIT POINT
    payloads/<fingerprint>/   # opaque per-node payload

The port's one writer is the continuum's snapshot commit
(``continuum/state.py``), which stores a payload and no files, so a
manifest's ``files`` list is always empty here.  The JAX package's
content-addressed ``objects/``, its file restore, its LRU ``gc`` and the
``ANOVOS_TPU_CACHE*`` knobs serve the runner's node cache, which is not
ported (ROADMAP.md Queue A item 1).

Commit protocol (crash-safe by ordering): the payload dir lands first
(tmp dir + rename), then the node manifest (tmp + rename).  A run killed
at any point leaves either a fully-committed node or tmp debris, never a
manifest pointing at a missing payload.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Callable, List, Optional

__all__ = ["CacheStore"]

_MANIFEST_VERSION = 1


class CacheStore:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.nodes_dir = os.path.join(self.root, "nodes")
        self.payloads_dir = os.path.join(self.root, "payloads")
        for d in (self.nodes_dir, self.payloads_dir):
            os.makedirs(d, exist_ok=True)

    def _manifest_path(self, fp: str) -> str:
        return os.path.join(self.nodes_dir, fp + ".json")

    def payload_dir(self, fp: str) -> str:
        return os.path.join(self.payloads_dir, fp)

    def _tmp_name(self) -> str:
        return f".tmp-{os.getpid()}-{threading.get_ident()}-{time.monotonic_ns()}"

    def commit(self, fp: str, node: str, payload_write: Callable[[str], None]) -> dict:
        """Store the payload that ``payload_write(dir)`` writes under
        ``fp``, then the manifest that commits it."""
        pdir = self.payload_dir(fp)
        tmp = pdir + self._tmp_name()
        os.makedirs(tmp)
        try:
            payload_write(tmp)
            if os.path.isdir(pdir):
                shutil.rmtree(pdir)
            os.rename(tmp, pdir)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        manifest = {
            "manifest_version": _MANIFEST_VERSION,
            "fingerprint": fp,
            "node": node,
            "files": [],
            "payload": True,
            "created_unix": round(time.time(), 3),
        }
        mpath = self._manifest_path(fp)
        tmp = mpath + self._tmp_name()
        with open(tmp, "w") as f:
            json.dump(manifest, f, sort_keys=True, separators=(",", ":"))
        os.rename(tmp, mpath)  # the commit point
        return manifest

    def lookup(self, fp: str) -> Optional[dict]:
        """The committed manifest for ``fp``, or None when it or its
        payload is missing.  Touches the manifest, the LRU clock that a
        JAX package's ``gc`` over the same root reads."""
        mpath = self._manifest_path(fp)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        if manifest.get("payload") and not os.path.isdir(self.payload_dir(fp)):
            return None
        try:
            os.utime(mpath)
        except OSError:
            pass
        return manifest

    def manifests(self) -> List[dict]:
        """Every committed manifest, in file-name order (unreadable ones
        skipped)."""
        out = []
        for f in sorted(os.listdir(self.nodes_dir)):
            if not f.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.nodes_dir, f)) as fh:
                    out.append(json.load(fh))
            except (OSError, ValueError):
                continue
        return out
