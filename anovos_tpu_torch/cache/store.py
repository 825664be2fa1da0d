"""Content-addressed on-disk node-result store with LRU eviction
(counterpart of ``anovos_tpu/cache/store.py``, the same on-disk layout, so
a store either package committed restores through the other's
``restore``).

Layout under the cache root (``ANOVOS_TPU_CACHE=<dir>``)::

    objects/<aa>/<sha256>     # file contents, content-addressed (deduped)
    nodes/<fingerprint>.json  # node manifest: the COMMIT POINT
    payloads/<fingerprint>/   # opaque per-node payload (df checkpoints,
                              # the continuum's snapshots)
    xla/                      # the JAX package's compilation cache

The port writes nothing under ``xla/``, but its ``gc`` counts and evicts
those files as the JAX package's does, so a root shared with a JAX run
stays under the cap whichever package sweeps it.

Commit protocol (crash-safe by ordering): objects land first (tmp +
rename, so a torn write can never be addressed), then the payload dir
(tmp dir + rename), then the node manifest (tmp + rename).  A run killed
at any point leaves either a fully-committed node or garbage that the
next ``gc`` sweeps, never a manifest pointing at missing content.

Restores COPY from the object store by default.  Hard-linking
(``ANOVOS_TPU_CACHE_LINK=1``) is cheaper but unsafe against consumers
that rewrite a restored file in place via ``open("w")`` (truncating a
linked file would corrupt the shared object for every later restore), so
it is opt-in for read-only artifact trees.

Eviction is LRU over node entries and xla cache files: ``lookup`` touches
the manifest's mtime, ``gc(max_bytes)`` drops the least-recently-used
units (freeing objects once unreferenced) until the store fits.
``python -m anovos_tpu_torch.cache.gc`` is the CLI;
``ANOVOS_TPU_CACHE_MAX_BYTES`` makes ``workflow.main`` run the same sweep
at the end of every run.
"""

from __future__ import annotations

import json
import os
import shutil
import hashlib
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

__all__ = ["CacheStore", "cache_root", "enabled", "parse_bytes"]

_MANIFEST_VERSION = 1

_SIZE_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}


def parse_bytes(text) -> int:
    """Size with an optional K/M/G suffix → bytes (``"500M"`` → 524288000).
    Shared by the gc CLI's ``--max-bytes`` and the per-run
    ``ANOVOS_TPU_CACHE_MAX_BYTES`` sweep so both accept the same forms."""
    t = str(text).strip().lower()
    if t and t[-1] in _SIZE_SUFFIX:
        return int(float(t[:-1]) * _SIZE_SUFFIX[t[-1]])
    return int(t)


def cache_root() -> str:
    """The configured cache root ('' when caching is off)."""
    return os.environ.get("ANOVOS_TPU_CACHE", "")


def enabled() -> bool:
    return bool(cache_root())


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CacheStore:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.objects_dir = os.path.join(self.root, "objects")
        self.nodes_dir = os.path.join(self.root, "nodes")
        self.payloads_dir = os.path.join(self.root, "payloads")
        self.xla_dir = os.path.join(self.root, "xla")
        for d in (self.objects_dir, self.nodes_dir, self.payloads_dir):
            os.makedirs(d, exist_ok=True)

    # -- naming -----------------------------------------------------------
    def _obj_path(self, digest: str) -> str:
        return os.path.join(self.objects_dir, digest[:2], digest)

    def _manifest_path(self, fp: str) -> str:
        return os.path.join(self.nodes_dir, fp + ".json")

    def payload_dir(self, fp: str) -> str:
        return os.path.join(self.payloads_dir, fp)

    def _tmp_name(self) -> str:
        return f".tmp-{os.getpid()}-{threading.get_ident()}-{time.monotonic_ns()}"

    # -- commit -----------------------------------------------------------
    def _put_object(self, src: str) -> Dict[str, object]:
        digest = _sha256_file(src)
        dst = self._obj_path(digest)
        size = os.path.getsize(src)
        if not os.path.exists(dst):
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            tmp = dst + self._tmp_name()
            shutil.copyfile(src, tmp)
            os.rename(tmp, dst)  # atomic: a half-copied object is never addressed
        return {"sha256": digest, "size": size}

    def commit(
        self,
        fp: str,
        node: str,
        paths: Iterable[str],
        base_dir: Optional[str] = None,
        payload_write: Optional[Callable[[str], None]] = None,
    ) -> dict:
        """Store the node's captured files (and optional payload) under
        ``fp``.  ``base_dir`` (default cwd) anchors portability: files
        under it are stored relative so a restore in a different working
        directory rebuilds the same tree; files outside it restore to
        their absolute path (pinned)."""
        base = os.path.abspath(base_dir or os.getcwd())
        entries: List[dict] = []
        for p in sorted(set(os.path.abspath(x) for x in paths)):
            if not os.path.isfile(p):
                continue  # deleted/renamed after write (e.g. staging temp)
            rel = os.path.relpath(p, base)
            portable = not rel.startswith("..")
            entries.append({
                "path": rel if portable else p,
                "portable": portable,
                **self._put_object(p),
            })
        has_payload = False
        if payload_write is not None:
            pdir = self.payload_dir(fp)
            tmp = pdir + self._tmp_name()
            os.makedirs(tmp)
            try:
                payload_write(tmp)
                if os.path.isdir(pdir):
                    shutil.rmtree(pdir)
                os.rename(tmp, pdir)
                has_payload = True
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
        manifest = {
            "manifest_version": _MANIFEST_VERSION,
            "fingerprint": fp,
            "node": node,
            "files": entries,
            "payload": has_payload,
            "created_unix": round(time.time(), 3),
        }
        mpath = self._manifest_path(fp)
        tmp = mpath + self._tmp_name()
        with open(tmp, "w") as f:
            json.dump(manifest, f, sort_keys=True, separators=(",", ":"))
        os.rename(tmp, mpath)  # the commit point
        return manifest

    # -- lookup / restore -------------------------------------------------
    def lookup(self, fp: str) -> Optional[dict]:
        """The committed manifest for ``fp``, or None.  Touches the
        manifest (LRU clock) and verifies every referenced object and the
        payload still exist — a partially-evicted entry is a miss."""
        mpath = self._manifest_path(fp)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        for e in manifest.get("files", ()):
            if not os.path.exists(self._obj_path(e["sha256"])):
                return None
        if manifest.get("payload") and not os.path.isdir(self.payload_dir(fp)):
            return None
        try:
            os.utime(mpath)
        except OSError:
            pass
        return manifest

    def restore(self, manifest: dict, base_dir: Optional[str] = None) -> int:
        """Materialize the manifest's files; returns the count restored."""
        base = os.path.abspath(base_dir or os.getcwd())
        link = os.environ.get("ANOVOS_TPU_CACHE_LINK", "0") == "1"
        n = 0
        for e in manifest.get("files", ()):
            dest = e["path"] if not e.get("portable") else os.path.join(base, e["path"])
            src = self._obj_path(e["sha256"])
            d = os.path.dirname(dest)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = dest + self._tmp_name()
            if link:
                try:
                    if os.path.exists(dest):
                        os.remove(dest)
                    os.link(src, dest)
                    n += 1
                    continue
                except OSError:
                    pass  # cross-device: fall through to copy
            shutil.copyfile(src, tmp)
            os.replace(tmp, dest)
            n += 1
        return n

    # -- accounting / eviction -------------------------------------------
    def _dir_bytes(self, path: str) -> int:
        total = 0
        for dirpath, _dirs, files in os.walk(path):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, f))
                except OSError:
                    pass
        return total

    def total_bytes(self) -> int:
        return self._dir_bytes(self.root)

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

    def gc(self, max_bytes: int, dry_run: bool = False) -> dict:
        """Evict least-recently-used node entries and xla cache files until
        the store fits ``max_bytes``.  Also sweeps tmp debris and objects no
        remaining manifest references.  Returns an accounting dict."""
        before = self.total_bytes()
        # tmp debris from crashed commits is always garbage
        swept_tmp = 0
        if not dry_run:
            for dirpath, dirs, files in os.walk(self.root):
                for name in list(dirs):
                    if ".tmp-" in name:
                        shutil.rmtree(os.path.join(dirpath, name), ignore_errors=True)
                        dirs.remove(name)
                        swept_tmp += 1
                for name in files:
                    if ".tmp-" in name:
                        try:
                            os.remove(os.path.join(dirpath, name))
                            swept_tmp += 1
                        except OSError:
                            pass
        manifests = self.manifests()
        refs: Dict[str, int] = {}
        for m in manifests:
            for e in m.get("files", ()):
                refs[e["sha256"]] = refs.get(e["sha256"], 0) + 1
        # LRU units: (mtime, kind, identity)
        units: List[tuple] = []
        for m in manifests:
            mpath = self._manifest_path(m["fingerprint"])
            try:
                units.append((os.path.getmtime(mpath), "node", m["fingerprint"]))
            except OSError:
                continue
        if os.path.isdir(self.xla_dir):
            for dirpath, _dirs, files in os.walk(self.xla_dir):
                for f in files:
                    p = os.path.join(dirpath, f)
                    try:
                        units.append((os.path.getmtime(p), "xla", p))
                    except OSError:
                        pass
        units.sort()
        by_fp = {m["fingerprint"]: m for m in manifests}
        evicted_nodes: List[str] = []
        evicted_xla = 0
        total = self.total_bytes() if not dry_run else before
        for _mtime, kind, ident in units:
            if total <= max_bytes:
                break
            if kind == "xla":
                try:
                    size = os.path.getsize(ident)
                    if not dry_run:
                        os.remove(ident)
                    total -= size
                    evicted_xla += 1
                except OSError:
                    pass
                continue
            m = by_fp[ident]
            freed = 0
            mpath = self._manifest_path(ident)
            try:
                freed += os.path.getsize(mpath)
            except OSError:
                pass
            for e in m.get("files", ()):
                refs[e["sha256"]] -= 1
                if refs[e["sha256"]] == 0:
                    freed += int(e.get("size", 0))
                    if not dry_run:
                        try:
                            os.remove(self._obj_path(e["sha256"]))
                        except OSError:
                            pass
            pdir = self.payload_dir(ident)
            if os.path.isdir(pdir):
                freed += self._dir_bytes(pdir)
                if not dry_run:
                    shutil.rmtree(pdir, ignore_errors=True)
            if not dry_run:
                try:
                    os.remove(mpath)
                except OSError:
                    pass
            total -= freed
            evicted_nodes.append(ident)
        # orphaned objects (manifest evicted by an earlier crash/sweep)
        live = {e["sha256"] for m in self.manifests() for e in m.get("files", ())} \
            if not dry_run else {h for h, n in refs.items() if n > 0}
        swept_objects = 0
        if not dry_run:
            for dirpath, _dirs, files in os.walk(self.objects_dir):
                for f in files:
                    if f not in live:
                        try:
                            os.remove(os.path.join(dirpath, f))
                            swept_objects += 1
                        except OSError:
                            pass
        after = self.total_bytes() if not dry_run else total
        return {
            "before_bytes": before,
            "after_bytes": after,
            "max_bytes": max_bytes,
            "evicted_nodes": evicted_nodes,
            "evicted_xla_files": evicted_xla,
            "swept_tmp": swept_tmp,
            "swept_orphan_objects": swept_objects,
            "dry_run": dry_run,
            "fits": after <= max_bytes,
        }
