"""Continuum state: per-partition sufficient-stat partials with a
write-ahead journal and content-addressed snapshots (counterpart of
``anovos_tpu/continuum/state.py``, the same layout, file names, manifest
keys and journal events).

Layout under ``state_dir``::

    parts/<slug>.npz            # one partition's partials: the durability
                                # point (tmp + rename + fsync); it carries
                                # its own ``__meta__`` JSON (part key, stat
                                # signature, rows, families, feed config),
                                # so a crash between the rename and the
                                # manifest flush loses nothing: the next
                                # open adopts orphan npzs whose signature
                                # and config still match
    state_manifest.json         # part key -> {sig, rows, families,
                                # quarantined, npz, path} (tmp + rename)
    continuum_journal.jsonl     # the WAL (cache/journal.RunJournal):
                                # step_begin / partition_seen /
                                # fold_commit / snapshot_commit /
                                # alert_emitted / model_fitted / step_end
    sections/                   # report-fragment cache (continuum_report)

A partition's identity is its file's stat signature (``size:mtime_ns``):
a part whose signature changed is *changed* (its partial dropped and
re-folded), a part that disappeared is *retracted* (the keyed-union
monoid subtracts it by deleting its key), and an unchanged part is never
decoded again.

Snapshots commit the whole state (manifest + part npzs) into the
:class:`~anovos_tpu_torch.cache.store.CacheStore` as one content-addressed
node per fold frontier, ``fp = H(config ∥ sorted (part, sig,
quarantined))``, so identical frontiers dedupe and a state dir lost
wholesale restores from the newest snapshot of this feed config.  A crash
mid-fold resumes from the npzs on disk with no committed part decoded
again.  The port's partials are float64 where the JAX package's are f32
(the moments), so neither package adopts the other's state.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from anovos_tpu_torch.cache.fingerprint import digest
from anovos_tpu_torch.cache.journal import RunJournal
from anovos_tpu_torch.continuum.sufficient import (
    ACCUMULATORS,
    FoldContext,
    PartFrame,
    active_families,
)

logger = logging.getLogger(__name__)

__all__ = ["ContinuumState", "ScanResult", "part_signature"]

MANIFEST = "state_manifest.json"
JOURNAL = "continuum_journal.jsonl"
SNAPSHOT_NODE = "continuum:state"


def part_signature(path: str) -> Optional[str]:
    """Stat signature of one part file, ``size:mtime_ns`` (None when it is
    gone)."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return f"{st.st_size}:{st.st_mtime_ns}"


def _slug(part_key: str) -> str:
    safe = "".join(c if (c.isalnum() or c in "._-") else "_" for c in part_key)
    return f"{safe[:80]}-{hashlib.sha256(part_key.encode()).hexdigest()[:12]}"


@dataclasses.dataclass
class ScanResult:
    new: List[str]
    changed: List[str]
    retracted: List[str]
    unchanged: List[str]
    quarantined: List[str]  # known-bad parts whose signature has not moved

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class ContinuumState:
    def __init__(self, state_dir: str, config_sig: str, ctx: FoldContext):
        self.root = os.path.abspath(state_dir)
        self.parts_dir = os.path.join(self.root, "parts")
        self.config_sig = config_sig
        self.ctx = ctx
        os.makedirs(self.parts_dir, exist_ok=True)
        # part key -> {"sig", "rows", "families", "quarantined", "npz"}
        self.parts: Dict[str, dict] = {}
        self._partials: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
        # family -> basis digest (the side input the family's partials
        # were computed under: drift cutoffs, outlier bounds) — see
        # check_family_basis
        self._basis: Dict[str, str] = {}
        mpath = os.path.join(self.root, MANIFEST)
        prior = None
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    prior = json.load(f)
            except (OSError, ValueError):
                prior = None
        if prior is not None and prior.get("config_sig") == config_sig:
            # trust the npz, not the manifest: a committed partial whose
            # file vanished is treated as never folded
            for key, e in (prior.get("parts") or {}).items():
                if e.get("quarantined") or os.path.exists(
                        os.path.join(self.parts_dir, e.get("npz", ""))):
                    self.parts[key] = dict(e)
            self._basis = dict(prior.get("family_basis") or {})
        elif prior is not None:
            logger.warning(
                "continuum state at %s belongs to a different feed config — "
                "starting fresh", self.root)
        self.journal = RunJournal(os.path.join(self.root, JOURNAL))
        self._adopt_orphans()

    # -- crash recovery ----------------------------------------------------
    def _adopt_orphans(self) -> None:
        """Adopt part npzs committed after the last manifest flush (the
        crash window between the npz rename and the manifest write): the
        npz's embedded meta names the part, the stat signature it was
        decoded under AND the feed config it was folded under — only a
        partial matching both folds in (with no decode); anything else —
        a different config's leftovers after a "starting fresh", a part
        whose bytes moved, an unrenamed ``.tmp`` from a mid-write crash —
        is swept."""
        known = {e.get("npz") for e in self.parts.values()}
        for fn in sorted(os.listdir(self.parts_dir)):
            if fn.endswith(".tmp"):  # mid-write crash debris: never committed
                try:
                    os.unlink(os.path.join(self.parts_dir, fn))
                except OSError:
                    pass
                continue
            if not fn.endswith(".npz") or fn in known:
                continue
            fpath = os.path.join(self.parts_dir, fn)
            try:
                with np.load(fpath, allow_pickle=False) as z:
                    meta = json.loads(str(z["__meta__"]))
            except Exception:
                logger.warning("unreadable orphan partial %s dropped", fn)
                try:
                    os.unlink(fpath)
                except OSError:
                    pass
                continue
            key = meta.get("part", "")
            if meta.get("config_sig") != self.config_sig:
                logger.warning(
                    "orphan partial %s was folded under a different feed "
                    "config — dropped (the part will re-fold)", fn)
                try:
                    os.unlink(fpath)
                except OSError:
                    pass
                continue
            if part_signature(meta.get("path", "")) != meta.get("sig"):
                logger.warning(
                    "orphan partial %s no longer matches its part's "
                    "signature — dropped (the part will re-fold)", fn)
                try:
                    os.unlink(fpath)
                except OSError:
                    pass
                continue
            self.parts[key] = {"sig": meta["sig"], "rows": meta.get("rows", 0),
                               "families": meta.get("families", []),
                               "quarantined": False, "npz": fn,
                               "path": meta.get("path", "")}
            self.journal.append("partition_seen", part=key, status="adopted")
            self._flush_manifest()

    # -- scanning ----------------------------------------------------------
    def scan(self, files: List[str], dataset_root: str) -> ScanResult:
        """Classify the dataset's current part files against the folded
        state by stat signature.  ``part key`` = path relative to the
        dataset root (stable across machines and across the incremental
        and from-scratch legs)."""
        res = ScanResult([], [], [], [], [])
        seen = set()
        for f in files:
            key = os.path.relpath(os.path.abspath(f), os.path.abspath(dataset_root))
            seen.add(key)
            sig = part_signature(f)
            if sig is None:
                continue
            e = self.parts.get(key)
            if e is None:
                res.new.append(key)
            elif e.get("sig") != sig:
                res.changed.append(key)
            elif e.get("quarantined"):
                res.quarantined.append(key)
            else:
                res.unchanged.append(key)
        for key in sorted(self.parts):
            if key not in seen:
                res.retracted.append(key)
        return res

    # -- partial I/O -------------------------------------------------------
    def _npz_arrays(self, key: str) -> Dict[str, np.ndarray]:
        e = self.parts[key]
        with np.load(os.path.join(self.parts_dir, e["npz"]),
                     allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def partials(self, key: str) -> Dict[str, Dict[str, np.ndarray]]:
        """{family: partial arrays} of one folded partition (cached)."""
        if key not in self._partials:
            arrays = self._npz_arrays(key)
            fams: Dict[str, Dict[str, np.ndarray]] = {}
            for name in arrays:
                if name == "__meta__":
                    continue
                fam, _, sub = name.partition("__")
                fams.setdefault(fam, {})[sub] = arrays[name]
            self._partials[key] = fams
        return self._partials[key]

    def family_state(self, family: str, keys=None) -> Dict[str, Dict[str, np.ndarray]]:
        """The keyed partial map of one family over ``keys`` (default:
        every folded, unquarantined partition) — the monoid state the
        accumulator's ``finalize`` consumes."""
        out = {}
        for key in sorted(keys if keys is not None else self.parts):
            e = self.parts.get(key)
            if e is None or e.get("quarantined") or family not in e.get("families", []):
                continue
            out[key] = self.partials(key)[family]
        return out

    def parts_missing_family(self, family: str) -> List[str]:
        return sorted(
            k for k, e in self.parts.items()
            if not e.get("quarantined") and family not in e.get("families", []))

    def check_family_basis(self, family: str, basis: str) -> int:
        """A family's partials are valid only under the side input they
        were computed against — drift histograms under THEIR cutoff
        matrix, outlier counts under THEIR bounds.  This is the continuum
        analogue of ``StreamCheckpoint.check_bounds``: a changed basis
        (someone swapped the persisted model) strips the family from
        every folded partition, and the watcher's catch-up re-fold
        recomputes them under the new basis.  Returns the number of
        partitions stripped."""
        prior = self._basis.get(family)
        if prior == basis:
            return 0
        n = 0
        if prior is not None:
            for key, e in self.parts.items():
                if family in e.get("families", []):
                    e["families"] = [f for f in e["families"] if f != family]
                    self._partials.pop(key, None)
                    n += 1
            if n:
                logger.warning(
                    "continuum: the %s family's basis changed (model "
                    "swapped?) — %d partition(s) will re-fold it", family, n)
                self.journal.append("family_invalidated", family=family,
                                    parts=n)
        self._basis[family] = basis
        self._flush_manifest()
        return n

    # -- folding -----------------------------------------------------------
    def part_partials(self, key: str, frame) -> Dict[str, Dict[str, np.ndarray]]:
        """Every active family's partial of one decoded partition (the
        device work of a fold; nothing is committed)."""
        part = PartFrame(frame, self.ctx)
        return {fam: ACCUMULATORS[fam].from_chunk(part, self.ctx, key)[key]
                for fam in active_families(self.ctx, key)}

    def fold_part(self, key: str, path: str, frame, sig: str) -> dict:
        """Fold one decoded partition: :meth:`part_partials`, then
        :meth:`commit_part`."""
        return self.commit_part(key, path, self.part_partials(key, frame), len(frame), sig)

    def commit_part(self, key: str, path: str, partials: Dict[str, Dict[str, np.ndarray]],
                    rows: int, sig: str) -> dict:
        """Commit one partition's partials: the npz (tmp + rename + fsync,
        the durability point), the journal's ``fold_commit``, then the
        manifest."""
        fams = list(partials)
        arrays: Dict[str, np.ndarray] = {}
        for fam, partial in partials.items():
            for sub, arr in partial.items():
                arrays[f"{fam}__{sub}"] = np.asarray(arr)
        meta = {"part": key, "path": os.path.abspath(path), "sig": sig,
                "rows": int(rows), "families": fams,
                "config_sig": self.config_sig}
        arrays["__meta__"] = np.asarray(json.dumps(meta, sort_keys=True))
        npz_name = _slug(key) + ".npz"
        dest = os.path.join(self.parts_dir, npz_name)
        # ".tmp" (not ".tmp.npz"): the orphan-recovery scan adopts "*.npz"
        # files, and an unrenamed temp must never look committed (savez
        # writes into the open file object, so no suffix is appended)
        tmp = dest + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dest)
        entry = {"sig": sig, "rows": int(rows), "families": fams,
                 "quarantined": False, "npz": npz_name,
                 "path": os.path.abspath(path)}
        self.parts[key] = entry
        self._partials[key] = partials
        self.journal.append("fold_commit", part=key, rows=int(rows),
                            families=fams, decoded=True)
        self._flush_manifest()
        # chaos site for the mid-fold-kill gate: an injected exc here
        # aborts the step with this partition committed and the snapshot
        # not yet taken — exactly the crash window resume must cover
        from anovos_tpu_torch.resilience.chaos import chaos_point

        chaos_point(f"continuum:fold_committed:{key}")
        return entry

    def mark_quarantined(self, key: str, path: str, sig: str, reason: str) -> None:
        """A partition the guard set aside: remembered BY SIGNATURE so an
        unchanged corrupt part is not re-attempted every poll (a rewritten
        one — new signature — retries)."""
        old = self.parts.get(key)
        if old is not None and old.get("npz"):
            try:
                os.unlink(os.path.join(self.parts_dir, old["npz"]))
            except OSError:
                pass
            self._partials.pop(key, None)
        self.parts[key] = {"sig": sig, "rows": 0, "families": [],
                           "quarantined": True, "npz": "",
                           "path": os.path.abspath(path), "reason": reason}
        self.journal.append("partition_seen", part=key, status="quarantined",
                            reason=reason[:200])
        self._flush_manifest()

    def retract(self, key: str) -> None:
        e = self.parts.pop(key, None)
        self._partials.pop(key, None)
        if e and e.get("npz"):
            try:
                os.unlink(os.path.join(self.parts_dir, e["npz"]))
            except OSError:
                pass
        self.journal.append("partition_seen", part=key, status="retracted")
        self._flush_manifest()

    def _flush_manifest(self) -> None:
        mpath = os.path.join(self.root, MANIFEST)
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"config_sig": self.config_sig, "parts": self.parts,
                       "family_basis": self._basis},
                      f, sort_keys=True)
        os.replace(tmp, mpath)

    # -- accounting --------------------------------------------------------
    def folded_keys(self) -> List[str]:
        return sorted(k for k, e in self.parts.items() if not e.get("quarantined"))

    def quarantined_parts(self) -> Dict[str, dict]:
        return {k: e for k, e in sorted(self.parts.items()) if e.get("quarantined")}

    def total_rows(self) -> int:
        return sum(int(e.get("rows", 0)) for e in self.parts.values()
                   if not e.get("quarantined"))

    # -- snapshots ---------------------------------------------------------
    def frontier_fingerprint(self) -> str:
        """Content address of the fold frontier: feed config + the sorted
        (part, signature, quarantined) set.  Identical frontiers — e.g.
        the incremental and from-scratch legs after the same days — hash
        equal and dedupe in the store."""
        return digest(
            self.config_sig,
            *(f"{k}:{e.get('sig')}:{int(bool(e.get('quarantined')))}"
              for k, e in sorted(self.parts.items())))

    def snapshot(self, store) -> Optional[str]:
        """Commit the state (manifest + part npzs) as one content-
        addressed node in the CacheStore; journals
        ``snapshot_commit``.  Returns the fingerprint (None with no
        store).  An already-committed frontier is not re-written."""
        if store is None:
            return None
        fp = self.frontier_fingerprint()
        if store.lookup(fp) is None:
            def _payload(tmp_dir: str, self=self) -> None:
                os.makedirs(os.path.join(tmp_dir, "parts"), exist_ok=True)
                shutil.copyfile(os.path.join(self.root, MANIFEST),
                                os.path.join(tmp_dir, MANIFEST))
                for e in self.parts.values():
                    if e.get("npz"):
                        shutil.copyfile(
                            os.path.join(self.parts_dir, e["npz"]),
                            os.path.join(tmp_dir, "parts", e["npz"]))

            store.commit(fp, f"{SNAPSHOT_NODE}:{self.config_sig[:16]}", (),
                         payload_write=_payload)
        self.journal.append("snapshot_commit", fp=fp, parts=len(self.parts))
        return fp

    @classmethod
    def restore_from_store(cls, store, state_dir: str, config_sig: str,
                           ctx: FoldContext) -> Optional["ContinuumState"]:
        """Rebuild a lost state dir from the NEWEST committed snapshot of
        this feed config (content-addressed lookup over the store's node
        manifests).  Returns None when the store has no matching
        snapshot."""
        if store is None:
            return None
        want = f"{SNAPSHOT_NODE}:{config_sig[:16]}"
        best = None
        for m in store.manifests():
            if m.get("node") == want and m.get("payload"):
                if best is None or m.get("created_unix", 0) > best.get("created_unix", 0):
                    best = m
        if best is None:
            return None
        pdir = store.payload_dir(best["fingerprint"])
        os.makedirs(os.path.join(state_dir, "parts"), exist_ok=True)
        for fn in os.listdir(os.path.join(pdir, "parts")):
            shutil.copyfile(os.path.join(pdir, "parts", fn),
                            os.path.join(state_dir, "parts", fn))
        shutil.copyfile(os.path.join(pdir, MANIFEST),
                        os.path.join(state_dir, MANIFEST))
        state = cls(state_dir, config_sig, ctx)
        state.journal.append("state_restored", fp=best["fingerprint"],
                             parts=len(state.parts))
        return state
