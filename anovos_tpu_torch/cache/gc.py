"""LRU garbage collection for the node cache (counterpart of the JAX
package's ``tools/cache_gc.py``, with the same output and exit codes).

Usage::

    python -m anovos_tpu_torch.cache.gc [--root DIR] --max-bytes N [--dry-run] [--json]

``--root`` defaults to ``$ANOVOS_TPU_CACHE``.  ``--max-bytes`` accepts
plain bytes or a K/M/G suffix (``--max-bytes 500M``).  Evicts the
least-recently-used node entries (manifest + payload + newly-unreferenced
objects) and the JAX package's compilation-cache files under ``xla/``
until the store fits, sweeps tmp debris from crashed commits and orphaned
objects, and prints an accounting summary.

Exit status: 0 when the store fits ``--max-bytes`` after the sweep (or
would, under ``--dry-run``); 1 when it still does not fit or the root is
missing.  The same sweep runs at the end of every ``workflow.main`` when
``ANOVOS_TPU_CACHE_MAX_BYTES`` is set.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from anovos_tpu_torch.cache.store import CacheStore, parse_bytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.environ.get("ANOVOS_TPU_CACHE", ""),
                    help="cache root (default: $ANOVOS_TPU_CACHE)")
    ap.add_argument("--max-bytes", required=True, type=parse_bytes,
                    help="capacity bound (supports K/M/G suffix)")
    ap.add_argument("--dry-run", action="store_true",
                    help="report what would be evicted without deleting")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    args = ap.parse_args(argv)

    if not args.root or not os.path.isdir(args.root):
        print(f"cache_gc: cache root {args.root!r} does not exist "
              "(set --root or ANOVOS_TPU_CACHE)", file=sys.stderr)
        return 1
    if args.max_bytes < 0:
        print("cache_gc: --max-bytes must be >= 0", file=sys.stderr)
        return 1

    stats = CacheStore(args.root).gc(args.max_bytes, dry_run=args.dry_run)
    if args.json:
        print(json.dumps(stats, sort_keys=True))
    else:
        verb = "would evict" if args.dry_run else "evicted"
        print(f"cache_gc: {stats['before_bytes']} -> {stats['after_bytes']} bytes "
              f"(cap {stats['max_bytes']}); {verb} "
              f"{len(stats['evicted_nodes'])} node entr"
              f"{'y' if len(stats['evicted_nodes']) == 1 else 'ies'} + "
              f"{stats['evicted_xla_files']} xla file(s); swept "
              f"{stats['swept_tmp']} tmp + {stats['swept_orphan_objects']} orphan object(s)")
    return 0 if stats["fits"] else 1


if __name__ == "__main__":
    sys.exit(main())
