"""Pluggable artifact stores for the ``run_type`` deployment axis, and the
runner's async write queue (the port's own copy of
``anovos_tpu/shared/artifact_store.py``).

The reference shuttles artifacts with inline shell-outs at every save/read
site (``aws s3 cp`` for emr — report_preprocessing.py:97-119,
transformers.py:1886-1950, workflow.py:877; ``azcopy`` for ak8s; a
``dbfs:/`` → ``/dbfs/`` path rewrite for databricks).  Here that axis is one
interface invoked at the save/read boundaries instead, so emr/ak8s stop
being silent no-ops without scattering cloud commands through the modules:

* ``staging_dir(path)`` — where to WRITE locally for a (possibly remote)
  configured path;
* ``push(local_file, dest_dir)`` — publish a staged file to the configured
  destination after writing;
* ``pull(src, local_file)`` — fetch a remote artifact (config files,
  pre-existing models) to a local path before reading.

``for_run_type`` resolves the store; third-party stores register with
``register_store`` (or ``ANOVOS_ARTIFACT_STORE=module:Class`` for an
out-of-tree default override).  Cloud stores invoke the same CLIs the
reference uses (aws/azcopy) — no SDK dependency — and raise loudly when the
CLI is absent rather than silently keeping artifacts local.  Commands are
built as ARGV LISTS and executed without a shell: a dataset path containing
spaces, globs or metacharacters is a single operand by construction, so it
can neither break the copy nor inject a command (the reference interpolates
raw paths into ``os.system`` strings).
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
from typing import Callable, Dict, List, Type


def _is_remote(path: str) -> bool:
    return "://" in str(path)


class ArtifactStore:
    """Local filesystem: configured paths ARE the destination."""

    name = "local"

    def __init__(self, auth_key: str = "NA"):
        self.auth_key = auth_key

    def staging_dir(self, path: str) -> str:
        """Local directory to write into for the configured ``path``."""
        return str(path)

    def push(self, local_file: str, dest_dir: str) -> None:
        """Publish a staged file; no-op when staging IS the destination."""

    def pull(self, src: str, local_file: str) -> str:
        """Fetch ``src`` for local reading; returns the readable path."""
        return str(src)

    def pull_dir(self, src_dir: str, local_dir: str) -> str:
        """Fetch a whole remote directory into ``local_dir`` for reading
        (reference report_generation.py:4053-4080 does the recursive
        ``aws s3 cp``/``azcopy`` into report_stats before reading).
        Returns the readable directory."""
        return str(src_dir)


class DatabricksStore(ArtifactStore):
    """dbfs:/ paths are fuse-mounted at /dbfs (reference utils.output_to_local)."""

    name = "databricks"

    def _map(self, path: str) -> str:
        p = str(path)
        if p.startswith("dbfs:/"):
            return "/dbfs/" + p[len("dbfs:/"):].lstrip("/")
        return p

    def staging_dir(self, path: str) -> str:
        return self._map(path)

    def pull(self, src: str, local_file: str) -> str:
        return self._map(src)

    def pull_dir(self, src_dir: str, local_dir: str) -> str:
        return self._map(src_dir)


class _ShellStore(ArtifactStore):
    """Staged writes + CLI copy, the reference's emr/ak8s mechanism."""

    staging_root = "report_stats"

    def staging_dir(self, path: str) -> str:
        if not _is_remote(path):
            return str(path)
        # stage under a stable local dir keyed by tail + full-path hash so
        # two remote dirs never collide — not even with the same last segment
        # (the reference stages everything in one flat "report_stats", which
        # silently mixes master/model paths)
        import hashlib

        p = str(path).rstrip("/")
        tail = p.rsplit("/", 1)[-1] or "artifacts"
        digest = hashlib.sha1(p.encode()).hexdigest()[:8]
        return os.path.join(self.staging_root, f"{tail}-{digest}")

    def _run(self, argv: List[str]) -> None:
        """Execute one CLI command.  ``argv`` is a list — there is NO shell
        between us and the binary, so operands with spaces/metacharacters
        are inert data (the quoting bug class cannot exist)."""
        subprocess.check_output(argv)


class S3Store(_ShellStore):
    """emr: ``aws s3 cp`` invocations (reference report_preprocessing.py:97-105)."""

    name = "emr"

    def push(self, local_file: str, dest_dir: str) -> None:
        if not _is_remote(dest_dir):
            return
        self._run(["aws", "s3", "cp", str(local_file),
                   str(dest_dir).rstrip("/") + "/"])

    def pull(self, src: str, local_file: str) -> str:
        if not _is_remote(src):
            return str(src)
        self._run(["aws", "s3", "cp", str(src), str(local_file)])
        return local_file

    def pull_dir(self, src_dir: str, local_dir: str) -> str:
        if not _is_remote(src_dir):
            return str(src_dir)
        os.makedirs(local_dir, exist_ok=True)
        self._run(["aws", "s3", "cp", "--recursive",
                   str(src_dir).rstrip("/") + "/", str(local_dir)])
        return local_dir


class AzureStore(_ShellStore):
    """ak8s: ``azcopy`` with the SAS auth token appended
    (reference report_preprocessing.py:107-119, utils.path_ak8s_modify)."""

    name = "ak8s"

    def _https(self, path: str) -> str:
        # wasbs://container@account.blob.core.windows.net/key →
        # https://account.blob.core.windows.net/container/key
        p = str(path)
        if p.startswith("wasbs://") and "@" in p:
            container, rest = p[len("wasbs://"):].split("@", 1)
            host, _, key = rest.partition("/")
            return f"https://{host}/{container}/{key}"
        return p

    def push(self, local_file: str, dest_dir: str) -> None:
        if not _is_remote(dest_dir):
            return
        dest = self._https(dest_dir).rstrip("/") + "/"
        self._run(["azcopy", "cp", str(local_file), dest + self.auth_key])

    def pull(self, src: str, local_file: str) -> str:
        if not _is_remote(src):
            return str(src)
        self._run(["azcopy", "cp", self._https(src) + self.auth_key, str(local_file)])
        return local_file

    def pull_dir(self, src_dir: str, local_dir: str) -> str:
        if not _is_remote(src_dir):
            return str(src_dir)
        os.makedirs(local_dir, exist_ok=True)
        # '/*' copies the directory CONTENTS into local_dir — bare azcopy
        # places the source dir as a CHILD of the destination (unlike
        # 'aws s3 cp --recursive'), which would bury the staged CSVs one
        # level too deep for the readers.  azcopy expands the '*' itself;
        # with no shell in between it reaches the binary verbatim.
        self._run([
            "azcopy", "cp", "--recursive",
            self._https(str(src_dir).rstrip("/")) + "/*" + self.auth_key,
            str(local_dir),
        ])
        return local_dir


class AsyncArtifactWriter:
    """Background write queue so artifact persistence overlaps compute.

    Stats CSVs, chart JSONs and intermediate checkpoints are pure host/disk
    work; queueing them on a small thread pool lets the workflow's next
    block start immediately.  Writes are keyed by the resource they produce
    (``stats:measures_of_counts``, ``charts:objects``, …):

    * ``submit(key, fn)`` — enqueue; in ``sync`` mode runs inline (the
      sequential executor's path stays the trivially ordered one).
    * ``wait(keys)`` — block until every write submitted under ``keys`` has
      landed, re-raising the first failure.  Consumers call this before
      READING a resource another node produced.
    * ``drain()`` — the single barrier: wait for everything outstanding and
      re-raise any failure.  Called before ``report_generation`` reads the
      master path and before ``main()`` returns, so an async write error
      can never be silently swallowed.

    Each write runs in a ``write:<key>`` tracer span and books
    ``artifact_writes_total`` and ``artifact_write_seconds``; ``wait`` and
    ``drain`` record ``artifact:wait`` and ``artifact:drain`` spans.  The
    JAX writer's cache-capture binding waits for the node cache
    (ROADMAP.md Queue A item 1).
    """

    def __init__(self, workers: int = 2, sync: bool = False):
        self._sync = sync or workers < 1
        self._lock = threading.Lock()
        self._pending: Dict[str, List] = {}
        self._pool = None
        self._workers = max(1, workers)

    def _ensure_pool(self):
        # lock the check-then-create: two concurrent first submits (fanout
        # nodes under the concurrent executor) would otherwise each build a
        # pool and orphan one of them past close()'s shutdown
        with self._lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=self._workers, thread_name_prefix="artifact-writer"
                )
            return self._pool

    @staticmethod
    def _instrumented(key: str, fn: Callable, args, kwargs):
        """Run one write inside its span and metrics booking (the writer
        thread's lane in the Chrome trace shows what it wrote)."""
        from anovos_tpu_torch.obs import get_metrics, get_tracer

        t0 = time.perf_counter()
        with get_tracer().span(f"write:{key}", cat="artifact", key=key):
            out = fn(*args, **kwargs)
        reg = get_metrics()
        reg.counter("artifact_writes_total", "artifact writes queued+completed").inc(key=key)
        reg.histogram("artifact_write_seconds", "one artifact write's wall time"
                      ).observe(time.perf_counter() - t0, key=key)
        return out

    def submit(self, key: str, fn: Callable, *args, **kwargs) -> None:
        if self._sync:
            self._instrumented(key, fn, args, kwargs)
            return
        fut = self._ensure_pool().submit(self._instrumented, key, fn, args, kwargs)
        with self._lock:
            self._pending.setdefault(key, []).append(fut)

    def wait(self, keys) -> None:
        with self._lock:
            futs = [f for k in keys for f in self._pending.get(k, ())]
        if not futs:
            return
        from anovos_tpu_torch.obs import get_tracer

        with get_tracer().span("artifact:wait", cat="artifact", keys=list(keys), pending=len(futs)):
            for f in futs:
                f.result()  # re-raises the write's exception with its traceback

    def drain(self) -> None:
        with self._lock:
            futs = [f for fl in self._pending.values() for f in fl]
        from anovos_tpu_torch.obs import get_tracer

        with get_tracer().span("artifact:drain", cat="artifact", pending=len(futs)):
            for f in futs:
                f.result()
        with self._lock:  # all landed: forget completed tickets
            for k in list(self._pending):
                self._pending[k] = [f for f in self._pending[k] if not f.done()]

    def close(self) -> None:
        """Drain best-effort and release the pool threads."""
        try:
            self.drain()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None


_REGISTRY: Dict[str, Type[ArtifactStore]] = {
    "local": ArtifactStore,
    "databricks": DatabricksStore,
    "emr": S3Store,
    "ak8s": AzureStore,
}


def register_store(name: str, cls: Type[ArtifactStore]) -> None:
    """Plug in a store for a run_type (tests use a tmpdir-backed fake)."""
    _REGISTRY[name] = cls


def for_run_type(run_type: str, auth_key: str = "NA") -> ArtifactStore:
    override = os.environ.get("ANOVOS_ARTIFACT_STORE")
    if override:
        mod, _, cls = override.partition(":")
        import importlib

        return getattr(importlib.import_module(mod), cls)(auth_key)
    if run_type not in _REGISTRY:
        raise ValueError(
            f"Invalid run_type {run_type!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[run_type](auth_key)
