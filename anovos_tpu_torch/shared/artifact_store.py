"""Pluggable artifact stores for the ``run_type`` deployment axis (the
port's own copy of ``anovos_tpu/shared/artifact_store.py``; the port's
runner writes synchronously, so the JAX package's async write queue is
not copied).

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
from typing import Dict, List, Type


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
