"""Package version (counterpart of ``anovos_tpu/version.py``; reference:
src/main/anovos/version.py:1).  The run manifest's ``env`` section records
it as ``code_version``."""

__version__ = "0.1.0"
