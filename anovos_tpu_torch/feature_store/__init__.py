"""Feast feature-store export (counterpart of ``anovos_tpu/feature_store/``)."""
