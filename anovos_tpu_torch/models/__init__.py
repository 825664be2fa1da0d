"""Models trained on the card (counterpart of ``anovos_tpu/models``)."""

from anovos_tpu_torch.models.autoencoder import AutoEncoder  # noqa: F401
