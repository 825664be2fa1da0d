"""PyTorch/CUDA port of anovos_tpu: the same public functions and
artifacts, on torch tensors on one NVIDIA Hopper GPU (or the CPU, when the
caller asks for it).  The JAX package ``anovos_tpu`` is its reference."""
