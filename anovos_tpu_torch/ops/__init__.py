"""Tensor kernels of the port: moments, quantiles, description, drift
histograms, and the hand-written CUDA kernels under ``kernels/``."""
