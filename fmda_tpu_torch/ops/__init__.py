"""Tensor ops of the port: GRU projection and scan (with its CUDA kernel),
the technical indicators (numpy) and the multi-label metrics."""
