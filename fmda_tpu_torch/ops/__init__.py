"""Tensor ops of the port: the GRU and LSTM projections and scans and the
SSM's scans and serve tick (with their CUDA kernels), the technical
indicators (numpy) and the multi-label metrics."""
