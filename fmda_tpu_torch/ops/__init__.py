"""Tensor ops of the port: the GRU and LSTM projections and scans, the
SSM's scans and serve tick, multi-head attention and its flash op (with
their CUDA kernels), the technical indicators (numpy) and the multi-label
metrics."""
