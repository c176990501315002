"""fmda_tpu_torch: the PyTorch/CUDA port of ``fmda_tpu`` for NVIDIA Hopper.

This package stands beside ``fmda_tpu`` (the JAX reference) and imports
none of it.  The ported slice is the BiGRU window-re-scan serving path:

    warehouse (SQLite) -> normalization -> BiGRU -> Predictor / backtest

with the GRU recurrence in a hand-written CUDA kernel
(``csrc/gru_scan.cu``, bound in :mod:`fmda_tpu_torch.ops.gru_kernel`).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from fmda_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
