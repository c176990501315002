"""fmda_tpu_torch: the PyTorch/CUDA port of ``fmda_tpu`` for NVIDIA Hopper.

This package stands beside ``fmda_tpu`` (the JAX reference) and imports
none of it.  The ported slices are the window-re-scan serving path and the
training path of the BiGRU and BiLSTM (``ModelConfig.cell`` "gru" or
"lstm"):

    warehouse (SQLite) -> normalization -> model -> Predictor / backtest
    warehouse -> chunked windows -> Trainer.fit -> checkpoint -> backtest

with each recurrence's forward and backward scans in hand-written CUDA
kernels (``csrc/gru_scan.cu`` and ``csrc/lstm_scan.cu``, bound in
:mod:`fmda_tpu_torch.ops.gru_kernel` and
:mod:`fmda_tpu_torch.ops.lstm_kernel`).  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""

from fmda_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
