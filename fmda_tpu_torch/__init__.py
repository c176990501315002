"""fmda_tpu_torch: the PyTorch/CUDA port of ``fmda_tpu`` for NVIDIA Hopper.

This package stands beside ``fmda_tpu`` (the JAX reference) and imports
none of it.  The ported slices are the window-re-scan serving path and the
training path of every model family (``ModelConfig.cell`` "gru", "lstm",
"ssm" or "attn"), and carried-state streaming serving of the three
recurrent ones:

    warehouse (SQLite) -> normalization -> model -> Predictor / backtest
    warehouse -> chunked windows -> Trainer.fit -> checkpoint -> backtest
    warehouse -> StreamingBiGRU(Bidirectional) -> StreamingPredictor
    rows of many sessions -> SessionPool (one flush a micro-batch)

with each recurrence's forward and backward scans, the SSM's serve tick
and the flash-attention forward and backward sweeps in hand-written CUDA
kernels (``csrc/gru_scan.cu``, ``csrc/lstm_scan.cu``, ``csrc/ssm_step.cu``
and ``csrc/flash_attn.cu``, bound in :mod:`fmda_tpu_torch.ops.gru_kernel`,
:mod:`fmda_tpu_torch.ops.lstm_kernel`, :mod:`fmda_tpu_torch.ops.ssm_kernel`
and :mod:`fmda_tpu_torch.ops.attention_kernel`).  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""

from fmda_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
