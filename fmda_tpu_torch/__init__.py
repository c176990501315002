"""fmda_tpu_torch: the PyTorch/CUDA port of ``fmda_tpu`` for NVIDIA Hopper.

This package stands beside ``fmda_tpu`` (the JAX reference) and imports
none of it.  The ported slices are the data plane (the acquisition layer,
the streaming engine and its journal, the synthetic corpus), the
window-re-scan serving path and the training path of every model family
(``ModelConfig.cell`` "gru", "lstm", "ssm" or "attn"), and carried-state
streaming serving of the three recurrent ones:

    feeds -> bus -> StreamEngine (features, join) -> warehouse (SQLite)
    warehouse -> normalization -> model -> Predictor / backtest
    warehouse -> chunked windows -> Trainer.fit -> checkpoint -> backtest
    warehouse -> StreamingBiGRU(Bidirectional) -> StreamingPredictor
    rows of many sessions -> SessionPool (one flush a micro-batch)
    history -> ReplayDriver -> FleetGateway (a backfill on a virtual clock)

with each recurrence's forward and backward scans, the SSM's serve tick
and the flash-attention forward and backward sweeps in hand-written CUDA
kernels (``csrc/gru_scan.cu``, ``csrc/lstm_scan.cu``, ``csrc/ssm_step.cu``
and ``csrc/flash_attn.cu``, bound in :mod:`fmda_tpu_torch.ops.gru_kernel`,
:mod:`fmda_tpu_torch.ops.lstm_kernel`, :mod:`fmda_tpu_torch.ops.ssm_kernel`
and :mod:`fmda_tpu_torch.ops.attention_kernel`).  Entry points run on the card
unless the caller passes ``device="cpu"``.  :class:`~fmda_tpu_torch.app.
Application` composes the stack from one config (the native C++ ring bus
and join scheduler when they build).
"""

from fmda_tpu_torch._lazy import lazy_exports

#: lazy: the composition root pulls in the streaming stack, and the device
#: helpers pull in torch; a router-role process (bus only, no card)
#: imports the package without either
_EXPORTS = {
    "Application": "fmda_tpu_torch.app",
    "resolve_device": "fmda_tpu_torch.device",
}

__all__ = sorted(_EXPORTS)

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
