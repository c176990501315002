from fmda_tpu_torch.serve.backtest import (
    BacktestResult,
    LabelStats,
    backtest,
    backtest_from_checkpoint,
    trading_summary,
)
from fmda_tpu_torch.serve.predictor import (
    Prediction,
    Predictor,
    labels_over_threshold,
    make_batched_forward,
    prediction_message,
)
from fmda_tpu_torch.serve.streaming import (
    StreamingBiGRU,
    StreamingBiGRUBidirectional,
    StreamingPredictor,
)

__all__ = [
    "BacktestResult", "LabelStats", "Prediction", "Predictor",
    "StreamingBiGRU", "StreamingBiGRUBidirectional", "StreamingPredictor",
    "backtest", "backtest_from_checkpoint", "labels_over_threshold",
    "make_batched_forward", "prediction_message", "trading_summary",
]
