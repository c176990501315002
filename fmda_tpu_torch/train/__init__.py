from fmda_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from fmda_tpu_torch.train.continuous import (
    ContinuousTrainer,
    TailSource,
    gateway_publisher,
    router_publisher,
)
from fmda_tpu_torch.train.losses import (
    class_weights,
    weighted_bce_sums,
    weighted_bce_with_logits,
)
from fmda_tpu_torch.train.multiticker import MultiTickerDataset
from fmda_tpu_torch.train.trainer import (
    EpochMetrics,
    Trainer,
    TrainState,
    clip_by_global_norm,
    imbalance_weights_from_source,
)

__all__ = [
    "ContinuousTrainer", "EpochMetrics", "MultiTickerDataset", "TailSource",
    "TrainState", "Trainer", "class_weights", "clip_by_global_norm",
    "gateway_publisher", "imbalance_weights_from_source",
    "latest_checkpoint", "restore_checkpoint", "router_publisher",
    "save_checkpoint", "weighted_bce_sums", "weighted_bce_with_logits",
]
