from fmda_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["latest_checkpoint", "restore_checkpoint", "save_checkpoint"]
