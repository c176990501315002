from typing import Optional

import torch

from fmda_tpu_torch.models.bigru import BiGRU


def build_model(cfg, *, generator: Optional[torch.Generator] = None):
    """The ``ModelConfig.cell`` -> module factory of the Trainer, the
    Predictor and the backtester.  Only ``"gru"`` is ported;
    ``ModelConfig`` refuses the other cells."""
    if cfg.cell != "gru":
        raise NotImplementedError(
            f"cell={cfg.cell!r} is not ported yet; see ROADMAP.md, queue 1")
    return BiGRU(cfg, generator=generator)


__all__ = ["BiGRU", "build_model"]
