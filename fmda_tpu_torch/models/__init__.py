from typing import Optional

import torch

from fmda_tpu_torch.models.bigru import BiGRU
from fmda_tpu_torch.models.bilstm import BiLSTM

#: The ported ``ModelConfig.cell`` families.
CELLS = {"gru": BiGRU, "lstm": BiLSTM}


def build_model(cfg, *, generator: Optional[torch.Generator] = None):
    """The ``ModelConfig.cell`` -> module factory of the Trainer, the
    Predictor and the backtester.  ``"gru"`` and ``"lstm"`` are ported;
    ``ModelConfig`` refuses the other cells."""
    if cfg.cell not in CELLS:
        raise NotImplementedError(
            f"cell={cfg.cell!r} is not ported yet; see ROADMAP.md, queue 1")
    return CELLS[cfg.cell](cfg, generator=generator)


__all__ = ["BiGRU", "BiLSTM", "CELLS", "build_model"]
