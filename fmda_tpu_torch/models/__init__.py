from typing import Optional

import torch

from fmda_tpu_torch.models.bigru import BiGRU, BiGRUState
from fmda_tpu_torch.models.bilstm import BiLSTM, BiLSTMState
from fmda_tpu_torch.models.ssm import GatedSSM, SSMState

#: The ported ``ModelConfig.cell`` families.
CELLS = {"gru": BiGRU, "lstm": BiLSTM, "ssm": GatedSSM}


def build_model(cfg, *, generator: Optional[torch.Generator] = None):
    """The ``ModelConfig.cell`` -> module factory of the Trainer, the
    Predictor and the backtester.  ``"gru"``, ``"lstm"`` and ``"ssm"`` are
    ported; ``ModelConfig`` refuses the other cells."""
    if cfg.cell not in CELLS:
        raise NotImplementedError(
            f"cell={cfg.cell!r} is not ported yet; see ROADMAP.md, queue 1")
    return CELLS[cfg.cell](cfg, generator=generator)


__all__ = ["BiGRU", "BiGRUState", "BiLSTM", "BiLSTMState", "CELLS",
           "GatedSSM", "SSMState", "build_model"]
