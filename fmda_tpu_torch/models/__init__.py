from typing import Optional

import torch

from fmda_tpu_torch.models.attn import TemporalTransformer
from fmda_tpu_torch.models.bigru import BiGRU, BiGRUState
from fmda_tpu_torch.models.bilstm import BiLSTM, BiLSTMState
from fmda_tpu_torch.models.ssm import GatedSSM, SSMState

#: The ported ``ModelConfig.cell`` families.
CELLS = {"gru": BiGRU, "lstm": BiLSTM, "ssm": GatedSSM,
         "attn": TemporalTransformer}


def build_model(cfg, *, generator: Optional[torch.Generator] = None):
    """The ``ModelConfig.cell`` -> module factory of the Trainer, the
    Predictor and the backtester."""
    if cfg.cell not in CELLS:
        raise ValueError(
            f"unknown ModelConfig.cell {cfg.cell!r}; expected one of "
            f"{sorted(CELLS)}")
    return CELLS[cfg.cell](cfg, generator=generator)


__all__ = ["BiGRU", "BiGRUState", "BiLSTM", "BiLSTMState", "CELLS",
           "GatedSSM", "SSMState", "TemporalTransformer", "build_model"]
