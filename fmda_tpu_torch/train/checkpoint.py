"""The port's checkpoint: one ``torch.save`` file per step.

It holds the model's ``state_dict``, the step and the normalization
stats, so serving loads weights and stats from one artifact; saved from a
:class:`~fmda_tpu_torch.train.trainer.TrainState` it also holds the
optimizer's ``state_dict`` and the dropout generator's state, so training
resumes exactly (``Trainer.restore_state``).  Files of the weights-only
format ``fmda_tpu_torch.checkpoint/1`` still load for serving.

This is the port's own format; the JAX package's Orbax checkpoints need
JAX to read.  Weights trained there come across through
:mod:`fmda_tpu_torch.interop` instead.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from fmda_tpu_torch.data.normalize import NormParams

FORMAT = "fmda_tpu_torch.checkpoint/2"
#: formats :func:`restore_checkpoint` reads: /1 lacks the training state
READABLE_FORMATS = ("fmda_tpu_torch.checkpoint/1", FORMAT)


def save_checkpoint(
    directory: str,
    state: Any,
    norm_params: Optional[NormParams] = None,
    *,
    step: Optional[int] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write ``step_<step>.pt`` under ``directory``; returns its path.

    ``state`` is a ``TrainState`` (params, optimizer, step and dropout
    stream are saved; ``step`` defaults to its step) or a ``state_dict``
    mapping (weights only; ``step`` defaults to 0).
    """
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    tree: Dict[str, Any] = {"format": FORMAT}
    if isinstance(state, Mapping):
        params = state
        step = 0 if step is None else step
    else:
        params = state.model.state_dict()
        step = state.step if step is None else step
        tree["opt_state"] = state.optimizer.state_dict()
        tree["rng_state"] = state.generator.get_state()
        tree["rng_device"] = state.generator.device.type
    tree["params"] = {k: v.detach().cpu() for k, v in params.items()}
    tree["step"] = int(step)
    if norm_params is not None:
        tree["norm"] = {
            "x_min": torch.from_numpy(np.asarray(norm_params.x_min, np.float32)),
            "x_max": torch.from_numpy(np.asarray(norm_params.x_max, np.float32)),
        }
    if extra:
        tree["extra"] = extra
    path = os.path.join(directory, f"step_{int(step):08d}.pt")
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str) -> Tuple[Dict[str, Any], Optional[NormParams]]:
    """Read a checkpoint; returns (tree, norm_params-or-None), the tree's
    ``params`` being the ``state_dict`` on the CPU.  A training checkpoint
    also has ``opt_state``, ``rng_state`` and ``rng_device``."""
    tree = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
    if tree.get("format") not in READABLE_FORMATS:
        raise ValueError(f"{path} is not an fmda_tpu_torch checkpoint")
    norm = None
    if tree.get("norm") is not None:
        norm = NormParams(tree["norm"]["x_min"].numpy(),
                          tree["norm"]["x_max"].numpy())
    return tree, norm


def latest_checkpoint(directory: str) -> Optional[str]:
    """Most recent ``step_*.pt`` under a directory."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and d.endswith(".pt"))
    return os.path.join(directory, steps[-1]) if steps else None
