"""Losses and class-imbalance weighting, as ``fmda_tpu.train.losses``:
``BCEWithLogitsLoss(weight=N/n_c, pos_weight=(N-n_c)/n_c)`` with optional
padded-example masking (fixed-shape batches pad the tail; padded rows must
not contribute)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def class_weights(
    label_counts: np.ndarray, n_examples: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class (weight, pos_weight) from positive-label counts:
    ``weight_c = N / n_c``, ``pos_weight_c = (N - n_c) / n_c``."""
    counts = np.asarray(label_counts, np.float64)
    weight = n_examples / counts
    pos_weight = (n_examples - counts) / counts
    return weight.astype(np.float32), pos_weight.astype(np.float32)


def _per_element(logits, targets, weight, pos_weight):
    targets = targets.to(logits.dtype)
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    pw = pos_weight if pos_weight is not None else 1.0
    per_elem = -(pw * targets * log_p + (1.0 - targets) * log_not_p)
    if weight is not None:
        per_elem = per_elem * weight
    return per_elem


def weighted_bce_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    weight: Optional[torch.Tensor] = None,
    pos_weight: Optional[torch.Tensor] = None,
    example_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean weighted binary cross-entropy on logits (torch semantics):
    ``l = -w * [pw * y * log(sigmoid(x)) + (1-y) * log(1 - sigmoid(x))]``
    averaged over the valid elements, ``sum / max(valid_rows * C, 1)``."""
    per_elem = _per_element(logits, targets, weight, pos_weight)
    if example_mask is None:
        return per_elem.mean()
    m = example_mask.to(per_elem.dtype)[:, None]
    denom = (m.sum() * per_elem.shape[-1]).clamp_min(1.0)
    return (per_elem * m).sum() / denom


def weighted_bce_sums(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    weight: Optional[torch.Tensor] = None,
    pos_weight: Optional[torch.Tensor] = None,
    example_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unnormalized (loss_sum, element_count) for gradient accumulation.

    The masked mean above has a global normalizer, so microbatches cannot
    average their own means; summing these and dividing once by
    ``max(count, 1)`` gives the full-batch loss (and, the gradient being
    linear, the full-batch gradient) up to float re-association.
    """
    per_elem = _per_element(logits, targets, weight, pos_weight)
    if example_mask is None:
        n = float(per_elem.shape[0] * per_elem.shape[-1])
        return per_elem.sum(), torch.tensor(n, dtype=per_elem.dtype,
                                            device=per_elem.device)
    m = example_mask.to(per_elem.dtype)[:, None]
    return (per_elem * m).sum(), m.sum() * per_elem.shape[-1]
