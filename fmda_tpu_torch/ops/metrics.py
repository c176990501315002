"""Multi-label classification metrics on tensors.

Semantics match sklearn's, as ``fmda_tpu.ops.metrics`` does:

- ``subset_accuracy``      == ``accuracy_score`` (exact-match ratio)
- ``hamming_loss``         == ``hamming_loss``
- ``fbeta_score``          == ``fbeta_score(average=None)``, 0/0 -> 0
- ``multilabel_confusion`` == ``multilabel_confusion_matrix``

Every function takes an optional ``example_mask`` (B,) so padded rows do
not count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def threshold_predictions(
    logits: torch.Tensor, threshold: float = 0.5
) -> torch.Tensor:
    """Logits -> boolean label predictions (sigmoid > threshold)."""
    return torch.sigmoid(logits) > threshold


def _example_weights(
    pred: torch.Tensor, example_mask: Optional[torch.Tensor]
) -> torch.Tensor:
    if example_mask is None:
        return torch.ones(pred.shape[0], dtype=torch.float32,
                          device=pred.device)
    return example_mask.to(torch.float32)


def subset_accuracy(pred, target, example_mask=None) -> torch.Tensor:
    """Exact-match ratio over (valid) examples."""
    w = _example_weights(pred, example_mask)
    correct = (pred.bool() == target.bool()).all(dim=-1).to(torch.float32)
    return (correct * w).sum() / w.sum().clamp_min(1.0)


def hamming_loss(pred, target, example_mask=None) -> torch.Tensor:
    """Fraction of wrong labels over (valid) examples."""
    w = _example_weights(pred, example_mask)
    wrong = (pred.bool() != target.bool()).to(torch.float32).mean(dim=-1)
    return (wrong * w).sum() / w.sum().clamp_min(1.0)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def _counts(pred, target, example_mask):
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    w = _example_weights(pred, example_mask)[:, None]
    tp = (w * pred * target).sum(dim=0)
    fp = (w * pred * (1.0 - target)).sum(dim=0)
    fn = (w * (1.0 - pred) * target).sum(dim=0)
    tn = (w * (1.0 - pred) * (1.0 - target)).sum(dim=0)
    return tp, fp, fn, tn


def fbeta_score(pred, target, beta: float = 0.5,
                example_mask=None) -> torch.Tensor:
    """Per-class F-beta over the batch; shape (n_classes,)."""
    tp, fp, fn, _ = _counts(pred, target, example_mask)
    precision = _safe_div(tp, tp + fp)
    recall = _safe_div(tp, tp + fn)
    b2 = beta * beta
    return _safe_div((1.0 + b2) * precision * recall, b2 * precision + recall)


def multilabel_confusion(pred, target, example_mask=None) -> torch.Tensor:
    """Per-class 2x2 confusion matrices (n_classes, 2, 2) of int32, laid
    out [[tn, fp], [fn, tp]]."""
    tp, fp, fn, tn = _counts(pred, target, example_mask)
    return torch.stack(
        [torch.stack([tn, fp], dim=-1), torch.stack([fn, tp], dim=-1)],
        dim=-2,
    ).to(torch.int32)


class MultilabelMetrics(NamedTuple):
    accuracy: torch.Tensor
    hamming: torch.Tensor
    fbeta: torch.Tensor  # (n_classes,)
    confusion: torch.Tensor  # (n_classes, 2, 2)


def multilabel_metrics(
    logits: torch.Tensor,
    target: torch.Tensor,
    *,
    threshold: float = 0.5,
    beta: float = 0.5,
    example_mask: Optional[torch.Tensor] = None,
) -> MultilabelMetrics:
    """All batch metrics from logits and {0,1} targets."""
    pred = threshold_predictions(logits, threshold)
    return MultilabelMetrics(
        accuracy=subset_accuracy(pred, target, example_mask),
        hamming=hamming_loss(pred, target, example_mask),
        fbeta=fbeta_score(pred, target, beta, example_mask),
        confusion=multilabel_confusion(pred, target, example_mask),
    )
