"""Host-side streaming metric vocabulary shared by trainer and server,
as ``fmda_tpu.eval.metrics`` defines it.

One numpy implementation of the paper's multi-label metrics (subset
accuracy, Hamming loss, per-label F-beta, per-label 2x2 confusion) for
both sides of the offline/online seam: the trainer's reports
(:mod:`fmda_tpu_torch.train.reports`) fold a :class:`StreamingCounts`
over eval batches, and an online label-join evaluator folds the same
counters as labels arrive.

Semantics are those of :mod:`fmda_tpu_torch.ops.metrics`: exact-match
ratio, mean wrong-label fraction, F-beta with the 0/0 -> 0 convention,
confusion laid out ``[[tn, fp], [fn, tp]]``.  The streaming decomposition
is exact, not approximate: every metric here is a ratio of sums.

One difference from ``ops.metrics``: the serving tier publishes
**probabilities** (the sigmoid already applied), so
:func:`threshold_probs` compares them to the threshold directly.

numpy only.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def threshold_probs(probs: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Published probabilities -> boolean label predictions."""
    return np.asarray(probs, np.float32) > float(threshold)


def _safe_div(num, den):
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    return np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)


class StreamingCounts:
    """Exact streaming decomposition of the batch metrics.

    Accumulates sufficient statistics (examples, exact matches, wrong
    label slots, per-label tp/fp/fn/tn) so that every derived metric
    equals the batch computation over the concatenation of all updates.
    """

    __slots__ = ("n_labels", "n", "exact", "wrong", "tp", "fp", "fn", "tn")

    def __init__(self, n_labels: int) -> None:
        if n_labels <= 0:
            raise ValueError(f"n_labels must be positive, got {n_labels}")
        self.n_labels = int(n_labels)
        self.n = 0
        self.exact = 0
        self.wrong = 0  # wrong label slots, over n * n_labels total
        self.tp = np.zeros(n_labels, np.int64)
        self.fp = np.zeros(n_labels, np.int64)
        self.fn = np.zeros(n_labels, np.int64)
        self.tn = np.zeros(n_labels, np.int64)

    # -- accumulation --------------------------------------------------------

    def update(self, pred: np.ndarray, target: np.ndarray) -> None:
        """Fold a batch of boolean (B, n_labels) predictions/targets."""
        pred = np.atleast_2d(np.asarray(pred, bool))
        target = np.atleast_2d(np.asarray(target, bool))
        if pred.shape != target.shape or pred.shape[1] != self.n_labels:
            raise ValueError(
                f"shape mismatch: pred {pred.shape} target {target.shape} "
                f"n_labels {self.n_labels}")
        eq = pred == target
        self.n += pred.shape[0]
        self.exact += int(np.sum(np.all(eq, axis=1)))
        self.wrong += int(np.sum(~eq))
        self.tp += np.sum(pred & target, axis=0)
        self.fp += np.sum(pred & ~target, axis=0)
        self.fn += np.sum(~pred & target, axis=0)
        self.tn += np.sum(~pred & ~target, axis=0)

    def merge(self, other: "StreamingCounts") -> None:
        if other.n_labels != self.n_labels:
            raise ValueError("cannot merge counts with different n_labels")
        self.n += other.n
        self.exact += other.exact
        self.wrong += other.wrong
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn
        self.tn += other.tn

    # -- derived metrics -----------------------------------------------------

    @property
    def subset_accuracy(self) -> float:
        return self.exact / self.n if self.n else 0.0

    @property
    def hamming_loss(self) -> float:
        return self.wrong / (self.n * self.n_labels) if self.n else 0.0

    def fbeta(self, beta: float = 0.5) -> np.ndarray:
        """Per-label F-beta, 0/0 -> 0 like the jnp/sklearn reference."""
        precision = _safe_div(self.tp, self.tp + self.fp)
        recall = _safe_div(self.tp, self.tp + self.fn)
        b2 = float(beta) * float(beta)
        return np.asarray(_safe_div(
            (1.0 + b2) * precision * recall, b2 * precision + recall),
            np.float64)

    def confusion(self) -> np.ndarray:
        """(n_labels, 2, 2) int64 laid out [[tn, fp], [fn, tp]]."""
        return np.stack([
            np.stack([self.tn, self.fp], axis=-1),
            np.stack([self.fn, self.tp], axis=-1),
        ], axis=-2)

    def summary(self, beta: float = 0.5) -> Dict[str, object]:
        return {
            "n": self.n,
            "subset_accuracy": self.subset_accuracy,
            "hamming_loss": self.hamming_loss,
            "fbeta": [float(x) for x in self.fbeta(beta)],
        }


def batch_counts(
    probs: np.ndarray,
    target: np.ndarray,
    *,
    threshold: float = 0.5,
    n_labels: Optional[int] = None,
) -> StreamingCounts:
    """One-shot batch fold: probabilities + boolean targets -> counts."""
    probs = np.atleast_2d(np.asarray(probs, np.float32))
    counts = StreamingCounts(n_labels or probs.shape[1])
    counts.update(threshold_probs(probs, threshold),
                  np.atleast_2d(np.asarray(target)).astype(bool))
    return counts
