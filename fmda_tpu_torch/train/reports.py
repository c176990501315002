"""Training reports: per-epoch and per-label tables, learning curves and
confusion heatmaps, as ``fmda_tpu.train.reports`` renders them.

The tables are markdown strings over the history and the
:class:`~fmda_tpu_torch.eval.metrics.StreamingCounts` that the
:class:`~fmda_tpu_torch.train.trainer.Trainer` returns or that an
evaluation folds.  The plots write PNG/SVG files; matplotlib is imported
lazily inside them and is not a dependency of the package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from fmda_tpu_torch.config import TARGET_COLUMNS
from fmda_tpu_torch.eval.metrics import StreamingCounts, batch_counts


def history_table(history: Dict[str, List]) -> str:
    """Markdown table of per-epoch train/val metrics."""
    lines = [
        "| epoch | train loss | train acc | train Hamming | val acc | val Hamming |",
        "|---|---|---|---|---|---|",
    ]
    for i, (tr, va) in enumerate(zip(history["train"], history["val"])):
        lines.append(
            f"| {i + 1} | {tr.loss:.4f} | {tr.accuracy:.4f} | "
            f"{tr.hamming:.4f} | {va.accuracy:.4f} | {va.hamming:.4f} |"
        )
    return "\n".join(lines)


def offline_quality(
    probabilities: np.ndarray,
    targets: np.ndarray,
    *,
    threshold: float = 0.5,
) -> StreamingCounts:
    """Fold a whole offline evaluation split into the sufficient
    statistics a live label-join evaluator accumulates
    (:class:`~fmda_tpu_torch.eval.metrics.StreamingCounts`), so an
    offline report and an online one cannot disagree on what a metric
    means: one numpy vocabulary, two call sites."""
    return batch_counts(probabilities, targets, threshold=threshold)


def quality_table(
    counts: StreamingCounts,
    labels: Sequence[str] = TARGET_COLUMNS,
    *,
    beta: float = 0.5,
    title: Optional[str] = None,
) -> str:
    """Markdown quality report over shared streaming counts.

    Renders whatever a :class:`StreamingCounts` holds — an offline split
    folded by :func:`offline_quality` or a snapshot pulled from the live
    evaluator's per-version accumulators — so the offline and online
    reports are the same table over the same arithmetic.
    """
    summary = counts.summary(beta)
    confusion = counts.confusion()
    lines = []
    if title:
        lines.append(f"**{title}** — n={summary['n']}, "
                     f"subset accuracy {summary['subset_accuracy']:.4f}, "
                     f"Hamming loss {summary['hamming_loss']:.4f}")
        lines.append("")
    lines += [
        f"| label | F{beta:g} | tp | fp | fn | tn |",
        "|---|---|---|---|---|---|",
    ]
    for i, label in enumerate(labels):
        (tn, fp), (fn, tp) = confusion[i]
        lines.append(
            f"| {label} | {summary['fbeta'][i]:.4f} | {int(tp)} | "
            f"{int(fp)} | {int(fn)} | {int(tn)} |"
        )
    return "\n".join(lines)


def plot_history(history: Dict[str, List], path: str) -> str:
    """Learning curves (loss, subset accuracy, Hamming loss) to ``path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = np.arange(1, len(history["train"]) + 1)
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))
    axes[0].plot(epochs, [m.loss for m in history["train"]], label="train")
    axes[0].plot(epochs, [m.loss for m in history["val"]], label="val")
    axes[0].set_title("weighted BCE loss")
    axes[1].plot(epochs, [m.accuracy for m in history["train"]], label="train")
    axes[1].plot(epochs, [m.accuracy for m in history["val"]], label="val")
    axes[1].set_title("subset accuracy")
    axes[2].plot(epochs, [m.hamming for m in history["train"]], label="train")
    axes[2].plot(epochs, [m.hamming for m in history["val"]], label="val")
    axes[2].set_title("Hamming loss")
    for ax in axes:
        ax.set_xlabel("epoch")
        ax.grid(True, alpha=0.3)
        ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_confusion(
    confusion: np.ndarray,
    path: str,
    labels: Sequence[str] = TARGET_COLUMNS,
) -> str:
    """Per-label 2x2 confusion heatmaps.

    ``confusion``: (n_labels, 2, 2) as returned by ``Trainer.evaluate``.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(labels)
    fig, axes = plt.subplots(1, n, figsize=(3.2 * n, 3.2))
    if n == 1:
        axes = [axes]
    for ax, label, cm in zip(axes, labels, confusion):
        ax.imshow(cm, cmap="Blues")
        for i in range(2):
            for j in range(2):
                ax.text(j, i, f"{int(cm[i, j])}", ha="center", va="center",
                        color="black")
        ax.set_title(label)
        ax.set_xticks([0, 1], ["pred 0", "pred 1"])
        ax.set_yticks([0, 1], ["true 0", "true 1"])
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
