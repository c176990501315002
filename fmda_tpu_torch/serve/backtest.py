"""Backtesting: score a model over warehoused history, exactly as serving
would see each row (trailing window, the training norm stats), against the
realized ATR-scaled movement labels."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from fmda_tpu_torch.config import TARGET_COLUMNS, ModelConfig
from fmda_tpu_torch.data.normalize import NormParams, normalize
from fmda_tpu_torch.data.source import FeatureSource
from fmda_tpu_torch.data.windows import window_index_matrix
from fmda_tpu_torch.device import DeviceLike, resolve_device
from fmda_tpu_torch.ops.metrics import MultilabelMetrics, multilabel_metrics
from fmda_tpu_torch.serve.predictor import load_model


@dataclass(frozen=True)
class BacktestResult:
    metrics: MultilabelMetrics  # of numpy arrays
    probabilities: np.ndarray  # (n_served, n_classes)
    targets: np.ndarray  # (n_served, n_classes)
    first_row_id: int  # first servable row (1-based)
    threshold: float = 0.5


def backtest(
    source: FeatureSource,
    model_cfg: ModelConfig,
    params: Mapping[str, torch.Tensor],
    norm: NormParams,
    *,
    window: int,
    threshold: float = 0.5,
    beta: float = 0.5,
    batch_size: int = 256,
    ids: Optional[Tuple[int, int]] = None,
    device: DeviceLike = None,
) -> BacktestResult:
    """Serve every row of ``source`` (or the inclusive 1-based id range
    ``ids``) with the trailing-window model in batches of ``batch_size``
    and score against the realized labels."""
    device = resolve_device(device)
    n = len(source)
    if ids is not None:
        lo, hi = ids
        if lo < window:
            raise ValueError(
                f"ids lower bound {lo} has no full trailing window "
                f"(first servable row is {window})")
    else:
        lo, hi = window, n
    if hi > n or lo > hi:
        raise ValueError(f"id range [{lo}, {hi}] invalid for source of {n} rows")

    model = load_model(model_cfg, params, device)
    # one gather covers all windows: rows [lo - window + 1, hi], normalized
    # on the host
    rows = normalize(source.fetch(range(lo - window + 1, hi + 1)), norm)
    widx = window_index_matrix(len(rows), window)
    targets = source.fetch_targets(range(lo, hi + 1))

    with torch.inference_mode():
        batches = [
            model(torch.from_numpy(rows[widx[s:s + batch_size]]).to(device))
            for s in range(0, len(widx), batch_size)
        ]
        logits = (torch.cat(batches).cpu() if batches
                  else torch.zeros((0, model_cfg.output_size)))
        metrics = multilabel_metrics(
            logits, torch.from_numpy(targets), threshold=threshold, beta=beta)
        probabilities = torch.sigmoid(logits).numpy()
    return BacktestResult(
        metrics=MultilabelMetrics(*(m.numpy() for m in metrics)),
        probabilities=probabilities,
        targets=np.asarray(targets),
        first_row_id=lo,
        threshold=threshold,
    )


@dataclass(frozen=True)
class LabelStats:
    signals: int  # predictions fired (prob > threshold)
    hits: int  # fired and the movement happened
    precision: float  # hits / signals (0 when no signals)
    recall: float  # hits / realized movements
    base_rate: float  # realized movement frequency
    edge: float  # precision - base_rate: > 0 = better than always firing


def trading_summary(
    result: BacktestResult,
    *,
    threshold: Optional[float] = None,
    labels: Tuple[str, ...] = TARGET_COLUMNS,
) -> dict:
    """Signal quality per label and ``overall``: when the model fires, how
    often is it right, and is that better than the label's base rate?"""
    if threshold is None:
        threshold = result.threshold
    if len(labels) != result.targets.shape[1]:
        raise ValueError(
            f"{len(labels)} labels for {result.targets.shape[1]}-class targets")
    pred = result.probabilities > threshold
    target = result.targets > 0.5
    out = {}
    total_signals = total_hits = total_pos = 0
    for i, label in enumerate(labels):
        signals = int(pred[:, i].sum())
        hits = int((pred[:, i] & target[:, i]).sum())
        pos = int(target[:, i].sum())
        precision = hits / signals if signals else 0.0
        base_rate = pos / len(target) if len(target) else 0.0
        out[label] = LabelStats(
            signals=signals, hits=hits, precision=precision,
            recall=hits / pos if pos else 0.0, base_rate=base_rate,
            edge=precision - base_rate)
        total_signals += signals
        total_hits += hits
        total_pos += pos
    n_cells = len(target) * len(labels)
    precision = total_hits / total_signals if total_signals else 0.0
    base_rate = total_pos / n_cells if n_cells else 0.0
    out["overall"] = LabelStats(
        signals=total_signals, hits=total_hits, precision=precision,
        recall=total_hits / total_pos if total_pos else 0.0,
        base_rate=base_rate, edge=precision - base_rate)
    return out


def backtest_from_checkpoint(
    source: FeatureSource,
    checkpoint_path: str,
    model_cfg: ModelConfig,
    *,
    window: int,
    **kwargs,
) -> BacktestResult:
    from fmda_tpu_torch.train.checkpoint import restore_checkpoint

    tree, norm = restore_checkpoint(checkpoint_path)
    if norm is None:
        raise ValueError(f"checkpoint {checkpoint_path} has no norm stats")
    return backtest(source, model_cfg, tree["params"], norm, window=window,
                    **kwargs)
