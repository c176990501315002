"""Feature and prediction drift against a training-time reference
profile, as ``fmda_tpu.eval.drift`` defines it.

At train time a **reference profile** is written beside the checkpoint:
per-feature quantile bin edges with the training distribution's bin
frequencies, plus the training targets' per-label positive rates.  At
serve time a :class:`DriftMonitor` digitizes live feature rows into the
same bins and scores the divergence as **PSI** (population stability
index) per feature; the published predictions are scored the same way
against the label rates (each label a two-bin distribution).

PSI conventions: < 0.1 stable, 0.1-0.25 moderate shift, > 0.25 action
required.

The profile's JSON is the reference's, key for key, and versioned
(``profile_version``):

```
{"profile_version": 1, "n_features": F, "bins": B,
 "edges": [[...B-1 inner edges...] x F], "freqs": [[...B...] x F],
 "label_rates": [L], "columns": [...], "n_rows": N}
```

Where it lives: the reference's checkpoint is a directory and its
profile is ``quality_profile.json`` inside it.  The port's checkpoint is
one file, ``step_NNNNNNNN.pt``, so :func:`profile_path_for` names a file
beside it, derived from the checkpoint's stem:
``step_NNNNNNNN.quality_profile.json``.

numpy only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

PROFILE_VERSION = 1
PROFILE_FILENAME = "quality_profile.json"

#: smoothing floor so empty bins never divide by / log zero
_EPS = 1e-4


def build_profile(
    rows: np.ndarray,
    targets: Optional[np.ndarray] = None,
    *,
    bins: int = 10,
    columns: Optional[Sequence[str]] = None,
) -> Dict[str, object]:
    """Quantile-bin reference profile from training-time feature rows."""
    rows = np.atleast_2d(np.asarray(rows, np.float64))
    if rows.shape[0] < 2:
        raise ValueError(f"need >= 2 reference rows, got {rows.shape[0]}")
    if bins < 2:
        raise ValueError(f"need >= 2 bins, got {bins}")
    edges: List[List[float]] = []
    freqs: List[List[float]] = []
    qs = np.linspace(0.0, 1.0, bins + 1)[1:-1]
    for j in range(rows.shape[1]):
        col = rows[:, j]
        inner = np.unique(np.quantile(col, qs))
        counts = np.histogram(col, np.concatenate(
            ([-np.inf], inner, [np.inf])))[0]
        freq = counts / max(1, col.size)
        edges.append([float(x) for x in inner])
        freqs.append([float(x) for x in freq])
    label_rates: List[float] = []
    if targets is not None:
        t = np.atleast_2d(np.asarray(targets, np.float64))
        label_rates = [float(x) for x in np.clip(
            t.mean(axis=0), _EPS, 1.0 - _EPS)]
    return {
        "profile_version": PROFILE_VERSION,
        "n_features": int(rows.shape[1]),
        "bins": int(bins),
        "edges": edges,
        "freqs": freqs,
        "label_rates": label_rates,
        "columns": list(columns) if columns is not None else [],
        "n_rows": int(rows.shape[0]),
    }


def save_profile(path: str, profile: Dict[str, object]) -> str:
    """Write the profile JSON; returns the path written."""
    directory = os.path.dirname(os.path.abspath(path))
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(profile, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


def load_profile(path: str) -> Dict[str, object]:
    with open(path, "r", encoding="utf-8") as fh:
        profile = json.load(fh)
    version = profile.get("profile_version")
    if version != PROFILE_VERSION:
        raise ValueError(
            f"unsupported quality profile version {version!r} at {path} "
            f"(expected {PROFILE_VERSION})")
    return profile


def profile_path_for(checkpoint_path: str) -> str:
    """The profile's well-known location beside a one-file checkpoint:
    ``<dir>/step_N.pt`` -> ``<dir>/step_N.quality_profile.json``."""
    stem = os.path.splitext(checkpoint_path)[0]
    return f"{stem}.{PROFILE_FILENAME}"


def psi(ref_freq: np.ndarray, cur_freq: np.ndarray) -> float:
    """Population stability index between two discrete distributions."""
    ref = np.clip(np.asarray(ref_freq, np.float64), _EPS, None)
    cur = np.clip(np.asarray(cur_freq, np.float64), _EPS, None)
    ref = ref / ref.sum()
    cur = cur / cur.sum()
    return float(np.sum((cur - ref) * np.log(cur / ref)))


class DriftMonitor:
    """Streaming PSI of live features/predictions vs the reference.

    ``observe_features`` digitizes each served row into the profile's
    quantile bins; ``observe_predictions`` tallies thresholded label
    positives.  ``scores()`` is None until ``min_samples`` feature rows
    have been observed — drift over a handful of rows is noise, and the
    SLO objective treats a None score as "never reported".
    """

    def __init__(self, profile: Dict[str, object], *,
                 min_samples: int = 64) -> None:
        self.profile = profile
        self.min_samples = int(min_samples)
        n_features = int(profile["n_features"])
        bins = int(profile["bins"])
        self._edges = [np.asarray(e, np.float64) for e in profile["edges"]]
        self._ref = [np.asarray(f, np.float64) for f in profile["freqs"]]
        # observed bin counts use one row per feature; edge list length
        # can be < bins-1 when training quantiles collapsed (constant
        # features), so each feature gets its own bin count
        self._counts = [np.zeros(len(e) + 1, np.int64) for e in self._edges]
        self._rows = 0
        rates = profile.get("label_rates") or []
        self._label_rates = np.asarray(rates, np.float64)
        self._pred_pos = np.zeros(len(rates), np.int64)
        self._preds = 0
        del n_features, bins

    # -- accumulation --------------------------------------------------------

    def observe_features(self, rows: np.ndarray) -> None:
        rows = np.atleast_2d(np.asarray(rows, np.float64))
        if rows.shape[1] != len(self._edges):
            raise ValueError(
                f"row width {rows.shape[1]} != profile n_features "
                f"{len(self._edges)}")
        for j, edges in enumerate(self._edges):
            idx = np.searchsorted(edges, rows[:, j], side="right")
            np.add.at(self._counts[j], idx, 1)
        self._rows += rows.shape[0]

    def observe_predictions(self, pred: np.ndarray) -> None:
        if not self._label_rates.size:
            return
        pred = np.atleast_2d(np.asarray(pred, bool))
        if pred.shape[1] != self._label_rates.size:
            return
        self._pred_pos += np.sum(pred, axis=0)
        self._preds += pred.shape[0]

    # -- scoring -------------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self._rows

    def feature_scores(self) -> Optional[np.ndarray]:
        if self._rows < self.min_samples:
            return None
        return np.asarray([
            psi(ref, counts / self._rows)
            for ref, counts in zip(self._ref, self._counts)
        ], np.float64)

    def prediction_scores(self) -> Optional[np.ndarray]:
        if not self._preds or not self._label_rates.size:
            return None
        if self._preds < self.min_samples:
            return None
        rate = self._pred_pos / self._preds
        return np.asarray([
            psi(np.asarray([r, 1.0 - r]), np.asarray([c, 1.0 - c]))
            for r, c in zip(self._label_rates, rate)
        ], np.float64)

    def scores(self) -> Optional[Dict[str, object]]:
        feats = self.feature_scores()
        if feats is None:
            return None
        preds = self.prediction_scores()
        worst = float(np.max(feats)) if feats.size else 0.0
        if preds is not None and preds.size:
            worst = max(worst, float(np.max(preds)))
        return {
            "max_psi": worst,
            "feature_psi": [float(x) for x in feats],
            "prediction_psi": (
                [float(x) for x in preds] if preds is not None else None),
            "rows": self._rows,
        }
