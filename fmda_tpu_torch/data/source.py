"""The feature-source protocol the serving and training paths read
through (the warehouse, in-memory arrays, or any columnar store).  Row
ids are 1-based."""

from __future__ import annotations

from typing import Protocol, Sequence, Tuple

import numpy as np


class FeatureSource(Protocol):
    """Columnar access to the joined feature table and the target view."""

    @property
    def x_fields(self) -> Tuple[str, ...]:
        """Feature column names, in schema order."""
        ...

    def __len__(self) -> int:
        """Number of rows available (max id)."""
        ...

    def fetch(self, ids: Sequence[int]) -> np.ndarray:
        """Feature rows for 1-based ids, shape (len(ids), F)."""
        ...

    def fetch_targets(self, ids: Sequence[int]) -> np.ndarray:
        """Target rows for 1-based ids, shape (len(ids), n_classes)."""
        ...


class ArraySource:
    """In-memory :class:`FeatureSource` over numpy arrays."""

    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        x_fields: Sequence[str],
    ) -> None:
        if x.ndim != 2 or y.ndim != 2 or len(x) != len(y):
            raise ValueError(
                f"x and y must be 2-D with one row each per id, got "
                f"{x.shape} and {y.shape}")
        if x.shape[1] != len(x_fields):
            raise ValueError(
                f"{x.shape[1]} feature columns for {len(x_fields)} names")
        self._x = np.asarray(x, np.float32)
        self._y = np.asarray(y, np.float32)
        self._fields = tuple(x_fields)

    @property
    def x_fields(self) -> Tuple[str, ...]:
        return self._fields

    def __len__(self) -> int:
        return len(self._x)

    def _to_index(self, ids: Sequence[int]) -> np.ndarray:
        idx = np.asarray(list(ids), dtype=np.int64) - 1  # 1-based -> 0-based
        if idx.size and (idx.min() < 0 or idx.max() >= len(self._x)):
            raise IndexError(
                f"row ids out of range 1..{len(self._x)}: "
                f"[{idx.min() + 1}, {idx.max() + 1}]"
            )
        return idx

    def fetch(self, ids: Sequence[int]) -> np.ndarray:
        return np.nan_to_num(self._x[self._to_index(ids)], nan=0.0)

    def fetch_targets(self, ids: Sequence[int]) -> np.ndarray:
        return self._y[self._to_index(ids)]
