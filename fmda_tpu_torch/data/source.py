"""The feature-source protocol the serving path reads through (the
warehouse, or any columnar store).  Row ids are 1-based."""

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

