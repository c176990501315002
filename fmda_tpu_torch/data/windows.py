"""Chunk and sliding-window index arithmetic over 1-based row ids, as
``fmda_tpu.data.windows`` does it (the reference's chunked loading,
vectorized: a chunk's windows are an index matrix)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def chunk_ranges(db_length: int, chunk_size: int, window: int) -> List[range]:
    """Chunk id ranges with ``window-1``-row overlap stitching.

    Chunk 0 covers ids ``[window, chunk_size)``; interior chunk ``k``
    covers ``[k*chunk_size - window + 1, (k+1)*chunk_size)``; the final
    chunk runs to ``db_length`` inclusive.  The overlap lets every chunk
    produce windows for all its own rows without reaching into the
    previous chunk.
    """
    if window >= db_length:
        raise ValueError(
            f"window ({window}) must be smaller than the source length "
            f"({db_length})"
        )
    if window >= chunk_size and db_length >= chunk_size:
        # chunk 0 would be empty and no chunk's own region could hold a
        # full window
        raise ValueError(
            f"window ({window}) must be smaller than chunk_size "
            f"({chunk_size})"
        )
    num_chunks = db_length // chunk_size
    if num_chunks == 0:
        # a source shorter than one chunk: one chunk covering everything
        return [range(window, db_length + 1)]
    ranges: List[range] = []
    for chunk in range(num_chunks + 1):
        if chunk == 0:
            ranges.append(range(window, chunk_size))
        elif chunk < num_chunks:
            ranges.append(range(chunk_size * chunk - window + 1,
                                chunk_size * (chunk + 1)))
        else:
            ranges.append(range(chunk_size * chunk - window + 1,
                                db_length + 1))
    return ranges


def window_index_matrix(n_rows: int, window: int) -> np.ndarray:
    """All stride-1 sliding windows over ``n_rows`` positions: an int
    matrix (n_rows - window + 1, window) whose row ``i`` is
    ``[i, ..., i + window - 1]``."""
    if n_rows < window:
        return np.empty((0, window), dtype=np.int64)
    starts = np.arange(n_rows - window + 1, dtype=np.int64)[:, None]
    return starts + np.arange(window, dtype=np.int64)[None, :]


def train_val_test_split(
    n_chunks: int, val_size: float = 0.1, test_size: float = 0.1
) -> Tuple[Sequence[int], Sequence[int], Sequence[int]]:
    """Contiguous chunk-level split.

    ``val`` and ``test`` each get ``int(frac * n) + 1`` chunks, matching
    the reference's arithmetic; slices clamp at the end of the chunk list.
    Training always keeps at least one chunk: when ``n_chunks`` is too
    small for three non-empty splits, val and then test lose out.
    """
    if not val_size + test_size < 1:
        raise ValueError("val_size + test_size must be < 1")
    if val_size < 0 or test_size < 0:
        raise ValueError("negative split size")
    train_size = 1 - val_size - test_size
    train_end = max(1, int(train_size * n_chunks)) if n_chunks else 0
    val_end = train_end + int(val_size * n_chunks) + 1
    test_end = val_end + int(test_size * n_chunks) + 1
    chunks = range(n_chunks)
    return chunks[:train_end], chunks[train_end:val_end], chunks[val_end:test_end]
