"""Chunked, windowed, normalized batches and the pipeline that places
them on the device, as ``fmda_tpu.data.pipeline`` builds them:

- :class:`ChunkDataset`: chunk ranges with window overlap and per-chunk
  normalization stats over any
  :class:`~fmda_tpu_torch.data.source.FeatureSource`;
- :class:`WindowBatches`: one vectorized gather materialises every
  stride-1 window of a chunk, then fixed-shape batches come out (the last
  partial batch is zero-padded with a zero ``mask``, so every step has
  one shape);
- :func:`prefetch_batches` / :func:`background_compose`: host composition
  in a daemon thread, each composed batch placed on the device at once
  and up to ``depth`` placed batches ahead of the step loop.
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
from typing import (
    Callable,
    Iterable,
    Iterator,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from fmda_tpu_torch.data.normalize import NormParams, chunk_norm_params, normalize
from fmda_tpu_torch.data.source import FeatureSource
from fmda_tpu_torch.data.windows import (
    chunk_ranges,
    train_val_test_split,
    window_index_matrix,
)


class Batch(NamedTuple):
    """One fixed-shape training batch: numpy arrays on the host, tensors
    once placed."""

    x: np.ndarray  # (B, window, F) float32, normalized
    y: np.ndarray  # (B, n_classes) float32
    mask: np.ndarray  # (B,) float32, 0 for padded examples


class ChunkDataset:
    """Chunk ranges and per-chunk normalization stats over a source."""

    def __init__(
        self,
        source: FeatureSource,
        chunk_size: int,
        window: int,
        *,
        bid_levels: int = 0,
        ask_levels: int = 0,
        cache_chunks: int = 0,
    ) -> None:
        self.source = source
        self.window = window
        self.chunk_size = chunk_size
        self.cache_chunks = cache_chunks
        self.ranges = chunk_ranges(len(source), chunk_size, window)
        # per-chunk min-max stats, computed once here for every pass
        self.norm_params: List[NormParams] = [
            chunk_norm_params(
                source.fetch(r),
                source.x_fields,
                bid_levels=bid_levels,
                ask_levels=ask_levels,
            )
            for r in self.ranges
        ]
        self._window_cache: "collections.OrderedDict[int, Tuple[np.ndarray, np.ndarray]]" = (
            collections.OrderedDict())

    def __len__(self) -> int:
        return len(self.ranges)

    def __getitem__(self, idx: int) -> Tuple[range, NormParams]:
        return self.ranges[idx], self.norm_params[idx]

    def windows(
        self, chunk_idx: int, norm_params: Optional[NormParams] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Normalized stride-1 windows of one chunk: ``(x_windows,
        y_windows)``.

        With ``cache_chunks > 0`` the result is kept in an LRU keyed on
        the chunk index, so later passes skip the fetch, normalization and
        gather (host RAM bound: ``cache_chunks * chunk_size * window * F *
        4`` bytes).  Cached arrays are shared, not copied: treat them as
        read-only.  An explicit ``norm_params`` bypasses the cache.
        """
        cacheable = norm_params is None and self.cache_chunks > 0
        if cacheable and chunk_idx in self._window_cache:
            self._window_cache.move_to_end(chunk_idx)
            return self._window_cache[chunk_idx]
        ids, chunk_params = self[chunk_idx]
        params = norm_params if norm_params is not None else chunk_params
        x = normalize(self.source.fetch(ids), params)
        y = np.asarray(self.source.fetch_targets(ids), np.float32)
        widx = window_index_matrix(len(x), self.window)
        x_windows = x[widx]  # (n_windows, window, F)
        y_windows = y[widx[:, -1]] if len(widx) else y[:0]
        if cacheable:
            self._window_cache[chunk_idx] = (x_windows, y_windows)
            while len(self._window_cache) > self.cache_chunks:
                self._window_cache.popitem(last=False)
        return x_windows, y_windows

    @property
    def final_norm_params(self) -> NormParams:
        """The last chunk's stats: kept for validation, test and serving."""
        return self.norm_params[-1]

    def split(
        self, val_size: float = 0.1, test_size: float = 0.1
    ) -> Tuple[Sequence[int], Sequence[int], Sequence[int]]:
        return train_val_test_split(len(self), val_size, test_size)


class WindowBatches:
    """Fixed-shape sliding-window batches of one chunk."""

    def __init__(
        self,
        dataset: ChunkDataset,
        chunk_idx: int,
        batch_size: int,
    ) -> None:
        self.x_windows, self.y_windows = dataset.windows(chunk_idx)
        self.batch_size = batch_size

    def __len__(self) -> int:
        return (len(self.x_windows) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        n = len(self.x_windows)
        bs = self.batch_size
        for start in range(0, n, bs):
            xb = self.x_windows[start:start + bs]
            yb = self.y_windows[start:start + bs]
            valid = len(xb)
            if valid < bs:
                pad = bs - valid
                xb = np.concatenate(
                    [xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
                yb = np.concatenate(
                    [yb, np.zeros((pad,) + yb.shape[1:], yb.dtype)])
            mask = np.zeros(bs, np.float32)
            mask[:valid] = 1.0
            yield Batch(xb, yb, mask)


def prefetch_batches(
    batches: Iterable[Batch],
    place: Callable[[Batch], Batch],
    *,
    depth: int = 2,
) -> Iterator[Batch]:
    """Depth-N input pipeline.

    Host composition runs in a daemon thread (:func:`background_compose`),
    so the window gather of chunk k+1 overlaps the steps of chunk k.
    ``place`` runs on the consumer's thread, up to ``depth`` batches
    ahead of the one it yields: with the trainer's ``place`` the pin is a
    host copy in line with the steps, and the ``non_blocking`` transfer
    is queued on the current stream, in order with the steps' kernels.
    ``depth=0`` is the synchronous place-per-batch loop with no
    background thread.
    """
    if depth <= 0:
        return (place(b) for b in batches)

    def run() -> Iterator[Batch]:
        pending: collections.deque = collections.deque()
        it = iter(background_compose(batches, depth=depth))
        exhausted = False
        while True:
            while not exhausted and len(pending) < depth:
                try:
                    b = next(it)
                except StopIteration:
                    exhausted = True
                    break
                pending.append(place(b))
            if not pending:
                return
            yield pending.popleft()

    return run()


def background_compose(
    batches: Iterable[Batch], depth: int = 2
) -> Iterator[Batch]:
    """Run a host-side batch composer in a daemon thread, handing batches
    over a bounded queue, so composition overlaps the consumer's work.

    Compose errors reach the consumer at the failed batch; the bounded
    queue keeps at most ``depth`` batches of host memory in flight, and
    the thread gives up when the consumer stops pulling.
    """
    q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        # a bounded put that gives up once the consumer is gone, so an
        # abandoned generator does not park this thread on its memory
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put(b):
                    return
            put(done)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True,
                         name="fmda-torch-batch-compose")
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
