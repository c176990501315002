"""Multi-ticker shared-encoder training, as ``fmda_tpu.train.multiticker``
defines it.

One model is trained over many tickers: every ticker contributes its own
chunked, per-ticker-normalized windows (a window never spans tickers),
and batches interleave tickers so each step's gradient mixes
instruments.  :meth:`MultiTickerDataset.mixed_batches` builds the
north-star composition, ``k`` windows of every ticker in one batch (50
tickers x 16 windows = 800 rows a step): on the card the mix is simply a
larger batch.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.data.pipeline import Batch, ChunkDataset, WindowBatches
from fmda_tpu_torch.data.source import FeatureSource


class MultiTickerDataset:
    """Per-ticker chunk datasets over a shared feature schema."""

    def __init__(
        self,
        sources: Dict[str, FeatureSource],
        chunk_size: int,
        window: int,
        *,
        bid_levels: int = 0,
        ask_levels: int = 0,
    ) -> None:
        if not sources:
            raise ValueError("no sources")
        fields = {tuple(s.x_fields) for s in sources.values()}
        if len(fields) != 1:
            raise ValueError(
                "tickers must share one feature schema (shared encoder); "
                f"got {len(fields)} distinct schemas"
            )
        self.tickers = tuple(sources)
        self.datasets: Dict[str, ChunkDataset] = {
            t: ChunkDataset(
                src, chunk_size, window,
                bid_levels=bid_levels, ask_levels=ask_levels,
            )
            for t, src in sources.items()
        }

    def splits(
        self, val_size: float, test_size: float
    ) -> Tuple[List[Tuple[str, int]], List[Tuple[str, int]], List[Tuple[str, int]]]:
        """Per-ticker chunk splits, interleaved across tickers so every
        epoch pass mixes instruments."""
        train: List[Tuple[str, int]] = []
        val: List[Tuple[str, int]] = []
        test: List[Tuple[str, int]] = []
        per_ticker = {
            t: ds.split(val_size, test_size) for t, ds in self.datasets.items()
        }
        def interleave(select) -> List[Tuple[str, int]]:
            out: List[Tuple[str, int]] = []
            queues = {t: list(select(s)) for t, s in per_ticker.items()}
            while any(queues.values()):
                for t in self.tickers:
                    if queues[t]:
                        out.append((t, queues[t].pop(0)))
            return out

        return (
            interleave(lambda s: s[0]),
            interleave(lambda s: s[1]),
            interleave(lambda s: s[2]),
        )

    def batches(
        self, ticker: str, chunk_idx: int, batch_size: int
    ) -> WindowBatches:
        return WindowBatches(self.datasets[ticker], chunk_idx, batch_size)

    def rounds(
        self, chunks: List[Tuple[str, int]]
    ) -> List[Dict[str, int]]:
        """Regroup an interleaved ``(ticker, chunk)`` list (as produced by
        :meth:`splits`) into *rounds*: round ``r`` holds the r-th listed
        chunk of every ticker that still has one.  Rounds are the unit of
        mixed-composition training — see :meth:`mixed_batches`."""
        seen: Dict[str, int] = {t: 0 for t in self.tickers}
        rounds: List[Dict[str, int]] = []
        for ticker, chunk_idx in chunks:
            r = seen[ticker]
            seen[ticker] = r + 1
            while len(rounds) <= r:
                rounds.append({})
            rounds[r][ticker] = chunk_idx
        return rounds

    def mixed_batches(
        self, round_chunks: Dict[str, int], per_ticker: int
    ) -> Iterator[Batch]:
        """Fixed-shape batches mixing every ticker in one step — the
        north-star composition (50 tickers x 16 windows/step): each batch
        concatenates ``per_ticker`` windows from every ticker's chunk of
        this round, each ticker normalized with its own chunk stats.
        Every batch has shape ``(len(tickers) * per_ticker, ...)``
        regardless of which tickers are present or exhausted (absent
        slots are zero-filled with mask 0), so every step of the run has
        one shape."""
        iters: Dict[str, Iterator[Batch]] = {
            t: iter(WindowBatches(self.datasets[t], c, per_ticker))
            for t, c in round_chunks.items()
        }
        # shape donors from any participating dataset
        any_ds = self.datasets[next(iter(round_chunks))]
        window = any_ds.window
        n_feat = len(any_ds.source.x_fields)
        n_cls = any_ds.source.fetch_targets([any_ds.window]).shape[-1]
        zero = Batch(
            x=np.zeros((per_ticker, window, n_feat), np.float32),
            y=np.zeros((per_ticker, n_cls), np.float32),
            mask=np.zeros(per_ticker, np.float32),
        )
        while iters:
            parts: List[Batch] = []
            alive = False
            for t in self.tickers:
                it = iters.get(t)
                part = zero
                if it is not None:
                    try:
                        part = next(it)
                        alive = True
                    except StopIteration:
                        iters.pop(t)
                parts.append(part)
            if not alive:
                return
            yield Batch(
                x=np.concatenate([p.x for p in parts]),
                y=np.concatenate([p.y for p in parts]),
                mask=np.concatenate([p.mask for p in parts]),
            )

    def final_norm_params(self) -> Dict[str, NormParams]:
        """Per-ticker serving norm stats (each instrument has its own
        scale; sharing one min/max across tickers would wash out FX vs
        equity magnitudes)."""
        return {t: ds.final_norm_params for t, ds in self.datasets.items()}
