"""Training harness: chunked epochs over a feature source, on the card.

The counterpart of ``fmda_tpu.train.trainer.Trainer`` for every model
family (whichever ``ModelConfig.cell`` names), with the same
semantics: chunk-level contiguous split, per-chunk min-max
normalization, weighted BCE over padded and masked fixed-shape batches,
Adam behind a global-norm clip of ``train.clip``, and per-batch metrics
averaged per epoch.

- The family's forward and backward kernels run: the scans of
  :mod:`fmda_tpu_torch.ops.gru_kernel` or
  :mod:`fmda_tpu_torch.ops.lstm_kernel`, or the flash-attention sweeps of
  :mod:`fmda_tpu_torch.ops.attention_kernel` (their plain versions on the
  CPU); the SSM trains through its parallel scan, with no kernel.
- The optimizer is ``torch.optim.Adam`` with optax's defaults behind
  :func:`clip_by_global_norm`, a copy of ``optax.clip_by_global_norm``.
- Metrics are summed on the device and read once per pass.
- With ``train.cache_chunks``, later epochs replay the placed device
  batches of the first pass.
- :meth:`Trainer.fit_multi` trains one model over many tickers, in
  chunk-interleaved single-ticker batches or in mixed batches of every
  ticker (:mod:`fmda_tpu_torch.train.multiticker`).
- Each epoch's wall time and count land in the process-default metrics
  registry (``train_epoch_seconds``, ``train_epochs_total``).
- With a ``mesh`` (:func:`fmda_tpu_torch.parallel.build_mesh`, one process
  a rank) training is data parallel over its ``dp`` axis: every rank walks
  the same global batches and places its rows of each
  (:func:`~fmda_tpu_torch.parallel.place_local_batch`), the params start
  the same on every rank (broadcast from rank 0), the gradients of the
  local BCE sums and the valid-element counts are summed over dp in one
  all-reduce and divided by the global count (the masked mean's
  normalizer), and the loss and metrics are those of the global batch.  A
  mesh whose dp axis has one rank is the meshless path.
"""

from __future__ import annotations

import itertools
import logging
import time
from dataclasses import dataclass
from typing import (
    Any,
    Dict,
    Iterable,
    List,
    Mapping,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch

from fmda_tpu_torch.config import ModelConfig, TrainConfig
from fmda_tpu_torch.data.pipeline import (
    Batch,
    ChunkDataset,
    WindowBatches,
    prefetch_batches,
)
from fmda_tpu_torch.data.source import FeatureSource
from fmda_tpu_torch.device import DeviceLike, resolve_device
from fmda_tpu_torch.models import build_model
from fmda_tpu_torch.obs.registry import default_registry
from fmda_tpu_torch.ops.metrics import MultilabelMetrics, multilabel_metrics
from fmda_tpu_torch.train.losses import (
    class_weights,
    weighted_bce_sums,
    weighted_bce_with_logits,
)

log = logging.getLogger("fmda_tpu_torch.train")

#: optax.adam's defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    """What training carries from step to step: the model (its params),
    the optimizer (its moments), the step count, and the dropout stream,
    a generator on the training device."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator


class EpochMetrics(NamedTuple):
    loss: float
    accuracy: float
    hamming: float
    fbeta: np.ndarray  # (n_classes,)


def clip_by_global_norm(
    grads: Sequence[torch.Tensor], max_norm: float
) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: when the global norm is not
    below ``max_norm``, every gradient becomes ``(g / norm) * max_norm``;
    otherwise it is left as it is.  Decided on the device, so the step
    never waits for the host.  Returns the norm."""
    norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    denom = torch.where(keep, torch.ones_like(norm), norm)
    scale = torch.where(keep, torch.ones_like(norm),
                        torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(denom).mul_(scale)
    return norm


class Trainer:
    """Builds the model and optimizer and runs chunked epochs over a
    source, on ``device`` (``None`` means the CUDA card; without one it
    raises and names ``device="cpu"``), or data parallel over the
    ``dp_axis`` of ``mesh``, each rank on its own device (the module
    docstring sets it out)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        *,
        weight: Optional[np.ndarray] = None,
        pos_weight: Optional[np.ndarray] = None,
        device: DeviceLike = None,
        mesh=None,
        dp_axis: str = "dp",
    ) -> None:
        if mesh is not None:
            if mesh.local:
                raise ValueError(
                    "Trainer(mesh=) takes a mesh of ranks "
                    "(fmda_tpu_torch.parallel.build_mesh without devices); "
                    "a mesh of one process's devices serves the pool")
            device = mesh.device if device is None else device
        self.device = resolve_device(device)
        self.mesh, self.dp_axis = mesh, dp_axis
        #: the dp axis when it has more than one rank, else None (the
        #: meshless path)
        self._dp = (mesh.axis(dp_axis) if mesh is not None
                    and mesh.shape[dp_axis] > 1 else None)
        if self._dp is not None and train_cfg.batch_size % self._dp.size:
            raise ValueError(
                f"batch_size {train_cfg.batch_size} does not split into "
                f"{self._dp.size} equal blocks of rows over {dp_axis!r}")
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.weight = self._on_device(weight)
        self.pos_weight = self._on_device(pos_weight)
        self._restored_norm = None
        # placed-batch cache: (id(dataset), chunk tuple) -> (dataset,
        # [Batch]); the dataset reference keeps id() valid
        self._placed_cache: Dict[Any, Tuple[ChunkDataset, List[Batch]]] = {}

    def _on_device(self, a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        if a is None:
            return None
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # -- state ---------------------------------------------------------------

    def init_state(
        self, params: Optional[Mapping[str, torch.Tensor]] = None
    ) -> TrainState:
        """A fresh state: weights drawn on the host from ``train.seed`` (so
        every device starts from the same ones) unless ``params`` (a
        ``state_dict``) is given, Adam's moments at zero, step 0, and the
        dropout generator seeded from ``train.seed + 1`` (plus the rank's
        dp index under a dp mesh)."""
        tc = self.train_cfg
        model = build_model(
            self.model_cfg, generator=torch.Generator().manual_seed(tc.seed))
        if params is not None:
            model.load_state_dict(params)
        model.to(self.device)
        if self._dp is not None:
            from fmda_tpu_torch.parallel import place_replicated

            place_replicated(self.mesh, model)
        optimizer = torch.optim.Adam(
            model.parameters(), lr=tc.learning_rate, betas=ADAM_BETAS,
            eps=ADAM_EPS)
        # under dp each rank draws its own rows' masks: its own stream
        rank = self._dp.index if self._dp is not None else 0
        generator = torch.Generator(device=self.device).manual_seed(
            tc.seed + 1 + rank)
        return TrainState(model, optimizer, 0, generator)

    def restore_state(self, checkpoint_path: str) -> TrainState:
        """Exact resume: params, Adam's moments, the step and the dropout
        stream from a checkpoint :func:`save_checkpoint` wrote from a
        :class:`TrainState`, so ``fit(..., initial_state=restore_state(p))``
        continues as if training had not stopped."""
        from fmda_tpu_torch.train.checkpoint import restore_checkpoint

        tree, norm = restore_checkpoint(checkpoint_path)
        if "opt_state" not in tree:
            raise ValueError(
                f"{checkpoint_path} holds weights only: it serves, but "
                "training cannot resume from it")
        # remembered so fit() can tell when the source's stats moved
        self._restored_norm = norm
        state = self.init_state(tree["params"])
        state.optimizer.load_state_dict(tree["opt_state"])
        state.step = int(tree["step"])
        if tree.get("rng_device") == self.device.type:
            state.generator.set_state(tree["rng_state"])
        else:
            log.warning(
                "%s was written on %s: the dropout stream restarts from the "
                "seed on %s", checkpoint_path, tree.get("rng_device"),
                self.device.type)
        return state

    # -- steps ---------------------------------------------------------------

    def place(self, batch: Batch) -> Batch:
        """A host batch on the training device: through pinned host memory
        and a ``non_blocking`` copy on the card, as tensors on the CPU;
        under a dp mesh, this rank's rows of it."""
        if self._dp is not None:
            from fmda_tpu_torch.parallel import place_local_batch

            return place_local_batch(self.mesh, batch, self.dp_axis)
        tensors = (torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
        if self.device.type != "cuda":
            return Batch(*tensors)
        return Batch(*(t.pin_memory().to(self.device, non_blocking=True)
                       for t in tensors))

    def batch_loss(self, logits: torch.Tensor, batch: Batch) -> torch.Tensor:
        """The masked weighted BCE of a placed batch."""
        return weighted_bce_with_logits(
            logits, batch.y, weight=self.weight, pos_weight=self.pos_weight,
            example_mask=batch.mask)

    def accumulate_gradients(
        self, state: TrainState, batch: Batch
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward and backward of one placed batch into the params'
        ``.grad``; returns (loss, logits), both detached.

        With ``train.accum_steps = K`` the batch runs as K equal
        microbatches.  The normalizer ``max(valid_rows * C, 1)`` is known
        before the first, so each runs ``backward(sum_k / denom)`` and the
        gradients add up to the full batch's.  Each microbatch draws its
        own dropout masks.  Under a dp mesh the valid rows are counted
        over dp first, so ``denom`` is the global batch's, and the
        gradients and the loss sum are then summed over dp in one
        all-reduce."""
        model, k = state.model, self.train_cfg.accum_steps
        state.optimizer.zero_grad(set_to_none=True)
        if k == 1 and self._dp is None:
            logits = model(batch.x, generator=state.generator)
            loss = self.batch_loss(logits, batch)
            loss.backward()
            return loss.detach(), logits.detach()
        n_classes = self.model_cfg.output_size
        valid = batch.mask.sum()
        if self._dp is not None:
            import torch.distributed as dist

            valid = valid.float()
            dist.all_reduce(valid, group=self._dp.group)
        denom = (valid * n_classes).clamp_min(1.0)
        loss_sum = torch.zeros((), device=self.device)
        outs = []
        for x, y, mask in zip(*(t.chunk(k) for t in batch)):
            logits = model(x, generator=state.generator)
            s, _ = weighted_bce_sums(
                logits, y, weight=self.weight, pos_weight=self.pos_weight,
                example_mask=mask)
            (s / denom).backward()
            loss_sum += s.detach()
            outs.append(logits.detach())
        if self._dp is not None:
            from fmda_tpu_torch.parallel.sp_train import all_reduce_gradients

            params = [p for p in model.parameters() if p.requires_grad]
            for p in params:
                if p.grad is None:  # a param this batch did not reach
                    p.grad = torch.zeros_like(p)
            (loss_sum,) = all_reduce_gradients(params, [loss_sum],
                                               group=self._dp.group)
        return loss_sum / denom, torch.cat(outs)

    def _global(self, logits: torch.Tensor, batch: Batch
                ) -> Tuple[torch.Tensor, Batch]:
        """(logits, batch) of the whole global batch: under a dp mesh, every
        rank's rows gathered in one all-gather, in rank order."""
        if self._dp is None:
            return logits, batch
        from fmda_tpu_torch.parallel.collectives import all_gather

        n_classes = logits.shape[-1]
        local = torch.cat([logits.float(), batch.y.float(),
                           batch.mask.float()[:, None]], dim=-1)
        rows = all_gather(local, self._dp, tiled=True)
        return rows[:, :n_classes], Batch(
            None, rows[:, n_classes:2 * n_classes], rows[:, -1])

    def apply_gradients(self, state: TrainState) -> None:
        """Clip the gradients by their global norm, then one Adam step."""
        grads = [p.grad for p in state.model.parameters()
                 if p.grad is not None]
        clip_by_global_norm(grads, self.train_cfg.clip)
        state.optimizer.step()
        state.step += 1

    def train_step(
        self, state: TrainState, batch: Batch
    ) -> Tuple[torch.Tensor, MultilabelMetrics]:
        """One optimizer step on a placed batch: (loss, metrics) as device
        tensors."""
        state.model.train()
        loss, logits = self.accumulate_gradients(state, batch)
        self.apply_gradients(state)
        return loss, self.batch_metrics(*self._global(logits, batch))

    def eval_step(
        self, state: TrainState, batch: Batch
    ) -> Tuple[torch.Tensor, MultilabelMetrics]:
        state.model.eval()
        with torch.no_grad():
            logits, batch = self._global(state.model(batch.x), batch)
            return (self.batch_loss(logits, batch),
                    self.batch_metrics(logits, batch))

    def batch_metrics(
        self, logits: torch.Tensor, batch: Batch
    ) -> MultilabelMetrics:
        """The multilabel metrics of a placed batch, as device tensors."""
        tc = self.train_cfg
        return multilabel_metrics(
            logits, batch.y, threshold=tc.prob_threshold,
            beta=tc.fbeta_beta, example_mask=batch.mask)

    # -- epochs --------------------------------------------------------------

    def _prefetch(self, batches: Iterable[Batch]) -> Iterable[Batch]:
        """The input pipeline (:func:`prefetch_batches` over
        :meth:`place`, ``train.prefetch_depth`` batches ahead), its
        host-side wait per pull observed into the
        ``train_input_stall_seconds`` histogram, as the reference's
        ``_place_batches`` observes it."""
        stall = default_registry().histogram("train_input_stall_seconds")
        return prefetch_batches(batches, self.place,
                                depth=self.train_cfg.prefetch_depth,
                                stall_observer=stall.observe)

    def _run_chunks(
        self,
        state: TrainState,
        dataset: ChunkDataset,
        chunk_indices: Sequence[int],
        train: bool,
    ) -> Tuple[TrainState, EpochMetrics, np.ndarray]:
        # One host generator over every chunk behind one pipeline.  With
        # cache_chunks set, the placed batches of the first pass are kept
        # and later passes replay them: no re-gather, re-pad or re-copy
        # (steps never write to a batch, so the replay is bit-identical).
        cache_on = (self.train_cfg.cache_chunks > 0
                    and len(chunk_indices) <= self.train_cfg.cache_chunks)
        key = (id(dataset), tuple(chunk_indices))
        if cache_on:
            entry = self._placed_cache.get(key)
            if entry is not None and entry[0] is dataset:
                return self._run_batches(state, entry[1], train)

        def host_batches() -> Iterable[Batch]:
            for idx in chunk_indices:
                yield from WindowBatches(
                    dataset, idx, self.train_cfg.batch_size)

        placed = self._prefetch(host_batches())
        if not cache_on:
            return self._run_batches(state, placed, train)
        sink: List[Batch] = []

        def capturing() -> Iterable[Batch]:
            for b in placed:
                sink.append(b)
                yield b

        out = self._run_batches(state, capturing(), train)
        self._placed_cache[key] = (dataset, sink)
        while len(self._placed_cache) > 4:  # train + val + headroom
            self._placed_cache.pop(next(iter(self._placed_cache)))
        return out

    def _run_batches(
        self, state: TrainState, batches: Iterable[Batch], train: bool
    ) -> Tuple[TrainState, EpochMetrics, np.ndarray]:
        # per-batch results are added into running device tensors; the
        # host reads them once, after the pass
        from fmda_tpu_torch.utils.tracing import step_annotation

        step = self.train_step if train else self.eval_step
        phase = "train" if train else "eval"
        acc = None
        n_steps = 0
        for batch in batches:
            # marks each step in a device profile when one is being
            # captured (utils.tracing.device_trace)
            with step_annotation(phase, n_steps):
                loss, m = step(state, batch)
            vals = (loss, m.accuracy, m.hamming, m.fbeta, m.confusion)
            acc = vals if acc is None else tuple(
                a + v for a, v in zip(acc, vals))
            n_steps += 1
        n_classes = self.model_cfg.output_size
        if acc is None:
            log.warning(
                "pass produced no batches (source too short for "
                "window=%d/chunk_size=%d, or empty chunk split): metrics "
                "are NaN", self.train_cfg.window, self.train_cfg.chunk_size)
            nan = float("nan")
            return (state, EpochMetrics(nan, nan, nan, np.zeros(n_classes)),
                    np.zeros((n_classes, 2, 2), np.int64))
        loss_sum, acc_sum, ham_sum, fbeta_sum, confusion = (
            t.cpu().numpy() for t in acc)
        epoch = EpochMetrics(
            loss=float(loss_sum) / n_steps,
            accuracy=float(acc_sum) / n_steps,
            hamming=float(ham_sum) / n_steps,
            fbeta=np.asarray(fbeta_sum) / n_steps,
        )
        return state, epoch, np.asarray(confusion, np.int64)

    def _warn_if_norm_drifted(self, dataset: ChunkDataset) -> None:
        """A resumed fit recomputes normalization from the current source;
        if rows landed since the save, the stats under the restored params
        moved: say so."""
        saved = self._restored_norm
        if saved is None:
            return
        now = dataset.final_norm_params
        if not (np.allclose(saved.x_min, now.x_min)
                and np.allclose(saved.x_max, now.x_max)):
            log.warning(
                "resuming on a source whose normalization stats differ from "
                "the checkpoint's (data changed since the save): inputs are "
                "rescaled relative to what the restored params saw")

    def fit(
        self,
        source: FeatureSource,
        *,
        epochs: Optional[int] = None,
        bid_levels: int = 0,
        ask_levels: int = 0,
        initial_state: Optional[TrainState] = None,
        dataset: Optional[ChunkDataset] = None,
    ) -> Tuple[TrainState, Dict[str, List[EpochMetrics]], ChunkDataset]:
        """Train over a feature source; returns (state, history, dataset).

        ``initial_state`` (from :meth:`init_state` or
        :meth:`restore_state`) is trained on in place instead of a fresh
        one; ``epochs`` then means additional epochs.  ``dataset`` reuses
        a :class:`ChunkDataset` an earlier fit returned (it must wrap
        ``source``), keeping its window cache and the placed batches.
        """
        tc = self.train_cfg
        if dataset is None:
            dataset = ChunkDataset(
                source, tc.chunk_size, tc.window, bid_levels=bid_levels,
                ask_levels=ask_levels, cache_chunks=tc.cache_chunks)
        train_chunks, val_chunks, _ = dataset.split(tc.val_size, tc.test_size)
        if initial_state is None:
            state = self.init_state()
        else:
            state = initial_state
            self._warn_if_norm_drifted(dataset)
        history: Dict[str, List[EpochMetrics]] = {"train": [], "val": []}
        reg = default_registry()
        epoch_hist = reg.histogram("train_epoch_seconds")
        epoch_counter = reg.counter("train_epochs_total")
        for epoch in range(epochs if epochs is not None else tc.epochs):
            t_epoch = time.perf_counter()
            state, train_metrics, _ = self._run_chunks(
                state, dataset, train_chunks, train=True)
            history["train"].append(train_metrics)
            if val_chunks:
                _, val_metrics, _ = self._run_chunks(
                    state, dataset, val_chunks, train=False)
            else:
                nan = float("nan")
                val_metrics = EpochMetrics(
                    nan, nan, nan, np.zeros(self.model_cfg.output_size))
            history["val"].append(val_metrics)
            epoch_hist.observe(time.perf_counter() - t_epoch)
            epoch_counter.inc()
            log.info(
                "epoch %d: train loss=%.4f acc=%.4f hamming=%.4f | "
                "val acc=%.4f hamming=%.4f", epoch + 1, train_metrics.loss,
                train_metrics.accuracy, train_metrics.hamming,
                val_metrics.accuracy, val_metrics.hamming)
        return state, history, dataset

    def fit_multi(
        self,
        sources: Mapping[str, FeatureSource],
        *,
        epochs: Optional[int] = None,
        bid_levels: int = 0,
        ask_levels: int = 0,
        mixed_batch_per_ticker: Optional[int] = None,
    ) -> Tuple[TrainState, Dict[str, List[EpochMetrics]], Any]:
        """Multi-ticker shared-encoder training: one model, batches
        interleaved across instruments, per-ticker chunk normalization.
        Returns (state, history, :class:`MultiTickerDataset`).

        By default each step is a single-ticker batch of ``batch_size``,
        the tickers' chunks interleaved.  ``mixed_batch_per_ticker=k``
        switches to the mixed composition: every step concatenates ``k``
        windows of every ticker (``len(sources) * k`` rows a step, e.g. 50
        x 16 = 800; a ticker with none left is zero-filled with mask 0),
        so each gradient mixes all instruments.  Either way a pass's
        batches are composed in the pipeline's background thread and
        placed ahead of the steps: the mixed composition is the costly
        host stage.  Placed batches are not cached across epochs.
        """
        from fmda_tpu_torch.train.multiticker import MultiTickerDataset

        tc = self.train_cfg
        mtd = MultiTickerDataset(sources, tc.chunk_size, tc.window,
                                 bid_levels=bid_levels, ask_levels=ask_levels)
        train_chunks, val_chunks, _ = mtd.splits(tc.val_size, tc.test_size)
        k = mixed_batch_per_ticker

        def placed(chunks) -> Iterable[Batch]:
            if k:
                host = (mtd.mixed_batches(rc, k) for rc in mtd.rounds(chunks))
            else:
                host = (mtd.batches(t, c, tc.batch_size) for t, c in chunks)
            return self._prefetch(itertools.chain.from_iterable(host))

        state = self.init_state()
        history: Dict[str, List[EpochMetrics]] = {"train": [], "val": []}
        for epoch in range(epochs if epochs is not None else tc.epochs):
            state, train_metrics, _ = self._run_batches(
                state, placed(train_chunks), train=True)
            history["train"].append(train_metrics)
            _, val_metrics, _ = self._run_batches(
                state, placed(val_chunks), train=False)
            history["val"].append(val_metrics)
            log.info(
                "multi epoch %d: train loss=%.4f acc=%.4f | val acc=%.4f",
                epoch + 1, train_metrics.loss, train_metrics.accuracy,
                val_metrics.accuracy)
        return state, history, mtd

    def evaluate(
        self,
        state: TrainState,
        dataset: ChunkDataset,
        chunk_indices: Sequence[int],
    ) -> Tuple[EpochMetrics, np.ndarray]:
        """An eval pass over chunks: (metrics, summed confusion matrices)."""
        _, metrics, confusion = self._run_chunks(
            state, dataset, chunk_indices, train=False)
        return metrics, confusion


def imbalance_weights_from_source(
    source: FeatureSource,
) -> Tuple[np.ndarray, np.ndarray]:
    """(weight, pos_weight) from the whole target table."""
    y = source.fetch_targets(range(1, len(source) + 1))
    counts = np.maximum(y.sum(axis=0), 1.0)
    return class_weights(counts, len(y))
