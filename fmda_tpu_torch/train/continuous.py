"""Continuous fine-tuning: tail the warehouse, fine-tune, hot-swap, as
``fmda_tpu.train.continuous`` defines it.

A :class:`ContinuousTrainer` tails fresh rows through the warehouse's
bounded follow mode (``Warehouse.iter_row_chunks(follow=...)``, keyset
paging that resumes across polls), and every time
``train.continuous_min_rows`` fresh rows have landed it

1. fine-tunes on a sliding window of the newest
   ``train.continuous_window_rows`` rows, warm-started from the previous
   round's state;
2. writes a versioned checkpoint (``step_NNNNNNNN.pt``) and the drift
   reference profile beside it
   (:func:`~fmda_tpu_torch.eval.drift.profile_path_for`);
3. publishes a copy of the new weights through an injected ``publish``
   callable: :func:`gateway_publisher` (a solo ``FleetGateway.hot_swap``)
   or :func:`router_publisher` (a router's ``broadcast_hot_swap``).
   Refused candidates are counted, never retried blindly: the incumbent
   keeps serving, and the next round gets another chance.

Serving never stops: a hot swap rebinds the pool's weights between
flushes, and the trainer runs beside it, in the same process
(``serve-fleet --continuous-train``, the trainer in its own thread) or in
another one pointed at the same warehouse file (``python -m
fmda_tpu_torch train --continuous``).  In one process both threads queue
their work on the card's one default stream: the trainer's kernels run
between the gateway's flushes.

Everything time-shaped is injected (``wait_fn``), so tests drive the
loop to quiescence with no wall sleeps; the CLI passes nothing and gets
the ``train.continuous_poll_s`` wall-clock poll.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fmda_tpu_torch.config import ModelConfig, TrainConfig
from fmda_tpu_torch.device import DeviceLike
from fmda_tpu_torch.obs.registry import default_registry
from fmda_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    imbalance_weights_from_source,
)

log = logging.getLogger("fmda_tpu_torch.train.continuous")

#: ``publish``'s contract: candidate weights (a ``state_dict``) in,
#: ``(accepted, detail)`` out
Publisher = Callable[[Dict[str, Any]], Tuple[bool, Dict[str, Any]]]
#: a guardrail's contract: candidate weights in, ``(ok, detail)`` out
Guard = Callable[[Any], Tuple[bool, dict]]


class _Stopped(Exception):
    """Raised out of the waiter to abort the tail promptly."""


class TailSource:
    """A :class:`~fmda_tpu_torch.data.source.FeatureSource` view of the
    newest rows of another source: positions ``1..n`` map to base
    positions ``offset+1..offset+n``.  The sliding fine-tune window,
    without copying."""

    def __init__(self, base, offset: int, n: int) -> None:
        self._base = base
        self._offset = int(offset)
        self._n = int(n)

    @property
    def x_fields(self) -> Tuple[str, ...]:
        return tuple(self._base.x_fields)

    def __len__(self) -> int:
        return self._n

    def fetch(self, ids: Sequence[int]) -> np.ndarray:
        return self._base.fetch([self._offset + int(i) for i in ids])

    def fetch_targets(self, ids: Sequence[int]) -> np.ndarray:
        return self._base.fetch_targets([self._offset + int(i) for i in ids])


def gateway_publisher(
    gateway, *, require_eval: Optional[Guard] = None
) -> Publisher:
    """Publish rounds into a solo
    :class:`~fmda_tpu_torch.runtime.gateway.FleetGateway`.

    ``require_eval`` is a guardrail: candidate weights in, ``(ok,
    detail)`` out; a refusal keeps the incumbent serving."""

    def publish(params) -> Tuple[bool, Dict[str, Any]]:
        if require_eval is not None:
            ok, detail = require_eval(params)
            if not ok:
                return False, dict(detail)
        version = gateway.hot_swap(params)
        return True, {"version": int(version)}

    return publish


def router_publisher(
    router, *, require_eval: Optional[Guard] = None
) -> Publisher:
    """Publish rounds fleet-wide through anything with the reference
    router's ``broadcast_hot_swap(params, require_eval=)`` (it runs the
    guardrail itself and counts refusals); accepted when it told at least
    one worker."""

    def publish(params) -> Tuple[bool, Dict[str, Any]]:
        told = router.broadcast_hot_swap(params, require_eval=require_eval)
        return told > 0, {"workers_told": int(told)}

    return publish


class ContinuousTrainer:
    """Sliding-window fine-tuning over a live warehouse.

    Parameters
    ----------
    warehouse:
        Any warehouse speaking the
        :class:`~fmda_tpu_torch.data.source.FeatureSource` protocol plus
        ``iter_row_chunks(follow=...)``.
    model_cfg / train_cfg:
        The serving model family (its ``state_dict`` must fit the model
        the serving pool was built with, or the hot swap is refused) and
        the ``[train]`` knobs; the ``continuous_*`` fields drive the loop.
    publish:
        ``state_dict -> (accepted, detail)``; see
        :func:`gateway_publisher` and :func:`router_publisher`.  None:
        checkpoints only.
    wait_fn:
        Called between empty tail polls (default: a wall sleep of
        ``train.continuous_poll_s``).  Tests inject the row generator
        here and never sleep.
    device:
        Where the trainer runs; ``None`` means the CUDA card.
    mesh / dp_axis:
        Passed through to :class:`~fmda_tpu_torch.train.trainer.Trainer`:
        every round's fine-tune data parallel over the mesh's ``dp_axis``
        (each process a rank, as ``Trainer(mesh=)`` runs it).
    """

    def __init__(
        self,
        warehouse,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        *,
        checkpoint_dir: str,
        publish: Optional[Publisher] = None,
        bid_levels: int = 0,
        ask_levels: int = 0,
        drift_bins: int = 16,
        target_lead: int = 0,
        wait_fn: Optional[Callable[[], None]] = None,
        chunk: int = 1024,
        device: DeviceLike = None,
        mesh=None,
        dp_axis: str = "dp",
    ) -> None:
        self.warehouse = warehouse
        self.train_cfg = train_cfg
        self.checkpoint_dir = checkpoint_dir
        self.publish = publish
        self.bid_levels = bid_levels
        self.ask_levels = ask_levels
        self.drift_bins = drift_bins
        self.target_lead = target_lead
        self.chunk = int(chunk)
        self._wait_fn = wait_fn
        self._stop = threading.Event()
        # class-imbalance weights once, from the history at loop start,
        # as the reference fixes them for the loop's lifetime
        weight, pos_weight = (None, None)
        if len(warehouse) > 0:
            try:
                weight, pos_weight = imbalance_weights_from_source(warehouse)
            except (ValueError, ZeroDivisionError):
                log.warning("imbalance weights unavailable: unweighted BCE")
        self.trainer = Trainer(model_cfg, train_cfg, weight=weight,
                               pos_weight=pos_weight, device=device,
                               mesh=mesh, dp_axis=dp_axis)
        self._state: Optional[TrainState] = None
        self.checkpoints: List[str] = []
        self.rounds = 0
        self.rows_seen = 0
        self.swaps_accepted = 0
        self.swaps_refused = 0
        self.last_metrics: Optional[Dict[str, float]] = None

    @property
    def state(self) -> Optional[TrainState]:
        """The newest round's training state (None before the first)."""
        return self._state

    # -- control ------------------------------------------------------------

    def stop(self) -> None:
        """Ask a running :meth:`run` to come home: the tail aborts at the
        next poll, a round in flight completes, then run() returns."""
        self._stop.set()

    def _wait(self) -> None:
        if self._stop.is_set():
            raise _Stopped()
        if self._wait_fn is not None:
            self._wait_fn()
        else:
            time.sleep(self.train_cfg.continuous_poll_s)
        if self._stop.is_set():
            raise _Stopped()

    # -- the loop ------------------------------------------------------------

    def run(
        self,
        *,
        max_rounds: Optional[int] = None,
        initial_state: Optional[TrainState] = None,
    ) -> Dict[str, Any]:
        """Tail -> fine-tune -> checkpoint -> publish, until the warehouse
        quiesces (``continuous_follow_polls`` consecutive empty polls),
        ``max_rounds`` rounds have run, or :meth:`stop` is called.
        ``initial_state`` (from ``self.trainer``) is the first round's
        start; by default a fresh one.  Returns :meth:`summary`."""
        tc = self.train_cfg
        self._state = initial_state
        budget = max_rounds if max_rounds is not None else 0
        fresh = 0
        tail = self.warehouse.iter_row_chunks(
            chunk=self.chunk, follow=tc.continuous_follow_polls,
            poll_wait=self._wait)
        try:
            for _ts, rows in tail:
                fresh += len(rows)
                self.rows_seen += len(rows)
                if fresh < tc.continuous_min_rows:
                    continue
                if self._round():
                    fresh = 0
                if self._stop.is_set():
                    break
                if budget and self.rounds >= budget:
                    break
        except _Stopped:
            pass
        finally:
            tail.close()
        # the tail quiesced (or the budget hit) with fresh rows untrained:
        # one final round, so a bounded run covers every row it saw
        if fresh >= 1 and not self._stop.is_set() \
                and not (budget and self.rounds >= budget):
            self._round()
        return self.summary()

    def _round(self) -> bool:
        """One fine-tune round over the sliding tail window.  False =
        skipped (the window is still too short for one chunk)."""
        tc = self.train_cfg
        n = len(self.warehouse)
        lo = max(0, n - tc.continuous_window_rows)
        source = TailSource(self.warehouse, lo, n - lo)
        if len(source) < tc.chunk_size + tc.window:
            log.info("round skipped: window has %d rows, need >= %d",
                     len(source), tc.chunk_size + tc.window)
            return False
        reg = default_registry()
        t0 = time.perf_counter()
        state, history, dataset = self.trainer.fit(
            source, epochs=tc.continuous_epochs, bid_levels=self.bid_levels,
            ask_levels=self.ask_levels, initial_state=self._state)
        self._state = state
        self.rounds += 1
        reg.counter("continuous_rounds_total").inc()
        reg.histogram("continuous_round_seconds").observe(
            time.perf_counter() - t0)
        last = history["train"][-1]
        self.last_metrics = {
            "loss": float(last.loss), "accuracy": float(last.accuracy)}
        from fmda_tpu_torch.train.checkpoint import save_checkpoint

        ckpt = save_checkpoint(
            self.checkpoint_dir, state, dataset.final_norm_params)
        self.checkpoints.append(ckpt)
        self._write_profile(ckpt)
        if self.publish is not None:
            # a copy, on the training device: a serving pool keeps the
            # tensors it is handed (a swap casts only what differs), and
            # the next round's in-place Adam steps must not reach the
            # weights it serves
            params = {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()}
            accepted, detail = self.publish(params)
            outcome = "accepted" if accepted else "refused"
            reg.counter("continuous_swaps_total", outcome=outcome).inc()
            if accepted:
                self.swaps_accepted += 1
            else:
                self.swaps_refused += 1
            log.info("round %d: swap %s %s", self.rounds, outcome, detail)
        return True

    def _write_profile(self, ckpt: str) -> None:
        """The drift monitor's baseline beside the checkpoint, best
        effort as the one-shot ``train`` command's (a degenerate window
        must not stop the loop)."""
        from fmda_tpu_torch.eval.drift import (
            build_profile, profile_path_for, save_profile)

        try:
            wh = self.warehouse
            n = len(wh)
            ids = list(range(max(1, n - 4096 + 1), n + 1))
            rows = wh.fetch(ids)
            targets = (
                wh.fetch_targets(ids) if n > self.target_lead else None)
            profile = build_profile(rows, targets, bins=self.drift_bins,
                                    columns=list(wh.x_fields))
            save_profile(profile_path_for(ckpt), profile)
        except (ValueError, IndexError, OSError) as e:
            log.warning("quality profile not written beside %s: %s", ckpt, e)

    def summary(self) -> Dict[str, Any]:
        """The loop's summary: the reference's keys except
        ``trainer_unexpected_recompiles`` (eager PyTorch compiles
        nothing, so it would always read 0)."""
        return {
            "rounds": self.rounds,
            "rows_seen": self.rows_seen,
            "checkpoints": list(self.checkpoints),
            "swaps_accepted": self.swaps_accepted,
            "swaps_refused": self.swaps_refused,
            "last_metrics": self.last_metrics,
        }
