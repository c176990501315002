"""Real-time serving: signal-triggered window re-scan on the card.

Each ``predict_timestamp`` signal names a landed warehouse row; the
predictor fetches the trailing window, normalizes it on the device with
the checkpoint's stats, runs the model (two scan-kernel launches for a
one-layer bidirectional BiGRU or BiLSTM, one flash-attention launch a
layer for the TemporalTransformer) and publishes the label probabilities to
the ``prediction`` topic with the reference's payload fields.
Stale-signal filtering is injectable through ``now_fn``.  A signal
carrying an in-band trace context gets a ``serve`` span on that trace
(while the process tracer is enabled) and passes the context on to its
prediction message.
"""

from __future__ import annotations

import datetime as _dt
import logging
from dataclasses import dataclass
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from fmda_tpu_torch.config import (
    TARGET_COLUMNS,
    TOPIC_PREDICT_TIMESTAMP,
    TOPIC_PREDICTION,
    ModelConfig,
)
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.device import DeviceLike, resolve_device
from fmda_tpu_torch.models import build_model
from fmda_tpu_torch.obs.trace import default_tracer, now_ns
from fmda_tpu_torch.stream.bus import InProcessBus
from fmda_tpu_torch.stream.warehouse import Warehouse
from fmda_tpu_torch.utils.timeutils import get_timezone, parse_ts

log = logging.getLogger("fmda_tpu_torch.serve")


def labels_over_threshold(
    probs, threshold: float, y_fields: Sequence[str]
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(label_indices, labels) of the probabilities strictly over
    ``threshold`` — the one threshold decision of every serving path."""
    idx = tuple(int(i) for i in np.where(np.asarray(probs) > threshold)[0])
    return idx, tuple(y_fields[i] for i in idx)


def load_model(model_cfg: ModelConfig, params: Mapping[str, torch.Tensor],
               device: torch.device) -> torch.nn.Module:
    """The serving model: built from the config, weights loaded, on
    ``device``, in eval mode."""
    model = build_model(model_cfg)
    model.load_state_dict(params)
    return model.to(device).eval()


def make_batched_forward(model: torch.nn.Module):
    """The window-re-scan forward every serving path shares:
    ``(x_min, x_range, x)`` with ``x`` (B, window, F) on the model's device
    -> (B, n_classes) sigmoid probabilities, normalization included."""

    def forward(x_min: torch.Tensor, x_range: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return torch.sigmoid(model((x - x_min) / x_range))

    return forward


def prediction_message(pred: "Prediction", trace: Optional[str]) -> dict:
    """The ``prediction``-topic payload."""
    msg = {
        "timestamp": pred.timestamp,
        "probabilities": list(pred.probabilities),
        "prob_threshold": pred.threshold,
        "pred_indices": list(pred.label_indices),
        "pred_labels": list(pred.labels),
    }
    if trace is not None:
        msg["trace"] = trace
    return msg


@dataclass(frozen=True)
class Prediction:
    timestamp: str
    probabilities: Tuple[float, ...]
    threshold: float
    labels: Tuple[str, ...]
    label_indices: Tuple[int, ...]


class Predictor:
    """Consumes predict-timestamp signals, serves label probabilities."""

    def __init__(
        self,
        bus: InProcessBus,
        warehouse: Warehouse,
        model_cfg: ModelConfig,
        params: Mapping[str, torch.Tensor],
        norm_params: NormParams,
        *,
        window: int,
        threshold: float = 0.5,
        y_fields: Sequence[str] = TARGET_COLUMNS,
        signal_topic: str = TOPIC_PREDICT_TIMESTAMP,
        prediction_topic: str = TOPIC_PREDICTION,
        from_end: bool = True,
        max_staleness_s: Optional[int] = 4 * 60,
        timezone: str = "US/Eastern",
        now_fn: Optional[Callable[[], _dt.datetime]] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.bus = bus
        self.warehouse = warehouse
        self.window = window
        self.threshold = threshold
        self.y_fields = tuple(y_fields)
        self.prediction_topic = prediction_topic
        self.max_staleness_s = max_staleness_s
        # signal timestamps are naive exchange-local strings, so the
        # staleness clock is exchange-local too
        if now_fn is None:
            tz = get_timezone(timezone)

            def now_fn():
                return _dt.datetime.now(tz).replace(tzinfo=None)

        self.now_fn = now_fn
        self._consumer = bus.consumer(signal_topic, from_end=from_end)
        self._x_min = torch.as_tensor(
            np.asarray(norm_params.x_min, np.float32), device=self.device)
        self._x_range = torch.as_tensor(
            np.asarray(norm_params.x_max - norm_params.x_min, np.float32),
            device=self.device)
        #: per-signal failures survived by poll()
        self.serve_errors = 0
        self.model = load_model(model_cfg, params, self.device)
        self._forward = make_batched_forward(self.model)

    @classmethod
    def from_checkpoint(
        cls,
        checkpoint_path: str,
        bus: InProcessBus,
        warehouse: Warehouse,
        model_cfg: ModelConfig,
        *,
        window: int,
        **kwargs,
    ) -> "Predictor":
        """Build from a port checkpoint (weights and norm stats in one)."""
        from fmda_tpu_torch.train.checkpoint import restore_checkpoint

        tree, norm = restore_checkpoint(checkpoint_path)
        if norm is None:
            raise ValueError(
                f"checkpoint {checkpoint_path} has no normalization stats")
        return cls(bus, warehouse, model_cfg, tree["params"], norm,
                   window=window, **kwargs)

    def _is_stale(self, ts_str: str) -> bool:
        if self.max_staleness_s is None:
            return False
        age = (self.now_fn() - parse_ts(ts_str)).total_seconds()
        return age > self.max_staleness_s

    def predict_for_timestamp(
        self, ts_str: str, trace: Optional[str] = None
    ) -> Optional[Prediction]:
        """Serve one landed row; None if the row is missing or has less
        than a window of history.  ``trace`` is the signal's in-band trace
        context: the serve stage is recorded as a span on it and the
        prediction message carries it onward."""
        tracer = default_tracer()
        t0_ns = now_ns() if (trace is not None and tracer.enabled) else 0
        row_id = self.warehouse.id_for_timestamp(ts_str)
        if row_id is None:
            log.warning("no warehouse row for signal %s", ts_str)
            return None
        if row_id < self.window:
            log.warning("row %d at %s has <%d rows of history; skipping",
                        row_id, ts_str, self.window)
            return None
        ids = range(row_id - self.window + 1, row_id + 1)
        x = torch.from_numpy(self.warehouse.fetch(ids)[None, ...])
        probs = self._forward(self._x_min, self._x_range,
                              x.to(self.device))[0].cpu().numpy()
        idx, labels = labels_over_threshold(probs, self.threshold,
                                            self.y_fields)
        pred = Prediction(
            timestamp=ts_str,
            probabilities=tuple(float(p) for p in probs),
            threshold=self.threshold,
            labels=labels,
            label_indices=idx,
        )
        self.bus.publish(self.prediction_topic,
                         prediction_message(pred, trace))
        if t0_ns:
            tracer.add_span_wire(trace, "serve", "serve", t0_ns, now_ns())
        return pred

    def poll(self) -> List[Prediction]:
        """Serve every new signal; returns the predictions made."""
        out: List[Prediction] = []
        for rec in self._consumer.poll():
            ts_str = rec.value.get("Timestamp")
            if not ts_str:
                log.warning("signal without Timestamp at offset %d", rec.offset)
                continue
            if self._is_stale(ts_str):
                log.warning("dropping stale signal %s", ts_str)
                continue
            try:
                pred = self.predict_for_timestamp(
                    ts_str, trace=rec.value.get("trace"))
            except Exception:  # noqa: BLE001 — one bad signal must not
                # abort the rest of the poll batch: count, log, go on
                self.serve_errors += 1
                log.exception("serving signal %s failed (%d so far)",
                              ts_str, self.serve_errors)
                continue
            if pred is not None:
                out.append(pred)
                log.info("Timestamp: %s, probabilities: %s, labels above "
                         "%.2f: %s", pred.timestamp, pred.probabilities,
                         pred.threshold, pred.labels)
        return out
