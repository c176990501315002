"""Streaming inference with carried state: the O(1)-per-tick serving path,
as ``fmda_tpu.serve.streaming`` defines it.

The window-re-scan :class:`~fmda_tpu_torch.serve.predictor.Predictor`
re-runs a whole window per signal.  For a *unidirectional* model the
recurrence makes that redundant: the state after row ``t`` summarises all
history, so each tick feeds only the newest row and carries the state.

- :class:`StreamingBiGRU` carries, per layer, the family's cell carry:
  ``(h,)`` for ``cell="gru"``, ``(h, c)`` for ``"lstm"``, and for ``"ssm"``
  the constant-size ``(s, ema_fast, ema_slow)`` cache, a whole tick of
  which (every layer and the head) is one launch of the fused serve-tick
  kernel (:func:`~fmda_tpu_torch.ops.ssm_kernel.ssm_serve_tick`).  The gru
  and lstm heads pool over a ring of the last ``window`` hidden outputs;
  the ssm head reads its two EMAs out of the carry, so its ring is
  zero-width.
- :class:`StreamingBiGRUBidirectional` serves the one-layer bidirectional
  gru and lstm models: the forward direction is carried as above, and the
  backward direction, which needs each row's future, is re-scanned every
  tick over a ring of its input projections, newest to oldest, from a zero
  state, by the route the family's selector picks for the ring's shape
  (``select_scan_fn`` / ``select_lstm_scan_fn``, as training's layers ask
  it): the kernel pair's forward scan, or past its envelope the wide
  route's.
- :class:`StreamingPredictor` is the bus-facing wrapper: each signal feeds
  the rows up to its own through the core, catching up any gap first.

Carried forward state sees the whole session history, while the
window-re-scan Predictor resets both directions at the window's edges;
both serving modes are exposed.  The attn family has no carried-state core.

Each core keeps its state on its device (``device=None`` means ``cuda``):
the ring and the tick position advance in place; the carry is rebound to
each tick's new tensors.  The per-tick gru and lstm steps are torch ops
(``gru_gates``, ``lstm_gates``), as the JAX package's are jnp.
"""

from __future__ import annotations

from typing import Callable, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fmda_tpu_torch.config import (
    TARGET_COLUMNS,
    TOPIC_PREDICT_TIMESTAMP,
    TOPIC_PREDICTION,
)
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.device import DeviceLike, resolve_device
from fmda_tpu_torch.ops import ssm_kernel
from fmda_tpu_torch.ops.gru import GRUWeights, gru_gates, select_scan_fn
from fmda_tpu_torch.ops.lstm import (
    LSTMWeights, lstm_gates, select_lstm_scan_fn)
from fmda_tpu_torch.ops.ssm import SSMWeights
from fmda_tpu_torch.serve.predictor import labels_over_threshold

Tensor = torch.Tensor


def _layer_weights(params: Mapping[str, Tensor], reverse: bool,
                   cell: str = "gru", layer: int = 0):
    """One direction's weights of one layer, read out of a ``state_dict``."""
    suffix = f"l{layer}" + ("_reverse" if reverse else "")
    if cell == "ssm":
        return SSMWeights(*(params[f"{kind}_{suffix}"] for kind in (
            "weight_ih", "bias_ih", "a_base", "d", "rho_f", "rho_s")))
    cls = GRUWeights if cell == "gru" else LSTMWeights
    return cls(*(params[f"{kind}_{suffix}"] for kind in (
        "weight_ih", "weight_hh", "bias_ih", "bias_hh")))


class CellOps(NamedTuple):
    """One recurrent family's carried-state serving contract.

    ``gate_step(xp, carry, w) -> (h_new, carry_new)`` advances one tick
    (carry is a tuple: ``(h,)`` GRU, ``(h, c)`` LSTM); ``bwd_scan(xp_nf,
    zeros, w) -> hs`` is the backward-direction window re-scan from a zero
    state, by the route the family's selector picks for (B, window, H) in
    the ring's dtype (None for families without one); ``head`` names the
    pooling
    state the core carries: ``"ring"`` (a (window, H) ring of per-step
    hiddens fed to :func:`pooled_head_logits`) or ``"carry"`` (the SSM:
    the pooling state lives in the cell carry ``(s, ema_fast, ema_slow)``,
    and the whole tick, head included, is
    :func:`~fmda_tpu_torch.ops.ssm_kernel.ssm_serve_tick`, so there is no
    ``gate_step``)."""

    gate_step: Callable
    bwd_scan: Optional[Callable]
    n_carry: int
    n_gates: int
    head: str


def _scan_shape(xp: Tensor, h0: Tensor) -> Tuple[int, int, int]:
    """(batch, seq_len, hidden) of a scan, the selectors' shape."""
    return xp.shape[0], xp.shape[1], h0.shape[-1]


def _recurrent_cell_ops(cell: str) -> CellOps:
    """:class:`CellOps` for a recurrent family; the attn family has none
    (its window re-encode is the Predictor)."""
    if cell == "gru":
        def gate_step(xp, carry, w):
            h_new = gru_gates(xp, carry[0], w.w_hh, w.b_hh)
            return h_new, (h_new,)

        def bwd_scan(xp_nf, zeros, w):
            scan = select_scan_fn(_scan_shape(xp_nf, zeros),
                                  xp_nf.element_size())
            return scan(xp_nf, zeros, w.w_hh, w.b_hh)[1]

        return CellOps(gate_step, bwd_scan, 1, 3, "ring")
    if cell == "lstm":
        def gate_step(xp, carry, w):
            h_new, c_new = lstm_gates(xp, carry[0], carry[1], w.w_hh, w.b_hh)
            return h_new, (h_new, c_new)

        def bwd_scan(xp_nf, zeros, w):
            scan = select_lstm_scan_fn(_scan_shape(xp_nf, zeros),
                                       xp_nf.element_size())
            return scan(xp_nf, zeros, zeros, w.w_hh, w.b_hh)[1]

        return CellOps(gate_step, bwd_scan, 2, 4, "ring")
    if cell == "ssm":
        return CellOps(None, None, 3, 3, "carry")
    raise ValueError(
        "the carried-state streaming cores cover the recurrent families "
        "(cell='gru'/'lstm'/'ssm'); use the window-re-scan Predictor "
        f"for ModelConfig.cell={cell!r}")


def advance_cells(layers: Sequence, gate_step: Callable, x: Tensor,
                  carries: Tuple[Tuple[Tensor, ...], ...]):
    """One tick through the stacked unidirectional cells: layer l's input
    at tick t is layer l-1's output at tick t.  ``layers`` holds each
    layer's forward weights, ``carries`` each layer's cell-carry tuple of
    (B, H) tensors.  Returns (the last layer's h_new, the new carries).
    Shared by the solo core and the session pool, so the per-tick math
    exists once."""
    layer_in, new_carries = x, []
    for w, carry in zip(layers, carries):
        xp = F.linear(layer_in, w.w_ih, w.b_ih)
        layer_in, carry_new = gate_step(xp, carry, w)
        new_carries.append(carry_new)
    return layer_in, tuple(new_carries)


def pooled_head_logits(head: Tuple[Tensor, Tensor], h_last: Tensor,
                       ring: Tensor, n_valid) -> Tensor:
    """The trailing-window pooled head over a ring of per-step hidden
    outputs: masked max and mean pools of the valid window beside the last
    hidden, through the linear head ``(weight, bias)``.

    ``ring`` is (B, window, H); ``n_valid`` an int (solo cores, all lanes
    in lockstep) or a (B, 1) tensor (the pool's per-session counts): the
    same broadcasting covers both."""
    window = ring.shape[1]
    valid = (torch.arange(window, device=ring.device) < n_valid)[..., None]
    neg = torch.finfo(ring.dtype).min
    max_pool = torch.where(valid, ring, neg).amax(dim=1)
    avg_pool = torch.where(valid, ring, 0.0).sum(dim=1) / n_valid
    concat = torch.cat([h_last, max_pool, avg_pool], dim=-1)
    return F.linear(concat, *head)


def serving_params(params: Mapping[str, Tensor], dtype: torch.dtype,
                   device: torch.device) -> dict:
    """A ``state_dict`` cast once to the compute dtype, on ``device``."""
    return {k: torch.as_tensor(v).detach().to(device, dtype)
            for k, v in params.items()}


def _norm_tensors(norm: NormParams, device: torch.device):
    x_min = np.asarray(norm.x_min, np.float32)
    x_range = np.asarray(norm.x_max, np.float32) - x_min
    return (torch.as_tensor(x_min, device=device),
            torch.as_tensor(x_range, device=device))


def _row_tensor(row, device: torch.device) -> Tensor:
    row = torch.as_tensor(np.asarray(row, np.float32))
    return (row[None, :] if row.dim() == 1 else row).to(device)


def _probabilities(logits: Tensor) -> np.ndarray:
    return torch.sigmoid(logits).float().cpu().numpy()


class StreamingBiGRU:
    """Carried-state streaming inference for unidirectional models.

    Holds each layer's cell carry and, for the ring-head families, a ring
    of the last ``window`` hidden outputs; each :meth:`step` advances the
    recurrence by one row and returns the head's probabilities, exactly as
    a full scan of the history with the trailing-window pooled head would.
    ``cell="ssm"`` keeps a zero-width ring: its carried state is three
    H-vectors a layer however large ``window`` is.
    """

    def __init__(self, cfg, params: Mapping[str, Tensor], norm: NormParams,
                 *, window: int, batch: int = 1,
                 device: DeviceLike = None) -> None:
        ops = _recurrent_cell_ops(cfg.cell)
        self._gate_step, self._n_carry, self._head = (
            ops.gate_step, ops.n_carry, ops.head)
        if cfg.bidirectional:
            raise ValueError(
                "carried-state streaming needs bidirectional=False; the "
                "backward direction would require the future. Use the "
                "window-re-scan Predictor for bidirectional models.")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.window = window
        self.batch = batch
        self._dtype = getattr(torch, cfg.dtype)
        self._params = serving_params(params, self._dtype, self.device)
        self._layers = [_layer_weights(self._params, False, cfg.cell, layer)
                        for layer in range(cfg.n_layers)]
        self._linear = (self._params["linear.weight"],
                        self._params["linear.bias"])
        self._x_min, self._x_range = _norm_tensors(norm, self.device)
        if self._head == "carry":
            # the fused tick: lane b is slot b of the core's state, every
            # lane under the core's one norm (a one-row table)
            self._tick_weights = ssm_kernel.pack_tick_weights(self._layers,
                                                              self._linear)
            self._slots = torch.arange(batch, dtype=torch.int32,
                                       device=self.device)
            self._x_min, self._x_range = (self._x_min[None],
                                          self._x_range[None])
        self.reset()

    @torch.inference_mode()
    def reset(self) -> None:
        kw = dict(dtype=self._dtype, device=self.device)
        shape = (self.batch, self.cfg.hidden_size)
        if self._head == "carry":
            # the fused tick writes every layer's carries in place, in one
            # tensor that ``_h`` views, and counts each lane's ticks as the
            # pool's positions
            self._state = torch.zeros((self.cfg.n_layers, self._n_carry,
                                       *shape), **kw)
            self._h = tuple(tuple(layer) for layer in self._state)
            self._tick_pos = torch.zeros((self.batch,), dtype=torch.int64,
                                         device=self.device)
        else:
            self._h = tuple(
                tuple(torch.zeros(shape, **kw) for _ in range(self._n_carry))
                for _ in range(self.cfg.n_layers))
        ring_w = self.window if self._head == "ring" else 0
        self._ring = torch.zeros((self.batch, ring_w, self.cfg.hidden_size),
                                 **kw)
        self._pos = 0

    @property
    def ticks_seen(self) -> int:
        return self._pos

    @torch.inference_mode()
    def step(self, row) -> np.ndarray:
        """Advance one tick with the newest feature row (B, F) or (F,);
        returns sigmoid probabilities (B, n_classes)."""
        row = _row_tensor(row, self.device)
        if self._head == "carry":
            probs = ssm_kernel.ssm_serve_tick(
                row, self._slots, self._x_min, self._x_range,
                self._tick_weights, self._state, self._tick_pos)
            self._pos += 1
            return probs.cpu().numpy()
        x = ((row - self._x_min) / self._x_range).to(self._dtype)
        h_new, self._h = advance_cells(self._layers, self._gate_step, x,
                                       self._h)
        self._ring[:, self._pos % self.window] = h_new
        n_valid = min(self._pos + 1, self.window)
        logits = pooled_head_logits(self._linear, h_new, self._ring, n_valid)
        self._pos += 1
        return _probabilities(logits)


class StreamingBiGRUBidirectional:
    """Carried-state streaming inference for the one-layer bidirectional
    gru and lstm models.  Per tick:

    - forward direction: advance the carried state by the newest row (one
      gate step) and push its hidden output onto a ring;
    - backward direction: project the row once, push it onto a ring of
      backward projections, and re-scan that ring newest to oldest from a
      zero state at the newest row (the kernel pair's forward scan, one
      launch a tick, or past its envelope the wide route, a product and a
      gate launch a ring slot), the training-time backward semantics;
    - the pooled head (last-hidden sum, max and mean pools of the per-step
      direction sums) over the valid window.
    """

    def __init__(self, cfg, params: Mapping[str, Tensor], norm: NormParams,
                 *, window: int, batch: int = 1,
                 device: DeviceLike = None) -> None:
        ops = _recurrent_cell_ops(cfg.cell)
        if ops.head != "ring":
            raise ValueError(
                f"cell={cfg.cell!r} has no bidirectional carried-state "
                "core; serve it with the unidirectional StreamingBiGRU "
                "(O(1) cache) or the window-re-scan Predictor")
        self._gate_step, self._bwd_scan = ops.gate_step, ops.bwd_scan
        self._n_carry, self._n_gates = ops.n_carry, ops.n_gates
        if not cfg.bidirectional:
            raise ValueError(
                "use StreamingBiGRU for unidirectional models (pure O(1))")
        if cfg.n_layers != 1:
            # layer 1 would need layer 0's backward outputs over the whole
            # window, which change every tick: that is the Predictor
            raise ValueError(
                "bidirectional carried-state streaming covers 1-layer "
                "models; use the window-re-scan Predictor for stacked "
                "bidirectional models")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.window = window
        self.batch = batch
        self._dtype = getattr(torch, cfg.dtype)
        self._params = serving_params(params, self._dtype, self.device)
        self._wf = _layer_weights(self._params, False, cfg.cell)
        self._wb = _layer_weights(self._params, True, cfg.cell)
        self._linear = (self._params["linear.weight"],
                        self._params["linear.bias"])
        self._x_min, self._x_range = _norm_tensors(norm, self.device)
        # row `slot` lists the ring slots newest first when the newest row
        # sits at `slot`: (slot - k) % window
        k = torch.arange(window)
        self._newest_first = ((k[:, None] - k[None, :]) % window).to(
            self.device)
        self.reset()

    @torch.inference_mode()
    def reset(self) -> None:
        hidden = self.cfg.hidden_size
        kw = dict(dtype=self._dtype, device=self.device)
        self._zeros = torch.zeros((self.batch, hidden), **kw)
        self._h = tuple(torch.zeros((self.batch, hidden), **kw)
                        for _ in range(self._n_carry))
        self._hs_ring = torch.zeros((self.batch, self.window, hidden), **kw)
        self._xpb_ring = torch.zeros(
            (self.batch, self.window, self._n_gates * hidden), **kw)
        self._pos = 0

    @property
    def ticks_seen(self) -> int:
        return self._pos

    @torch.inference_mode()
    def step(self, row) -> np.ndarray:
        """Advance one tick with the newest feature row (B, F) or (F,);
        returns sigmoid probabilities (B, n_classes)."""
        row = _row_tensor(row, self.device)
        x = ((row - self._x_min) / self._x_range).to(self._dtype)
        wf, wb = self._wf, self._wb
        h_new, self._h = self._gate_step(F.linear(x, wf.w_ih, wf.b_ih),
                                         self._h, wf)
        slot = self._pos % self.window
        self._hs_ring[:, slot] = h_new
        self._xpb_ring[:, slot] = F.linear(x, wb.w_ih, wb.b_ih)
        n_valid = min(self._pos + 1, self.window)
        order = self._newest_first[slot]
        # ticks past n_valid scan stale slots; the head masks them out
        h_bwd = self._bwd_scan(self._xpb_ring.index_select(1, order),
                               self._zeros, wb)
        summed = self._hs_ring.index_select(1, order) + h_bwd
        logits = pooled_head_logits(self._linear,
                                    h_new + h_bwd[:, n_valid - 1], summed,
                                    n_valid)
        self._pos += 1
        return _probabilities(logits)


class StreamingPredictor:
    """Bus-facing wrapper: consume predict-timestamp signals, feed the rows
    up to each signal's through the carried-state core, publish the
    predictions (the ``prediction`` topic's payload fields)."""

    #: catch-up fetch granularity: one query per this many missed rows
    #: (bounds the query count and the peak memory of a long catch-up)
    CATCHUP_CHUNK = 10_000

    def __init__(self, bus, warehouse, core, *, threshold: float = 0.5,
                 y_fields: Sequence[str] = TARGET_COLUMNS,
                 signal_topic: str = TOPIC_PREDICT_TIMESTAMP,
                 prediction_topic: str = TOPIC_PREDICTION,
                 from_end: bool = True) -> None:
        self.bus = bus
        self.warehouse = warehouse
        self.core = core
        self.threshold = threshold
        self.y_fields = tuple(y_fields)
        self.prediction_topic = prediction_topic
        self._consumer = bus.consumer(signal_topic, from_end=from_end)
        self._last_row_id = 0

    def poll(self) -> List[Tuple[str, np.ndarray, Tuple[str, ...]]]:
        """Serve new signals; returns [(timestamp, probs, labels)].

        Rows are consumed strictly in position order: if signals skipped
        rows (a predictor started mid-session, say), the gap rows go
        through the recurrence first, fetched in batches of
        :data:`CATCHUP_CHUNK`, so the carried state stays exact.  A signal
        carrying an in-band trace context gets a ``serve`` span on it and
        passes the context on to its prediction message."""
        from fmda_tpu_torch.obs.trace import default_tracer, now_ns

        tracer = default_tracer()
        out = []
        for rec in self._consumer.poll():
            ts = rec.value.get("Timestamp")
            if not ts:
                continue
            trace = rec.value.get("trace")
            t0_ns = now_ns() if (trace is not None and tracer.enabled) else 0
            row_id = self.warehouse.id_for_timestamp(ts)
            if row_id is None or row_id <= self._last_row_id:
                continue
            for lo in range(self._last_row_id + 1, row_id + 1,
                            self.CATCHUP_CHUNK):
                hi = min(lo + self.CATCHUP_CHUNK - 1, row_id)
                for x in self.warehouse.fetch(range(lo, hi + 1)):
                    probs = self.core.step(x)[0]
            self._last_row_id = row_id
            idx, labels = labels_over_threshold(
                probs, self.threshold, self.y_fields)
            msg = {
                "timestamp": ts,
                "probabilities": [float(p) for p in probs],
                "prob_threshold": self.threshold,
                "pred_indices": list(idx),
                "pred_labels": list(labels),
            }
            if trace is not None:
                msg["trace"] = trace
            self.bus.publish(self.prediction_topic, msg)
            if t0_ns:
                tracer.add_span_wire(trace, "serve", "serve", t0_ns, now_ns())
            out.append((ts, probs, labels))
        return out
