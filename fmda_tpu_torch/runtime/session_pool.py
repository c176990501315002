"""Slot-pool session manager: up to ``capacity`` carried streaming states in
one set of pooled tensors, as ``fmda_tpu.runtime.session_pool`` defines it.

A serving fleet holds many independent sessions, each ticking on its own
clock, and a flush carries rows for any subset of them.
:class:`SessionPool` keeps every session's carry, ring, tick position and
normalization stats as rows of ``(capacity + 1, ...)`` tensors on the
device, and a flush (:meth:`SessionPool.step_device`) is

- a *gather* of the rows named by ``slots (B,)``;
- the solo core's per-tick math on that (B, ...) slice, the same functions
  (:func:`~fmda_tpu_torch.serve.streaming.advance_cells` and the pooled
  head), so a pooled session serves what a solo
  :class:`~fmda_tpu_torch.serve.streaming.StreamingBiGRU` serves;
- a *scatter* of the new rows back into the pooled tensors, in place.

Every flush's slots and rows reach the card in one non-blocking copy out
of a pinned staging buffer, so a flush never waits on the card before its
launches.  For ``cell="ssm"`` the flush is then one kernel launch
(:func:`~fmda_tpu_torch.ops.ssm_kernel.ssm_serve_tick`, every layer
included): that copy, the launch and the probabilities' copy back.

The extra slot (index ``capacity``) is the **padding lane**: lanes of a
padded micro-batch past the real requests point at it, so a flush needs no
mask: their writes land in state no session reads.  Per-slot
**generations** guard reuse: :meth:`SessionPool.free` bumps the slot's
generation, so a :class:`SessionHandle` kept past ``free`` can never read
or advance the slot's next session.

Scope: the unidirectional carried-state cores (``cell="gru"``, ``"lstm"``,
``"ssm"``, any ``n_layers``).  Every carry lives in one
``(n_layers, n_carry, capacity + 1, H)`` tensor.  The ``"ssm"`` pool
carries three H-vectors a layer per session and a zero-width ring.
Bidirectional models are served by the window-re-scan Predictor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.device import DeviceLike, PinnedStaging, resolve_device
from fmda_tpu_torch.ops.ssm_kernel import pack_tick_weights, ssm_serve_tick
from fmda_tpu_torch.serve.streaming import (
    _layer_weights,
    _recurrent_cell_ops,
    advance_cells,
    pooled_head_logits,
    serving_params,
)

Tensor = torch.Tensor


class PoolExhausted(Exception):
    """alloc() on a pool with no free slots (admission control reacts)."""


class StaleSessionError(Exception):
    """A SessionHandle used after its slot was freed (or re-allocated)."""


@dataclass(frozen=True)
class SessionHandle:
    """A claim on one pool slot, valid for exactly one generation."""

    session_id: str
    slot: int
    generation: int


class SessionPool:
    """Fixed-capacity pool of carried streaming states on one device.

    ``alloc``, ``free``, ``reset``, ``export_slot`` and ``import_slot``
    manage slots off the hot path; :meth:`step_device` / :meth:`step` are
    the hot path, one flush advancing every session named in ``slots`` by
    one tick, the pooled state updated in place.
    """

    def __init__(self, cfg, params: Mapping[str, Tensor], *, capacity: int,
                 window: int, device: DeviceLike = None) -> None:
        cell_ops = _recurrent_cell_ops(cfg.cell)
        self._gate_step, self._n_carry = cell_ops.gate_step, cell_ops.n_carry
        self._head = cell_ops.head
        if cfg.bidirectional:
            raise ValueError(
                "SessionPool multiplexes the unidirectional carried-state "
                "cores (O(1)/tick); serve bidirectional models through the "
                "window-re-scan Predictor.")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.capacity = capacity
        self.window = window
        #: The padding lane every padded micro-batch points its unused
        #: lanes at: state no session is ever allocated.
        self.padding_slot = capacity
        #: Leading-axis length of every pooled tensor.
        self.n_slots = capacity + 1
        self._dtype = getattr(torch, cfg.dtype)
        self._set_params(serving_params(params, self._dtype, self.device))

        hidden, feats = cfg.hidden_size, cfg.n_features
        n, kw = self.n_slots, dict(dtype=self._dtype, device=self.device)
        with torch.inference_mode():
            # one tensor for every layer's carries (the fused ssm tick
            # reaches them all through one pointer); ``_carry`` views it
            self._state = torch.zeros(
                (cfg.n_layers, self._n_carry, n, hidden), **kw)
            self._carry = tuple(tuple(layer) for layer in self._state)
            # carry-head cells (ssm) keep a zero-width ring: nothing in
            # the pool is sized by `window`
            ring_w = window if self._head == "ring" else 0
            self._ring = torch.zeros((n, ring_w, hidden), **kw)
            self._pos = torch.zeros((n,), dtype=torch.int64,
                                    device=self.device)
            # per-slot normalization: sessions serve different tickers
            # with different price scales
            self._x_min = torch.zeros((n, feats), dtype=torch.float32,
                                      device=self.device)
            self._x_range = torch.ones((n, feats), dtype=torch.float32,
                                       device=self.device)

        # host-side slot bookkeeping
        self._generations = [0] * capacity
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._by_id: Dict[str, SessionHandle] = {}
        # a flush's slots and rows reach the card in one pinned copy; the
        # slots in the dtype their reader takes (the ssm tick's kernel
        # int32, torch indexing int64), so no flush casts them
        self._staging = PinnedStaging()
        self._slot_dtype = np.int32 if self._head == "carry" else np.int64

    def _set_params(self, params: Dict[str, Tensor]) -> None:
        self._params = params
        self._layers = [_layer_weights(params, False, self.cfg.cell, layer)
                        for layer in range(self.cfg.n_layers)]
        self._linear = (params["linear.weight"], params["linear.bias"])
        if self._head == "carry":
            self._tick_weights = pack_tick_weights(self._layers,
                                                   self._linear)

    # -- slot lifecycle (host-side, off the hot path) -------------------------

    @torch.inference_mode()
    def alloc(self, session_id: str,
              norm: Optional[NormParams] = None) -> SessionHandle:
        """Claim a free slot for ``session_id``: zeroed state, the
        session's own normalization stats, a fresh generation."""
        if session_id in self._by_id:
            raise ValueError(f"session {session_id!r} already allocated")
        if not self._free:
            raise PoolExhausted(
                f"all {self.capacity} slots in use ({len(self._by_id)} "
                "sessions); free one or raise RuntimeConfig.capacity")
        slot = self._free.pop()
        self._reset_slot(slot)
        if norm is not None:
            # a copy: stats decoded off a wire frame are read-only views
            x_min = np.array(norm.x_min, np.float32)
            x_range = np.asarray(norm.x_max, np.float32) - x_min
            self._x_min[slot] = torch.as_tensor(x_min)
            self._x_range[slot] = torch.as_tensor(x_range)
        else:
            self._x_min[slot] = 0.0
            self._x_range[slot] = 1.0
        handle = SessionHandle(session_id, slot, self._generations[slot])
        self._by_id[session_id] = handle
        return handle

    def free(self, handle: SessionHandle) -> None:
        """Release the slot.  The generation bump invalidates every copy
        of ``handle``: a later ``step``/``check`` with it raises instead of
        touching whichever session reuses the slot."""
        self.check(handle)
        self._generations[handle.slot] += 1
        del self._by_id[handle.session_id]
        self._free.append(handle.slot)

    @torch.inference_mode()
    def reset(self, handle: SessionHandle) -> None:
        """Zero the session's carried state in place (same slot, same
        generation: a client restarting its stream)."""
        self.check(handle)
        self._reset_slot(handle.slot)

    def _reset_slot(self, slot: int) -> None:
        for layer in self._carry:
            for c in layer:
                c[slot] = 0.0
        self._ring[slot] = 0.0
        self._pos[slot] = 0

    @torch.inference_mode()
    def export_slot(self, handle: SessionHandle) -> dict:
        """Snapshot one session's carried state as host (CPU) tensors in
        the pool's dtypes, the migration payload: the carry per layer, the
        ring, the tick position and the normalization stats.  An
        :meth:`import_slot` on another pool of the same model config
        reproduces the slot bit for bit."""
        self.check(handle)
        s = handle.slot
        return {
            "carry": [[c[s].cpu().clone() for c in layer]
                      for layer in self._carry],
            "ring": self._ring[s].cpu().clone(),
            "pos": int(self._pos[s]),
            "x_min": self._x_min[s].cpu().clone(),
            "x_range": self._x_range[s].cpu().clone(),
        }

    @torch.inference_mode()
    def import_slot(self, handle: SessionHandle, state: dict) -> None:
        """Load an :meth:`export_slot` snapshot into this slot (the
        receiving end of a migration): same-dtype copies, bit-exact."""
        self.check(handle)
        s = handle.slot
        if len(state["carry"]) != self.cfg.n_layers:
            raise ValueError(
                f"state has {len(state['carry'])} carry layers, pool "
                f"expects {self.cfg.n_layers} (model config mismatch?)")
        for layer, state_layer in zip(self._carry, state["carry"]):
            for c, arr in zip(layer, state_layer):
                c[s] = torch.as_tensor(arr).to(self.device, c.dtype)
        self._ring[s] = torch.as_tensor(state["ring"]).to(
            self.device, self._ring.dtype)
        self._pos[s] = int(state["pos"])
        self._x_min[s] = torch.as_tensor(state["x_min"]).to(
            self.device, torch.float32)
        self._x_range[s] = torch.as_tensor(state["x_range"]).to(
            self.device, torch.float32)

    def is_live(self, handle: SessionHandle) -> bool:
        return (
            0 <= handle.slot < self.capacity
            and self._generations[handle.slot] == handle.generation
            and self._by_id.get(handle.session_id) == handle
        )

    def check(self, handle: SessionHandle) -> None:
        if not self.is_live(handle):
            reallocated = any(
                h.slot == handle.slot for h in self._by_id.values())
            raise StaleSessionError(
                f"handle for session {handle.session_id!r} (slot "
                f"{handle.slot}, generation {handle.generation}) is no "
                "longer live — the slot was freed"
                + (" and re-allocated to another session"
                   if reallocated else ""))

    def handle_for(self, session_id: str) -> Optional[SessionHandle]:
        return self._by_id.get(session_id)

    def session_ids(self) -> List[str]:
        """Ids of every live session."""
        return list(self._by_id)

    def slot_norm(self, handle: SessionHandle) -> tuple:
        """One session's normalization stats as host ``(x_min, x_range)``
        arrays."""
        self.check(handle)
        s = handle.slot
        return self._x_min[s].cpu().numpy(), self._x_range[s].cpu().numpy()

    def ticks_seen(self, handle: SessionHandle) -> int:
        self.check(handle)
        return int(self._pos[handle.slot])

    @property
    def n_active(self) -> int:
        return len(self._by_id)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def active_mask(self) -> np.ndarray:
        """(capacity,) bool: which slots carry a live session."""
        mask = np.zeros(self.capacity, bool)
        for h in self._by_id.values():
            mask[h.slot] = True
        return mask

    def live_tree(self):
        """The pool's device state: params, carry, ring, positions, norms."""
        return (self._params, self._carry, self._ring, self._pos,
                self._x_min, self._x_range)

    def swap_weights(self, params: Mapping[str, Tensor]) -> None:
        """Land a new checkpoint into the live pool without touching a
        session: carried state, rings, norms and slot bookkeeping stay; the
        next flush serves the new weights.  A checkpoint whose names,
        shapes or dtypes do not fit the serving model raises ``ValueError``
        before anything changes."""
        if set(params) != set(self._params):
            raise ValueError(
                "swap_weights: checkpoint names differ from the serving "
                f"model's (missing {sorted(set(self._params) - set(params))},"
                f" unexpected {sorted(set(params) - set(self._params))})")
        for name, old in self._params.items():
            new = torch.as_tensor(params[name])
            if tuple(new.shape) != tuple(old.shape):
                raise ValueError(
                    f"swap_weights: {name} is {tuple(new.shape)}, the "
                    f"serving model's {tuple(old.shape)}")
            if not new.is_floating_point():
                raise ValueError(
                    f"swap_weights: {name} is {new.dtype}, not a floating "
                    "dtype")
        self._set_params(serving_params(params, self._dtype, self.device))

    # -- the hot path ---------------------------------------------------------

    @torch.inference_mode()
    def step_device(self, slots, rows) -> Tensor:
        """One flush: advance ``slots[i]`` by ``rows[i]`` and return the
        (B, n_classes) sigmoid probabilities as a device tensor, without
        waiting for the card.

        ``slots`` (B,) ints, padded lanes = :attr:`padding_slot`; ``rows``
        (B, F) float32.  Padding lanes carry garbage; callers slice them
        off.  At most one lane per live slot."""
        slots = np.asarray(slots, np.int64)
        if slots.ndim != 1 or slots.size == 0 or (
                slots.min() < 0 or slots.max() > self.padding_slot):
            raise IndexError(
                f"slots must be a (B,) list of slots 0..{self.padding_slot}")
        rows_d, slots_d = self._stage(slots, np.asarray(rows, np.float32))
        if self._head == "carry":
            return ssm_serve_tick(rows_d, slots_d, self._x_min,
                                  self._x_range, self._tick_weights,
                                  self._state, self._pos)
        idx = slots_d
        x = ((rows_d - self._x_min[idx]) / self._x_range[idx]).to(
            self._dtype)
        pos_b = self._pos[idx]
        carry_b = tuple(tuple(c[idx] for c in layer)
                        for layer in self._carry)
        h_new, carry_new = advance_cells(self._layers, self._gate_step, x,
                                         carry_b)
        self._ring[idx, pos_b % self.window] = h_new
        n_valid = torch.clamp(pos_b + 1, max=self.window)[:, None]
        logits = pooled_head_logits(self._linear, h_new, self._ring[idx],
                                    n_valid)
        # the scatters: a live slot appears at most once in `slots`; only
        # the padding lane repeats, and which of its writes lands does not
        # matter, since nothing reads it
        for layer, layer_new in zip(self._carry, carry_new):
            for c, cb in zip(layer, layer_new):
                c[idx] = cb
        self._pos[idx] = pos_b + 1
        return torch.sigmoid(logits)

    def _stage(self, slots: np.ndarray, rows: np.ndarray):
        """``rows`` (B, F) float32 and ``slots`` (B,) on the pool's
        device, the slots in :attr:`_slot_dtype`; on a card both through
        one pinned buffer and one non-blocking copy."""
        batch, feats = slots.size, self.cfg.n_features
        if rows.shape != (batch, feats):
            raise ValueError(
                f"rows must be (B, F) = {(batch, feats)}, got {rows.shape}")
        slots_d, rows_d = self._staging.to_device(
            "flush", (slots.astype(self._slot_dtype, copy=False), rows),
            self.device)
        return rows_d, slots_d

    def step(self, slots, rows) -> np.ndarray:
        """Blocking :meth:`step_device`: probabilities as a host array."""
        return self.step_device(slots, rows).float().cpu().numpy()
