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

**Sharding.**  Given ``mesh`` (a local mesh,
``fmda_tpu_torch.parallel.build_mesh(cfg, devices=[...])``), the slots are
split into equal blocks, one a device of its ``shard_axis``
(:func:`~fmda_tpu_torch.parallel.slot_sharding`), and the slot count is
padded up to a multiple of the shard count (slots past the padding lane
are never allocated).  Each block keeps its rows of every pooled tensor
and a copy of the weights on its device, a flush groups its lanes by
block and runs one step a block, and the probabilities come back in lane
order on the first block's device.  Sessions are allocated round the
blocks in turn, so a fleet spreads its load over the devices.  A device
list may repeat one device, standing in for several.  A mesh of one device
(or ``mesh=None``) is the unsharded pool, bit for bit.

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


class _Block:
    """One device's block of the pool: ``n`` rows of every pooled tensor
    (the pool's slots ``start`` to ``start + n - 1``), the weights on its
    device, and a flush's step over them."""

    def __init__(self, pool: "SessionPool", start: int, n: int,
                 device: torch.device, params: Mapping[str, Tensor]) -> None:
        cfg = pool.cfg
        self.pool, self.start, self.n, self.device = pool, start, n, device
        self.set_params(params)
        hidden, feats = cfg.hidden_size, cfg.n_features
        kw = dict(dtype=pool._dtype, device=device)
        with torch.inference_mode():
            # one tensor for every layer's carries (the fused ssm tick
            # reaches them all through one pointer); ``carry`` views it
            self.state = torch.zeros(
                (cfg.n_layers, pool._n_carry, n, hidden), **kw)
            self.carry = tuple(tuple(layer) for layer in self.state)
            # carry-head cells (ssm) keep a zero-width ring: nothing in
            # the pool is sized by `window`
            ring_w = pool.window if pool._head == "ring" else 0
            self.ring = torch.zeros((n, ring_w, hidden), **kw)
            self.pos = torch.zeros((n,), dtype=torch.int64, device=device)
            # per-slot normalization: sessions serve different tickers
            # with different price scales
            self.x_min = torch.zeros((n, feats), dtype=torch.float32,
                                     device=device)
            self.x_range = torch.ones((n, feats), dtype=torch.float32,
                                      device=device)
        # a flush's slots and rows reach the card in one pinned copy
        self.staging = PinnedStaging()

    def set_params(self, params: Mapping[str, Tensor]) -> None:
        pool = self.pool
        self.params = serving_params(params, pool._dtype, self.device)
        self.layers = [_layer_weights(self.params, False, pool.cfg.cell, l)
                       for l in range(pool.cfg.n_layers)]
        self.linear = (self.params["linear.weight"],
                       self.params["linear.bias"])
        if pool._head == "carry":
            self.tick_weights = pack_tick_weights(self.layers, self.linear)

    def tensors(self):
        return (self.params, self.carry, self.ring, self.pos, self.x_min,
                self.x_range)

    def step(self, slots: np.ndarray, rows: np.ndarray) -> Tensor:
        """Advance this block's ``slots`` (its own row indices) by
        ``rows``: the (B, n_classes) probabilities on its device."""
        pool = self.pool
        slots_d, rows_d = self.staging.to_device(
            "flush", (slots.astype(pool._slot_dtype, copy=False), rows),
            self.device)
        if pool._head == "carry":
            return ssm_serve_tick(rows_d, slots_d, self.x_min, self.x_range,
                                  self.tick_weights, self.state, self.pos)
        idx = slots_d
        x = ((rows_d - self.x_min[idx]) / self.x_range[idx]).to(pool._dtype)
        pos_b = self.pos[idx]
        carry_b = tuple(tuple(c[idx] for c in layer) for layer in self.carry)
        h_new, carry_new = advance_cells(self.layers, pool._gate_step, x,
                                         carry_b)
        self.ring[idx, pos_b % pool.window] = h_new
        n_valid = torch.clamp(pos_b + 1, max=pool.window)[:, None]
        logits = pooled_head_logits(self.linear, h_new, self.ring[idx],
                                    n_valid)
        # the scatters: a live slot appears at most once in `slots`; only
        # the padding lane repeats, and which of its writes lands does not
        # matter, since nothing reads it
        for layer, layer_new in zip(self.carry, carry_new):
            for c, cb in zip(layer, layer_new):
                c[idx] = cb
        self.pos[idx] = pos_b + 1
        return torch.sigmoid(logits)


class SessionPool:
    """Fixed-capacity pool of carried streaming states on one device, or
    split over the devices of a local ``mesh`` (the module docstring).

    ``alloc``, ``free``, ``reset``, ``export_slot`` and ``import_slot``
    manage slots off the hot path; :meth:`step_device` / :meth:`step` are
    the hot path, one flush advancing every session named in ``slots`` by
    one tick, the pooled state updated in place.
    """

    def __init__(self, cfg, params: Mapping[str, Tensor], *, capacity: int,
                 window: int, device: DeviceLike = None, mesh=None,
                 shard_axis: str = "dp") -> None:
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
        devices = self._shard_devices(mesh, shard_axis, device)
        self.device = devices[0]
        self.mesh = mesh
        #: Blocks the slots are split into, one a device.
        self.n_shards = len(devices)
        self.cfg = cfg
        self.capacity = capacity
        self.window = window
        #: The padding lane every padded micro-batch points its unused
        #: lanes at: state no session is ever allocated.
        self.padding_slot = capacity
        #: Leading-axis length of every pooled tensor, all blocks together
        #: (capacity + 1, padded up to a multiple of the shard count).
        self.n_slots = -(-(capacity + 1) // self.n_shards) * self.n_shards
        self._dtype = getattr(torch, cfg.dtype)
        # the slots in the dtype their reader takes (the ssm tick's kernel
        # int32, torch indexing int64), so no flush casts them
        self._slot_dtype = np.int32 if self._head == "carry" else np.int64
        size = self.n_slots // self.n_shards
        self._block_size = size
        self._blocks = [_Block(self, i * size, size, dev, params)
                        for i, dev in enumerate(devices)]
        # host-side slot bookkeeping; allocation takes the blocks in turn
        self._generations = [0] * capacity
        order = sorted(range(capacity), key=lambda s: (s % size, s // size))
        self._free: List[int] = order[::-1]
        self._by_id: Dict[str, SessionHandle] = {}
        # the lane order of a sharded flush's probabilities goes home to
        # the first block's device through this staging
        self._staging = PinnedStaging()

    @staticmethod
    def _shard_devices(mesh, shard_axis: str, device: DeviceLike
                       ) -> List[torch.device]:
        """The device of each block: one per entry of a local mesh's
        ``shard_axis`` (the slot sharding's axis; the first entry of the
        other axis), else ``device`` alone."""
        if mesh is None:
            return [resolve_device(device)]
        from fmda_tpu_torch.parallel import slot_sharding

        if not mesh.local:
            raise ValueError(
                "SessionPool(mesh=) takes a local mesh, build_mesh(cfg, "
                "devices=[...]): its blocks are one process's devices")
        (axis,) = slot_sharding(mesh, shard_axis).spec
        if axis not in mesh.axis_names:
            raise ValueError(f"the mesh's axes are {mesh.axis_names}, not "
                             f"{axis!r}")
        grid = [mesh.devices[d * mesh.sp:(d + 1) * mesh.sp]
                for d in range(mesh.dp)]
        if axis == mesh.dp_axis:
            return [row[0] for row in grid]
        return list(grid[0])

    def _locate(self, slot: int):
        """(the block holding ``slot``, its row there)."""
        return self._blocks[slot // self._block_size], slot % self._block_size

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
        blk, s = self._locate(slot)
        if norm is not None:
            # a copy: stats decoded off a wire frame are read-only views
            x_min = np.array(norm.x_min, np.float32)
            x_range = np.asarray(norm.x_max, np.float32) - x_min
            blk.x_min[s] = torch.as_tensor(x_min)
            blk.x_range[s] = torch.as_tensor(x_range)
        else:
            blk.x_min[s] = 0.0
            blk.x_range[s] = 1.0
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
        blk, s = self._locate(slot)
        for layer in blk.carry:
            for c in layer:
                c[s] = 0.0
        blk.ring[s] = 0.0
        blk.pos[s] = 0

    @torch.inference_mode()
    def export_slot(self, handle: SessionHandle) -> dict:
        """Snapshot one session's carried state as host (CPU) tensors in
        the pool's dtypes, the migration payload: the carry per layer, the
        ring, the tick position and the normalization stats.  An
        :meth:`import_slot` on another pool of the same model config
        reproduces the slot bit for bit."""
        self.check(handle)
        blk, s = self._locate(handle.slot)
        return {
            "carry": [[c[s].cpu().clone() for c in layer]
                      for layer in blk.carry],
            "ring": blk.ring[s].cpu().clone(),
            "pos": int(blk.pos[s]),
            "x_min": blk.x_min[s].cpu().clone(),
            "x_range": blk.x_range[s].cpu().clone(),
        }

    @torch.inference_mode()
    def import_slot(self, handle: SessionHandle, state: dict) -> None:
        """Load an :meth:`export_slot` snapshot into this slot (the
        receiving end of a migration): same-dtype copies, bit-exact."""
        self.check(handle)
        blk, s = self._locate(handle.slot)
        if len(state["carry"]) != self.cfg.n_layers:
            raise ValueError(
                f"state has {len(state['carry'])} carry layers, pool "
                f"expects {self.cfg.n_layers} (model config mismatch?)")
        for layer, state_layer in zip(blk.carry, state["carry"]):
            for c, arr in zip(layer, state_layer):
                c[s] = torch.as_tensor(arr).to(blk.device, c.dtype)
        blk.ring[s] = torch.as_tensor(state["ring"]).to(
            blk.device, blk.ring.dtype)
        blk.pos[s] = int(state["pos"])
        blk.x_min[s] = torch.as_tensor(state["x_min"]).to(
            blk.device, torch.float32)
        blk.x_range[s] = torch.as_tensor(state["x_range"]).to(
            blk.device, torch.float32)

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
        blk, s = self._locate(handle.slot)
        return blk.x_min[s].cpu().numpy(), blk.x_range[s].cpu().numpy()

    def ticks_seen(self, handle: SessionHandle) -> int:
        self.check(handle)
        blk, s = self._locate(handle.slot)
        return int(blk.pos[s])

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
        """The pool's device state: params, carry, ring, positions, norms
        (a tuple of them a block when sharded)."""
        if self.n_shards == 1:
            return self._blocks[0].tensors()
        return tuple(blk.tensors() for blk in self._blocks)

    def swap_weights(self, params: Mapping[str, Tensor]) -> None:
        """Land a new checkpoint into the live pool without touching a
        session: carried state, rings, norms and slot bookkeeping stay; the
        next flush serves the new weights.  A checkpoint whose names,
        shapes or dtypes do not fit the serving model raises ``ValueError``
        before anything changes."""
        serving = self._blocks[0].params
        if set(params) != set(serving):
            raise ValueError(
                "swap_weights: checkpoint names differ from the serving "
                f"model's (missing {sorted(set(serving) - set(params))},"
                f" unexpected {sorted(set(params) - set(serving))})")
        for name, old in serving.items():
            new = torch.as_tensor(params[name])
            if tuple(new.shape) != tuple(old.shape):
                raise ValueError(
                    f"swap_weights: {name} is {tuple(new.shape)}, the "
                    f"serving model's {tuple(old.shape)}")
            if not new.is_floating_point():
                raise ValueError(
                    f"swap_weights: {name} is {new.dtype}, not a floating "
                    "dtype")
        for blk in self._blocks:
            blk.set_params(params)

    # -- the hot path ---------------------------------------------------------

    @torch.inference_mode()
    def step_device(self, slots, rows) -> Tensor:
        """One flush: advance ``slots[i]`` by ``rows[i]`` and return the
        (B, n_classes) sigmoid probabilities as a device tensor, without
        waiting for the card.

        ``slots`` (B,) ints, padded lanes = :attr:`padding_slot`; ``rows``
        (B, F) float32.  Padding lanes carry garbage; callers slice them
        off.  At most one lane per live slot.  Sharded, each block steps
        its own lanes and the probabilities come back in lane order on
        :attr:`device`."""
        slots = np.asarray(slots, np.int64)
        if slots.ndim != 1 or slots.size == 0 or (
                slots.min() < 0 or slots.max() > self.padding_slot):
            raise IndexError(
                f"slots must be a (B,) list of slots 0..{self.padding_slot}")
        rows = np.asarray(rows, np.float32)
        if rows.shape != (slots.size, self.cfg.n_features):
            raise ValueError(
                f"rows must be (B, F) = {(slots.size, self.cfg.n_features)},"
                f" got {rows.shape}")
        if self.n_shards == 1:
            return self._blocks[0].step(slots, rows)
        block_of = slots // self._block_size
        order = np.argsort(block_of, kind="stable")
        parts = []
        for b in np.unique(block_of):
            lanes = order[block_of[order] == b]
            blk = self._blocks[b]
            parts.append(blk.step(slots[lanes] - blk.start, rows[lanes]).to(
                self.device, non_blocking=True))
        # the blocks' lanes in block order, put back in lane order
        (back,) = self._staging.to_device(
            "order", (np.argsort(order).astype(np.int64),), self.device)
        return torch.cat(parts)[back]

    def step(self, slots, rows) -> np.ndarray:
        """Blocking :meth:`step_device`: probabilities as a host array."""
        return self.step_device(slots, rows).float().cpu().numpy()
