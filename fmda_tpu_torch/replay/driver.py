"""The replay driver: a max-speed backfill on a virtual clock through the
live serving path, as ``fmda_tpu.replay.driver`` drives it.

A :class:`ReplayDriver` run reads a history source round by round,
coalesces each round into the columnar tick block
(``stream/codec.pack_ticks``, optionally round-tripped through the binary
or JSON wire dialect, the bytes a fleet link would carry), feeds it to the
gateway's unmodified ``submit``/``pump`` surface and force-flushes: no
linger, no cadence, no wall-clock pacing.  The virtual clock is the rows'
own timestamps; the host clock is read only for throughput telemetry
(rows/s), never for pacing or ordering.

The driver speaks the duck-typed gateway surface of
:func:`fmda_tpu_torch.runtime.loadgen.run_fleet_load`: a solo in-process
:class:`~fmda_tpu_torch.runtime.gateway.FleetGateway`.  Where the
reference's summary carries the pool's ``compile_count``, this one carries
``kernel_launches_by_bucket``, as the port's load generator does.
"""

from __future__ import annotations

import time
from datetime import datetime, timezone
from typing import Dict, List, Optional

import numpy as np

from fmda_tpu_torch.runtime.loadgen import (
    FleetLoadConfig,
    assign_tenants,
    launches_by_bucket,
)
from fmda_tpu_torch.stream import codec


def open_replay_sessions(
    gateway,
    source,
    *,
    tenant_classes: tuple = (),
    tenant_weights: tuple = (),
    seed: int = 0,
) -> List[str]:
    """Open one gateway session per source ticker — loadgen's naming
    (``T0000``…) and, when a tenant mix is configured, loadgen's own
    :func:`~fmda_tpu_torch.runtime.loadgen.assign_tenants` over the ticker
    universe, so QoS/capacity A/Bs run against replay load exactly as
    they run against synthetic load.  Shared by the replay driver and
    the cadence-paced live reference (identical admission is half of
    the identity gate)."""
    n = source.n_tickers
    session_ids = [f"T{i:04d}" for i in range(n)]
    tenants = assign_tenants(
        FleetLoadConfig(
            n_sessions=n, tenant_classes=tuple(tenant_classes),
            tenant_weights=tuple(tenant_weights)),
        np.random.default_rng(seed))
    norms = getattr(source, "norms", None)
    for i, sid in enumerate(session_ids):
        norm = norms[i] if norms is not None else None
        if tenants is None:
            gateway.open_session(sid, norm)
        else:
            gateway.open_session(sid, norm, tenant=tenants[i])
    return session_ids


class ReplayDriver:
    """Drive one backfill through a gateway at max speed.

    ``wire_dialect`` (solo gateways only): ``None`` hands decoded
    blocks straight over; ``"binary"``/``"json"`` round-trips every
    block through that wire dialect first — the bit-identity tests run
    both, because a backfill's bytes must decode to the same floats a
    live fleet link delivers.  ``collect`` keeps every
    :class:`~fmda_tpu_torch.runtime.gateway.FleetResult` on ``.results`` for
    identity comparison (off for long backfills — it is O(rows)
    memory).
    """

    def __init__(
        self,
        gateway,
        source,
        *,
        tenant_classes: tuple = (),
        tenant_weights: tuple = (),
        seed: int = 0,
        wire_dialect: Optional[str] = None,
        collect: bool = False,
        on_round=None,
        quality=None,
    ) -> None:
        if wire_dialect not in (None, "binary", "json"):
            raise ValueError(
                f"wire_dialect must be None, 'binary' or 'json', "
                f"got {wire_dialect!r}")
        self.gateway = gateway
        self.source = source
        self.tenant_classes = tuple(tenant_classes)
        self.tenant_weights = tuple(tenant_weights)
        self.seed = seed
        self.wire_dialect = wire_dialect
        self.collect = collect
        self.on_round = on_round
        #: optional fmda_tpu_torch.obs.quality.QualityEvaluator: every served
        #: result is captured for label join (keyed by its row's
        #: warehouse timestamp), and the join runs on the VIRTUAL clock
        #: — cadence-gated off the tick path, deterministic in replay
        self.quality = quality
        self.results: List = []
        #: per-ticker virtual timestamp of the last dispatched row
        self._ticker_ts: Optional[np.ndarray] = None
        #: (session, seq) -> (timestamp string, feature row) for results
        #: still in flight; popped as results land (bounded by inflight)
        self._quality_keys: Dict = {}
        self._watermark = 0.0

    # -- progress observability (obs gauges; `status` renders these) -----

    def _publish_progress(self, rows: int, wall_s: float) -> None:
        m = self.gateway.metrics
        m.gauge("replay_rows_per_s",
                rows / wall_s if wall_s > 0 else 0.0)
        m.gauge("replay_virtual_watermark", self._watermark)
        if self._ticker_ts is not None:
            seen = self._ticker_ts[self._ticker_ts > 0.0]
            lag = (self._watermark - float(seen.min())) if seen.size else 0.0
            m.gauge("replay_max_ticker_lag_s", lag)

    # -- the backfill loop ----------------------------------------------

    def run(self) -> Dict:
        gateway = self.gateway
        source = self.source
        pool = getattr(gateway, "pool", None)
        session_ids = open_replay_sessions(
            gateway, source, tenant_classes=self.tenant_classes,
            tenant_weights=self.tenant_weights, seed=self.seed)
        self._ticker_ts = np.zeros(len(session_ids), np.float64)
        seqs = [0] * len(session_ids)
        binary = self.wire_dialect == "binary"

        m = gateway.metrics
        m.gauge("replay_active", 1.0)
        submitted = 0
        served = 0
        rounds = 0
        virtual_start: Optional[float] = None
        # telemetry only: rows/s against the host clock; the virtual
        # clock below never reads it
        t0 = time.perf_counter()
        try:
            for batch in source:
                if virtual_start is None:
                    virtual_start = batch.virtual_ts
                self._watermark = max(self._watermark, batch.virtual_ts)
                msgs = []
                for k, ti in enumerate(batch.tickers):
                    ti = int(ti)
                    msgs.append({
                        "kind": "tick",
                        "session": session_ids[ti],
                        "row": batch.rows[k],
                        "seq": seqs[ti],
                    })
                    if self.quality is not None:
                        ts = (batch.timestamps[k] if batch.timestamps
                              else _virtual_ts_str(batch.virtual_ts))
                        self._quality_keys[
                            (session_ids[ti], seqs[ti])] = (
                                ts, batch.rows[k])
                    seqs[ti] += 1
                    self._ticker_ts[ti] = batch.virtual_ts
                if pool is not None and len(msgs) >= codec.MIN_BLOCK_TICKS:
                    # solo gateway: coalesce the round into ONE columnar
                    # block — the same bytes a fleet worker would decode
                    wire_msgs = [codec.pack_ticks(msgs)]
                else:
                    wire_msgs = msgs
                if self.wire_dialect is not None:
                    wire_msgs = [
                        codec.decode_payload(
                            codec.encode_payload(w, binary=binary))[0]
                        for w in wire_msgs]
                for w in wire_msgs:
                    if w.get("kind") == "tick_block":
                        ticks = codec.iter_ticks(w)
                    else:
                        ticks = [(w["session"], w["row"], w["seq"], None)]
                    for sid, row, _seq, _trace in ticks:
                        while gateway.saturated:
                            # a well-behaved producer under backpressure
                            # drains instead of racing the shedder
                            drained = gateway.pump(force=True)
                            served += self._keep(drained)
                            if not drained and gateway.saturated:
                                time.sleep(0.002)
                        gateway.submit(sid, np.asarray(row))
                        submitted += 1
                served += self._keep(gateway.pump(force=True))
                rounds += 1
                m.count("replay_rows", len(msgs))
                if rounds % 32 == 0:
                    now = time.perf_counter()
                    self._publish_progress(submitted, now - t0)
                if self.on_round is not None:
                    self.on_round(rounds - 1)
                if self.quality is not None:
                    # the join cadence rides the VIRTUAL clock — the
                    # same rows produce the same join/expiry schedule
                    # on every replay, no wall-clock involved
                    self.quality.maybe_join(now=batch.virtual_ts)
            served += self._keep(gateway.drain())
        finally:
            m.gauge("replay_active", 0.0)
        wall_s = time.perf_counter() - t0
        self._publish_progress(submitted, wall_s)

        summary = gateway.metrics.summary()
        watermark = self._watermark
        seen = self._ticker_ts[self._ticker_ts > 0.0]
        out = {
            "sessions": len(session_ids),
            "rounds": rounds,
            "rows_replayed": submitted,
            "ticks_served": served,
            "wall_s": round(wall_s, 3),
            "rows_per_s": round(submitted / wall_s, 1) if wall_s > 0
            else None,
            "ticks_per_s": round(served / wall_s, 1) if wall_s > 0
            else None,
            "virtual_start_epoch": virtual_start,
            "virtual_watermark_epoch": watermark,
            "virtual_span_s": round(watermark - virtual_start, 3)
            if virtual_start is not None else 0.0,
            "max_ticker_lag_s": round(
                watermark - float(seen.min()), 3) if seen.size else 0.0,
            "kernel_launches_by_bucket": launches_by_bucket(gateway),
            "wire_dialect": self.wire_dialect,
            **summary,
        }
        return out

    def _keep(self, results) -> int:
        if self.collect and results:
            self.results.extend(results)
        if self.quality is not None and results:
            for r in results:
                key = self._quality_keys.pop((r.session_id, r.seq), None)
                if key is None:
                    continue  # pre-attach or replayed-duplicate result
                ts, row = key
                self.quality.capture(
                    r.session_id, ts, r.probabilities,
                    weights_version=getattr(r, "weights_version", None),
                    features=row)
        return len(results)


def _virtual_ts_str(virtual_ts: float) -> str:
    """Virtual epoch -> warehouse-format timestamp string (a pure
    conversion of replay data, not a clock read) — synthetic sources
    get join keys in the same space warehouse rows use."""
    return datetime.fromtimestamp(
        virtual_ts, tz=timezone.utc).strftime("%Y-%m-%d %H:%M:%S")
