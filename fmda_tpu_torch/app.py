"""Application: the port's composition root, as ``fmda_tpu.app`` builds it.

One :class:`~fmda_tpu_torch.config.FrameworkConfig` builds the whole stack:

    app = Application(FrameworkConfig())
    app.attach_session(iex=..., alpha_vantage=..., calendar=...)
    app.run_ticks(...)                 # acquire -> join -> land -> signal
    state, history, dataset = app.train()
    app.attach_predictor_from_checkpoint(ckpt, window=30)

The bus is the native C++ ring bus when it builds (the Python bus
otherwise, logged), the warehouse the embedded SQLite one, wrapped in the
write-ahead journal when ``warehouse.journal_path`` is set; the engine's
join scheduler follows ``engine.join_backend``.  Models run on the card
unless ``device="cpu"`` is given: the device is resolved by each model a
method builds, so an application that only ingests needs no card.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

from fmda_tpu_torch.config import FrameworkConfig
from fmda_tpu_torch.stream.bus import InProcessBus, MessageBus
from fmda_tpu_torch.stream.engine import StreamEngine
from fmda_tpu_torch.stream.warehouse import Warehouse

log = logging.getLogger("fmda_tpu_torch")


def default_bus(config: FrameworkConfig) -> MessageBus:
    """The native C++ ring bus when it builds and loads, else the Python
    bus (logged)."""
    try:
        from fmda_tpu_torch.stream.native_bus import (
            NativeBus,
            native_available,
        )

        if native_available():
            return NativeBus(config.bus.topics,
                             max_records=config.bus.capacity)
        log.warning("native bus unavailable; using InProcessBus")
    except Exception as e:  # noqa: BLE001 - fall back, never fail startup
        log.warning("native bus unavailable (%s); using InProcessBus", e)
    return InProcessBus(config.bus.topics, capacity=config.bus.capacity)


class Application:
    """Bus + warehouse + engine, and the sessions, predictors and fleet
    attached to them."""

    def __init__(
        self,
        config: Optional[FrameworkConfig] = None,
        *,
        bus: Optional[MessageBus] = None,
        warehouse: Optional[Warehouse] = None,
        engine_checkpoint: Optional[str] = None,
        device=None,
    ) -> None:
        from fmda_tpu_torch.obs import Observability

        self.config = config or FrameworkConfig()
        #: where attached models and training run (None: the card)
        self.device = device
        tc = self.config.tracing
        if tc.enabled:
            # the process tracer is a singleton configured in place, so
            # components that captured it stay live; an app config never
            # disables a tracer another component enabled
            from fmda_tpu_torch.obs.trace import configure_tracing

            configure_tracing(enabled=True, sample_rate=tc.sample_rate,
                              capacity=tc.max_spans)
        #: metrics registry, event log, health checks and the optional
        #: scrape endpoint; feeds :attr:`stats` and :attr:`stage_timings`
        self.observability = Observability(self.config.observability)
        reg = self.observability.registry
        self.bus = bus if bus is not None else default_bus(self.config)
        self.warehouse = (warehouse if warehouse is not None
                          else Warehouse(self.config.features,
                                         self.config.warehouse))
        wc = self.config.warehouse
        if wc.journal_path and warehouse is None:
            # a refused landing spills to the journal and backfills on
            # recovery (an injected warehouse keeps its own durability)
            from fmda_tpu_torch.stream.journal import BufferedWarehouse

            self.warehouse = BufferedWarehouse(
                self.warehouse, wc.journal_path, bound=wc.journal_bound,
                fmt=wc.journal_format)
        ec = self.config.engine
        try:
            self.engine = StreamEngine(
                self.bus, self.warehouse, self.config.features,
                checkpoint_path=(engine_checkpoint
                                 if engine_checkpoint is not None
                                 else ec.checkpoint_path),
                checkpoint_every=ec.checkpoint_every,
                join_backend=ec.join_backend,
                staleness_deadline_s=ec.staleness_deadline_s,
                metrics=reg if reg.enabled else None)
        except Exception:
            if warehouse is None:
                self.warehouse.close()
            self.observability.close()
            raise
        self.session = None
        self.predictors: List = []
        self.fleet = None
        self.observability.track_app(self)
        if self.config.observability.endpoint_enabled:
            self.observability.start_server()

    # -- acquisition ----------------------------------------------------------

    def attach_session(self, **clients):
        """The ingestion session driver on this app's bus; the keywords are
        :class:`~fmda_tpu_torch.ingest.session.SessionDriver`'s clients
        (iex, alpha_vantage, calendar, indicator_scraper, vix_scraper,
        cot_scraper, now_fn, sleep_fn)."""
        from fmda_tpu_torch.ingest.session import SessionDriver

        self.session = SessionDriver(self.bus, self.config.session,
                                     **clients)
        return self.session

    # -- serving --------------------------------------------------------------

    def attach_predictor_from_checkpoint(self, checkpoint_path: str, *,
                                         window: int, **kwargs):
        """The window-re-scan Predictor on this app's bus and warehouse,
        from a port checkpoint."""
        from fmda_tpu_torch.serve.predictor import Predictor

        kwargs.setdefault("device", self.device)
        predictor = Predictor.from_checkpoint(
            checkpoint_path, self.bus, self.warehouse, self.config.model,
            window=window, **kwargs)
        self.predictors.append(predictor)
        return predictor

    def attach_predictor_fleet(self, model_cfg, params, norm_params,
                               **gateway_kwargs):
        """The batched window-re-scan Predictor (a
        :class:`~fmda_tpu_torch.runtime.PredictorGateway` over a
        :class:`~fmda_tpu_torch.runtime.PredictorPool`), sized by the
        ``runtime.predictor_*`` knobs.  It joins :attr:`predictors`, so
        :meth:`run_tick` polls it as it polls a solo Predictor."""
        from fmda_tpu_torch.runtime import (
            BatcherConfig,
            PredictorGateway,
            PredictorPool,
        )

        rc = self.config.runtime
        window = (rc.predictor_window if rc.predictor_window is not None
                  else rc.window)
        pool = PredictorPool(model_cfg, params, norm_params, window=window,
                             use_ring=rc.predictor_ring, device=self.device)
        gateway_kwargs.setdefault("batcher_config", BatcherConfig(
            bucket_sizes=tuple(rc.predictor_bucket_sizes),
            max_linger_s=rc.predictor_max_linger_ms / 1e3))
        gateway_kwargs.setdefault("queue_bound", rc.predictor_queue_bound)
        gateway_kwargs.setdefault("pipeline_depth", rc.pipeline_depth)
        gateway_kwargs.setdefault("threshold",
                                  self.config.train.prob_threshold)
        gateway = PredictorGateway(pool, self.bus, self.warehouse,
                                   **gateway_kwargs)
        self.predictors.append(gateway)
        self.observability.track_predictor_fleet(gateway)
        return gateway

    def attach_predictor_fleet_from_checkpoint(self, checkpoint_path: str,
                                               model_cfg=None,
                                               **gateway_kwargs):
        """:meth:`attach_predictor_fleet` from a port checkpoint (weights
        and norm stats in one file)."""
        from fmda_tpu_torch.train.checkpoint import restore_checkpoint

        tree, norm = restore_checkpoint(checkpoint_path)
        if norm is None:
            raise ValueError(
                f"checkpoint {checkpoint_path} has no normalization stats")
        return self.attach_predictor_fleet(
            model_cfg if model_cfg is not None else self.config.model,
            tree["params"], norm, **gateway_kwargs)

    def attach_streaming_predictor(self, core, **kwargs):
        """A carried-state predictor over ``core`` (a ``StreamingBiGRU``:
        O(1) a tick; the bidirectional core: O(window) a tick)."""
        from fmda_tpu_torch.serve.streaming import StreamingPredictor

        predictor = StreamingPredictor(self.bus, self.warehouse, core,
                                       **kwargs)
        self.predictors.append(predictor)
        return predictor

    def attach_fleet(self, model_cfg, params, **gateway_kwargs):
        """The multi-tenant serving runtime on this app's bus, sized by
        ``config.runtime``: the slot pool, the micro-batcher and the
        admission-controlled :class:`~fmda_tpu_torch.runtime.FleetGateway`.
        ``model_cfg`` must be a unidirectional recurrent config; the
        keywords override the gateway's defaults.  With
        ``runtime.shard_pool`` the pool's slots are split over the dp axis
        of a mesh built from ``[mesh]`` over the visible cards (on the
        CPU, the one device); a 1-device mesh is the unsharded pool."""
        from fmda_tpu_torch.runtime import (
            BatcherConfig,
            FleetGateway,
            SessionPool,
        )

        rc = self.config.runtime
        mesh = None
        if rc.shard_pool:
            import torch

            from fmda_tpu_torch.device import resolve_device
            from fmda_tpu_torch.parallel import build_mesh

            dev = resolve_device(self.device)
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if dev.type == "cuda" else [dev])
            mesh = build_mesh(self.config.mesh, devices=devices)
        pool = SessionPool(model_cfg, params, capacity=rc.capacity,
                           window=rc.window, device=self.device, mesh=mesh,
                           shard_axis=self.config.mesh.dp_axis)
        gateway_kwargs.setdefault("batcher_config", BatcherConfig(
            bucket_sizes=tuple(rc.bucket_sizes),
            max_linger_s=rc.max_linger_ms / 1e3))
        gateway_kwargs.setdefault("queue_bound", rc.queue_bound)
        gateway_kwargs.setdefault("pipeline_depth", rc.pipeline_depth)
        # the solo serving paths' decision threshold
        gateway_kwargs.setdefault("threshold",
                                  self.config.train.prob_threshold)
        self.fleet = FleetGateway(pool, self.bus, **gateway_kwargs)
        self.observability.track_fleet(self.fleet)
        return self.fleet

    # -- the loop -------------------------------------------------------------

    def run_tick(self) -> Dict[str, int]:
        """One cycle: acquire (when a session is attached), one engine
        micro-batch, then every attached predictor polls."""
        if self.session is not None:
            self.session.run_tick()
        emitted = self.engine.step()
        served = 0
        for predictor in self.predictors:
            served += len(predictor.poll())
        self.observability.tick()
        return {"emitted": emitted, "served": served}

    def run_ticks(self, n: int) -> Dict[str, int]:
        totals = {"emitted": 0, "served": 0}
        for _ in range(n):
            out = self.run_tick()
            totals["emitted"] += out["emitted"]
            totals["served"] += out["served"]
        return totals

    # -- training -------------------------------------------------------------

    def train(self, *, weight=None, pos_weight=None, mesh=None,
              **fit_kwargs):
        """Train the configured model on this app's warehouse; returns
        ``Trainer.fit``'s ``(state, history, dataset)``.  Without weights,
        the imbalance weights of the whole target table.  ``mesh`` (a
        mesh of ranks, :func:`fmda_tpu_torch.parallel.build_mesh`) trains
        data parallel over its ``dp`` axis, as ``Trainer(mesh=)`` does; the
        trainer then runs on the mesh's device."""
        from fmda_tpu_torch.train.trainer import (
            Trainer,
            imbalance_weights_from_source,
        )

        if weight is None and pos_weight is None:
            weight, pos_weight = imbalance_weights_from_source(self.warehouse)
        trainer = Trainer(self.config.model, self.config.train,
                          weight=weight, pos_weight=pos_weight,
                          device=None if mesh is not None else self.device,
                          mesh=mesh)
        fc = self.config.features
        return trainer.fit(self.warehouse, bid_levels=fc.bid_levels,
                           ask_levels=fc.ask_levels, **fit_kwargs)

    def run_forever(self, *, interval_s: float = 1.0, max_restarts: int = 5,
                    sleep_fn=None, should_stop=None) -> None:
        """The supervised loop: tick, sleep, repeat.  A failing tick is
        logged as an ``app.tick_error`` event and retried with exponential
        backoff, up to ``max_restarts`` consecutive failures (then it
        raises).  An engine checkpoint makes a restart resume exactly."""
        sleep_fn = sleep_fn or time.sleep
        failures = 0
        while not (should_stop is not None and should_stop()):
            try:
                self.run_tick()
                failures = 0
                sleep_fn(interval_s)
            except Exception as e:
                failures += 1
                self.observability.events.emit(
                    "app.tick_error", error=repr(e)[:500],
                    consecutive=failures)
                log.exception(
                    "tick failed (%d consecutive); %s", failures,
                    "giving up" if failures > max_restarts
                    else "backing off")
                if failures > max_restarts:
                    raise
                sleep_fn(min(interval_s * (2 ** failures), 60.0))

    def close(self) -> None:
        """Release the observability plane (the endpoint's thread, the
        events file).  The bus and warehouse stay with their owners:
        ``warehouse.close()`` is explicit."""
        self.observability.close()

    @property
    def stats(self) -> Dict[str, object]:
        """The engine's counters and the warehouse's rows, plus the
        attached fleet's runtime metrics."""
        s: Dict[str, object] = {**self.engine.stats,
                                "warehouse_rows": len(self.warehouse)}
        if self.fleet is not None:
            s["fleet"] = self.fleet.metrics.summary()
        return s

    @property
    def stage_timings(self) -> Dict[str, Dict[str, float]]:
        """Host wall clock per stage: the engine's ingest, join, land and
        signal, plus the attached fleet's stages as ``fleet.<stage>``."""
        timings = dict(self.engine.timer.summary())
        if self.fleet is not None:
            for name, stats in self.fleet.metrics.timer.summary().items():
                timings[f"fleet.{name}"] = stats
        return timings
