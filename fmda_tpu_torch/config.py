"""Configuration the ported slices read, kept as their own copy.

The same frozen dataclasses as ``fmda_tpu.config`` (field names, defaults
and the config -> schema codegen of :class:`FeatureConfig`), cut to what
the ported paths read: the feature schema, the warehouse, the model, the
training config, the fleet runtime config (without ``shard_pool``), the
multi-host topology (``fleet``), the quality plane's knobs, the
observability plane's (``observability``, ``tracing``, ``profiling``
without ``cost_analysis``), the fleet telemetry's (``slo``), chaos's,
replay's, and two keys of ``control``.  A
JSON file that ``fmda_tpu.config.save_config`` wrote loads here too, and
a file the reference would refuse is refused: :func:`config_from_dict`
checks every section and key against :data:`REFERENCE_KEYS`, the
reference's own table, and raises on anything outside it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

#: The five raw feeds the streaming engine joins.
TOPIC_VIX = "vix"
TOPIC_VOLUME = "volume"
TOPIC_COT = "cot"
TOPIC_IND = "ind"
TOPIC_DEEP = "deep"
TOPIC_PREDICT_TIMESTAMP = "predict_timestamp"
TOPIC_PREDICTION = "prediction"
#: Fleet-serving results (:mod:`fmda_tpu_torch.runtime`): one topic,
#: per-session consumption keyed on the message's ``session`` field.
TOPIC_FLEET_PREDICTION = "fleet_prediction"
#: Multi-host fleet control plane (:mod:`fmda_tpu_torch.fleet`): worker
#: hello/heartbeat/goodbye, ownership-table announcements, migrated
#: session state.  Not in DEFAULT_TOPICS: only fleet topologies carry it
#: (:func:`fleet_topics` adds it beside the per-worker inboxes).
TOPIC_FLEET_CONTROL = "fleet_control"
#: Per-worker tick-inbox topic prefix: the router publishes a worker's
#: opens/ticks/closes/drains to ``fleet_ticks_<worker_id>`` in routing
#: order; the inbox's FIFO offsets are the ordering guarantee the
#: migration protocol leans on.
TOPIC_FLEET_TICKS_PREFIX = "fleet_ticks_"
DEFAULT_TOPICS: Tuple[str, ...] = (
    TOPIC_VIX, TOPIC_VOLUME, TOPIC_COT, TOPIC_IND, TOPIC_DEEP,
    TOPIC_PREDICT_TIMESTAMP, TOPIC_PREDICTION, TOPIC_FLEET_PREDICTION)


def fleet_worker_topic(worker_id: str) -> str:
    """The tick-inbox topic of one fleet worker."""
    return TOPIC_FLEET_TICKS_PREFIX + worker_id


def fleet_topics(worker_ids) -> Tuple[str, ...]:
    """Every extra topic a fleet topology needs on its bus: the control
    plane plus one inbox per worker (append to ``DEFAULT_TOPICS`` when
    constructing the topology's bus)."""
    return (TOPIC_FLEET_CONTROL,) + tuple(
        fleet_worker_topic(w) for w in worker_ids)


@dataclass(frozen=True)
class BusConfig:
    """Message-bus layout."""

    topics: Tuple[str, ...] = DEFAULT_TOPICS
    #: Ring-buffer capacity per topic (records).
    capacity: int = 1 << 16
    #: External Kafka brokers (:class:`~fmda_tpu_torch.stream.kafka_bus.
    #: KafkaBus`).
    servers: Tuple[str, ...] = ("localhost:9092",)


@dataclass(frozen=True)
class WarehouseConfig:
    """The warehouse: embedded SQLite (the same file layout ``fmda_tpu``
    writes), or MariaDB/MySQL through
    :class:`~fmda_tpu_torch.stream.mysql_warehouse.MySQLWarehouse`, which
    reads ``database_name``, ``user``, ``password``, ``hostname`` and
    ``port``."""

    backend: str = "sqlite"
    path: str = ":memory:"
    database_name: str = "stock_data"
    table_name: str = "stock_data_joined"
    #: Write-ahead journal of :class:`~fmda_tpu_torch.stream.journal.
    #: BufferedWarehouse`: rows the store refuses spill here and drain
    #: back on recovery.  None: no journal (a failed insert raises).
    journal_path: Optional[str] = None
    #: Bound on journaled rows; overflow sheds the oldest, counted.
    journal_bound: int = 65536
    #: Journal record layout: ``jsonl`` (a JSON line a row) or ``binary``
    #: (length-prefixed codec frames); recovery reads either.
    journal_format: str = "jsonl"
    # the MySQL backend's connection (unused by SQLite)
    user: str = "admin"
    password: str = "admin"
    hostname: str = "localhost"
    port: int = 3306


DEFAULT_EVENT_LIST: Tuple[str, ...] = (
    "Crude Oil Inventories",
    "ISM Non-Manufacturing PMI",
    "ISM Non-Manufacturing Employment",
    "Services PMI",
    "ADP Nonfarm Employment Change",
    "Core CPI",
    "Fed Interest Rate Decision",
    "Building Permits",
    "Core Retail Sales",
    "Retail Sales",
    "JOLTs Job Openings",
    "Nonfarm Payrolls",
    "Unemployment Rate",
)

EVENT_VALUES: Tuple[str, ...] = ("Actual", "Prev_actual_diff", "Forc_actual_diff")

VOLUME_COLUMNS: Tuple[str, ...] = (
    "1_open",
    "2_high",
    "3_low",
    "4_close",
    "5_volume",
    "wick_prct",
)

COT_GROUPS: Tuple[str, ...] = ("Asset", "Leveraged")
COT_VALUES: Tuple[str, ...] = (
    "long_pos",
    "long_pos_change",
    "long_open_int",
    "short_pos",
    "short_pos_change",
    "short_open_int",
)

TARGET_COLUMNS: Tuple[str, ...] = ("up1", "up2", "down1", "down2")


def sanitize_event(event_name: str) -> str:
    """Event name -> column stem."""
    return event_name.replace(" ", "_").replace("-", "_")


@dataclass(frozen=True)
class FeatureConfig:
    """Feature-engineering knobs and the schema they generate.

    The stochastic oscillator and ATR windows are ``N PRECEDING AND
    CURRENT ROW`` frames, i.e. N+1 rows; the moving averages are
    ``period``-row frames.
    """

    get_cot: bool = True
    get_vix: bool = True
    get_stock_volume: Optional[str] = "SPY"

    bid_levels: int = 7
    ask_levels: int = 7

    volume_ma_periods: Tuple[int, ...] = (6, 20)
    price_ma_periods: Tuple[int, ...] = (20,)
    delta_ma_periods: Tuple[int, ...] = (12,)

    bollinger_period: int = 20
    bollinger_std: float = 2.0

    stochastic_oscillator: bool = True
    stoch_preceding: int = 14
    atr_preceding: int = 14

    event_list: Tuple[str, ...] = DEFAULT_EVENT_LIST

    target_n1: float = 1.5
    target_n2: float = 3.0
    target_lead1: int = 8
    target_lead2: int = 15

    #: Stream alignment: timestamps floor to this many seconds, and a side
    #: feed joins a book tick when its timestamp lies within
    #: ``join_tolerance_s`` after the tick's; the watermark trails each
    #: feed's newest event by ``watermark_s``.
    floor_s: int = 5 * 60
    join_tolerance_s: int = 3 * 60
    watermark_s: int = 5 * 60

    @property
    def event_list_repl(self) -> Tuple[str, ...]:
        return tuple(sanitize_event(e) for e in self.event_list)

    def empty_ind_message(self) -> dict:
        """The economic-indicator message template, every value 0."""
        msg: dict = {"Timestamp": 0}
        for event in self.event_list_repl:
            msg[event] = {value: 0 for value in EVENT_VALUES}
        return msg

    def deep_columns(self) -> Tuple[str, ...]:
        """Order-book columns: sizes for all levels, rebased prices for
        levels 1.., then the microstructure scalars and calendar one-hots."""
        cols = []
        cols += [f"bid_{i}_size" for i in range(self.bid_levels)]
        cols += [f"bid_{i}" for i in range(1, self.bid_levels)]
        cols += [f"ask_{i}_size" for i in range(self.ask_levels)]
        cols += [f"ask_{i}" for i in range(1, self.ask_levels)]
        cols += [
            "bids_ord_WA",
            "asks_ord_WA",
            "vol_imbalance",
            "delta",
            "micro_price",
            "spread",
            "session_start",
            "day_1",
            "day_2",
            "day_3",
            "day_4",
            "week_1",
            "week_2",
            "week_3",
            "week_4",
        ]
        return tuple(cols)

    def vix_columns(self) -> Tuple[str, ...]:
        return ("VIX",) if self.get_vix else ()

    def volume_columns(self) -> Tuple[str, ...]:
        return VOLUME_COLUMNS if self.get_stock_volume else ()

    def cot_columns(self) -> Tuple[str, ...]:
        if not self.get_cot:
            return ()
        return tuple(f"{g}_{v}" for g in COT_GROUPS for v in COT_VALUES)

    def ind_columns(self) -> Tuple[str, ...]:
        return tuple(
            f"{event}_{value}"
            for event in self.event_list_repl
            for value in EVENT_VALUES
        )

    def table_columns(self) -> Tuple[str, ...]:
        """Feature columns of the joined warehouse table in DDL order,
        excluding ID and Timestamp."""
        return (
            self.deep_columns()
            + self.vix_columns()
            + self.volume_columns()
            + self.cot_columns()
            + self.ind_columns()
        )

    def derived_columns(self) -> Tuple[str, ...]:
        """Windowed-indicator columns: BB, vol_MA, price_MA, delta_MA,
        stoch, ATR, price_change.  Every OHLC-derived view needs the volume
        feed; without it only ``delta_MA`` survives."""
        has_ohlc = bool(self.get_stock_volume)
        cols = []
        if has_ohlc and self.bollinger_period and self.bollinger_std:
            cols += ["upper_BB_dist", "lower_BB_dist"]
        if has_ohlc:
            cols += [f"vol_MA{p}" for p in self.volume_ma_periods]
            cols += [f"price_MA{p}" for p in self.price_ma_periods]
        cols += [f"delta_MA{p}" for p in self.delta_ma_periods]
        if has_ohlc and self.stochastic_oscillator:
            cols += ["stoch"]
        if has_ohlc:
            cols += ["ATR", "price_change"]
        return tuple(cols)

    @property
    def max_lookback(self) -> int:
        """Longest trailing frame any derived view needs (rows)."""
        frames = [2]
        if self.get_stock_volume:
            if self.bollinger_period and self.bollinger_std:
                frames.append(self.bollinger_period)
            frames.extend(self.volume_ma_periods)
            frames.extend(self.price_ma_periods)
            if self.stochastic_oscillator:
                frames.append(self.stoch_preceding + 1)
            frames.append(self.atr_preceding + 1)
        frames.extend(self.delta_ma_periods)
        return max(frames)

    @property
    def max_lead(self) -> int:
        """Longest LEAD the target view uses (rows)."""
        return max(self.target_lead1, self.target_lead2)

    def x_fields(self) -> Tuple[str, ...]:
        """The model's input schema: table columns, then derived columns
        (108 features with the defaults)."""
        return self.table_columns() + self.derived_columns()

    @property
    def n_features(self) -> int:
        return len(self.x_fields())


#: The ``ModelConfig.cell`` values the port runs: every family the
#: reference has.
PORTED_CELLS = ("gru", "lstm", "ssm", "attn")


@dataclass(frozen=True)
class ModelConfig:
    """Recurrent classifier hyperparameters.  ``n_features=None`` means
    "derive from the feature schema" (resolved by
    :class:`FrameworkConfig`)."""

    hidden_size: int = 32
    n_features: Optional[int] = None
    output_size: int = len(TARGET_COLUMNS)
    n_layers: int = 1
    dropout: float = 0.5
    spatial_dropout: bool = True
    bidirectional: bool = True
    #: Sequence-core family: "gru" (the reference's model), "lstm" (the
    #: same head over an LSTM core), "ssm" (the gated diagonal linear
    #: recurrence with an EMA head, served from an O(1) cache) or "attn"
    #: (a pre-LN transformer encoder over the flash-attention kernels).
    cell: str = "gru"
    #: cell="attn": attention heads; must divide hidden_size.
    n_heads: int = 4
    #: cell="attn": causal attention (each position sees only its past).
    attn_causal: bool = False
    #: cell="attn": residual dropout of the encoder blocks; None means
    #: ``dropout``.
    attn_dropout: Optional[float] = None
    #: cell="ssm": each channel's decay offset ``a_base`` is initialised so
    #: ``sigmoid(a_base)`` is uniform in this range.
    ssm_decay_range: Tuple[float, float] = (0.9, 0.999)
    #: cell="ssm": initial (fast, slow) head-EMA rates.
    ssm_ema_init: Tuple[float, float] = (0.6, 0.98)
    #: Compute dtype for the recurrent core and head; params stay float32.
    dtype: str = "float32"
    #: Recompute in the backward pass instead of keeping the forward's
    #: intermediates: each attn encoder block, and the gru/lstm scans'
    #: plain (CPU) path (the kernel pair keeps only ``hs`` already).
    remat: bool = False

    def __post_init__(self) -> None:
        if self.cell not in PORTED_CELLS:
            raise ValueError(
                f"unknown ModelConfig.cell {self.cell!r}; expected one of "
                f"{sorted(PORTED_CELLS)}")


@dataclass(frozen=True)
class TrainConfig:
    """Training-harness hyperparameters, with ``fmda_tpu``'s defaults."""

    batch_size: int = 2
    window: int = 30
    chunk_size: int = 100
    learning_rate: float = 1e-3
    epochs: int = 25
    clip: float = 50.0
    val_size: float = 0.1
    test_size: float = 0.1
    fbeta_beta: float = 0.5
    prob_threshold: float = 0.5
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    #: Microbatch gradient-accumulation factor K: the batch is split into
    #: K equal microbatches whose gradients sum to the full batch's.
    #: Must divide ``batch_size``.
    accum_steps: int = 1
    #: Composed and placed batches in flight ahead of the step; 0 is the
    #: synchronous loop with no background thread.
    prefetch_depth: int = 2
    #: Chunks whose normalized windows (and placed batches) are kept for
    #: later epochs; 0 disables the caches.
    cache_chunks: int = 64
    #: Continuous fine-tuning (``ContinuousTrainer``): fresh rows that
    #: must land in the warehouse before a fine-tune round fires.
    continuous_min_rows: int = 256
    #: Sliding history window (rows) each round trains over.
    continuous_window_rows: int = 2048
    #: Epochs per fine-tune round (warm-started from the last round).
    continuous_epochs: int = 1
    #: Consecutive empty tail polls before the follow reader concludes
    #: the warehouse has quiesced and the loop drains and exits.
    continuous_follow_polls: int = 8
    #: Wall seconds between empty tail polls (tests inject a waiter).
    continuous_poll_s: float = 1.0

    def __post_init__(self) -> None:
        if self.accum_steps < 1:
            raise ValueError(
                f"train.accum_steps must be >= 1, got {self.accum_steps}")
        if self.batch_size % self.accum_steps != 0:
            raise ValueError(
                f"train.accum_steps ({self.accum_steps}) must divide "
                f"train.batch_size ({self.batch_size}): microbatches are "
                f"equal fixed-shape slices")
        if self.prefetch_depth < 0 or self.cache_chunks < 0:
            raise ValueError(
                f"train.prefetch_depth/cache_chunks must be >= 0, got "
                f"{self.prefetch_depth}/{self.cache_chunks}")
        if (self.continuous_min_rows < 1 or self.continuous_window_rows < 1
                or self.continuous_epochs < 1
                or self.continuous_follow_polls < 1):
            raise ValueError(
                "train.continuous_min_rows/continuous_window_rows/"
                "continuous_epochs/continuous_follow_polls must be >= 1")
        if self.continuous_poll_s <= 0:
            raise ValueError(
                f"train.continuous_poll_s must be > 0, got "
                f"{self.continuous_poll_s}")


#: Fleet-runtime defaults shared by RuntimeConfig and the direct
#: constructors (BatcherConfig, FleetGateway, PredictorGateway).
DEFAULT_BUCKET_SIZES: Tuple[int, ...] = (8, 32, 64, 128)
DEFAULT_MAX_LINGER_S: float = 0.002
DEFAULT_QUEUE_BOUND: int = 1024


@dataclass(frozen=True)
class RuntimeConfig:
    """The fleet runtime's knobs: the session pool, the fleet gateway in
    front of it and the batched Predictor, with ``fmda_tpu``'s defaults."""

    #: Max concurrent sessions (slots in the pooled state).
    capacity: int = 128
    #: Ascending padded micro-batch sizes of a flush.
    bucket_sizes: Tuple[int, ...] = DEFAULT_BUCKET_SIZES
    #: Max time (ms) the oldest queued tick may linger before a flush.
    max_linger_ms: float = DEFAULT_MAX_LINGER_S * 1e3
    #: Bound on queued ticks; overload sheds the oldest, counted.
    queue_bound: int = DEFAULT_QUEUE_BOUND
    #: Pooled-head trailing window of the carried streaming state.
    window: int = 30
    #: 1 = one-deep overlap (flush k completes while flush k+1 runs on
    #: the card), 0 = strictly serial flushes; the results are the same
    #: bits either way.
    pipeline_depth: int = 1
    #: Latency-SLO gate of ``serve-fleet``: p99 of the submit -> publish
    #: ("total") histogram must stay under this bound (ms); None = off.
    slo_p99_ms: Optional[float] = None
    #: Padded micro-batch sizes of the batched Predictor's (B, window, F)
    #: forward.
    predictor_bucket_sizes: Tuple[int, ...] = (8, 32, 64)
    #: Max time (ms) the oldest queued signal may linger before a flush.
    predictor_max_linger_ms: float = DEFAULT_MAX_LINGER_S * 1e3
    #: Bound on queued signals; overload sheds the oldest, counted.
    predictor_queue_bound: int = DEFAULT_QUEUE_BOUND
    #: Model input window of the batched Predictor; None = ``window``.
    predictor_window: Optional[int] = None
    #: Keep the stream's newest ``window`` rows on the device, so that
    #: consecutive signals send only their new rows.
    predictor_ring: bool = False


@dataclass(frozen=True)
class QualityConfig:
    """The model-quality plane's knobs, with ``fmda_tpu``'s defaults.

    ``drift_bins`` sizes the quantile bins of the drift reference
    profile that ``train`` and the continuous loop write beside each
    checkpoint (:mod:`fmda_tpu_torch.eval.drift`); ``enabled`` through
    ``max_join_attempts`` drive the label-join evaluator
    (:mod:`fmda_tpu_torch.obs.quality`); the three ``swap_*`` fields the
    hot-swap guardrail (:mod:`fmda_tpu_torch.eval.shadow`).
    ``drift_min_samples`` and ``profile_path`` are kept and not read."""

    #: Master switch for the quality plane (capture + join + drift).
    enabled: bool = True
    #: Capture-ring capacity; overflow evicts the oldest prediction.
    capture_capacity: int = 4096
    #: Label-join cadence (seconds).
    join_interval_s: float = 5.0
    #: Probability threshold for label decisions.
    prob_threshold: float = 0.5
    #: F-beta beta (0.5 = precision-weighted, the trainer's choice).
    fbeta: float = 0.5
    #: Join rounds before an unjoinable capture ages out, counted.
    max_join_attempts: int = 8
    #: Reference-profile quantile bins (built at train time).
    drift_bins: int = 10
    #: Drift scores stay None below this many observed rows.
    drift_min_samples: int = 64
    #: Reference-profile path; None = the profile beside the checkpoint.
    profile_path: Optional[str] = None
    #: Hot-swap guardrail: a candidate may score at most this much below
    #: the incumbent's shadow accuracy.
    swap_margin: float = 0.02
    #: Shadow-scoring replay size: rounds x sessions per side.
    swap_eval_rounds: int = 48
    swap_eval_sessions: int = 4

    def __post_init__(self) -> None:
        if self.capture_capacity < 1:
            raise ValueError(
                f"capture_capacity must be >= 1, got {self.capture_capacity}")
        if self.join_interval_s <= 0:
            raise ValueError(
                f"join_interval_s must be > 0, got {self.join_interval_s}")
        if not 0.0 < self.prob_threshold < 1.0:
            raise ValueError(
                f"prob_threshold must be in (0, 1), got "
                f"{self.prob_threshold}")
        if self.max_join_attempts < 1:
            raise ValueError(
                f"max_join_attempts must be >= 1, got "
                f"{self.max_join_attempts}")
        if self.drift_bins < 2:
            raise ValueError(
                f"drift_bins must be >= 2, got {self.drift_bins}")
        if self.swap_margin < 0:
            raise ValueError(
                f"swap_margin must be >= 0, got {self.swap_margin}")
        if self.swap_eval_rounds < 1 or self.swap_eval_sessions < 1:
            raise ValueError(
                "swap_eval_rounds and swap_eval_sessions must be >= 1, "
                f"got {self.swap_eval_rounds} x {self.swap_eval_sessions}")


@dataclass(frozen=True)
class EngineConfig:
    """The streaming engine's knobs."""

    #: "python" or "native" (the C++ join scheduler, the same decisions;
    #: the python one runs, logged, when it cannot be built or a
    #: staleness deadline is set).
    join_backend: str = "python"
    #: Durable-state write cadence in steps.
    checkpoint_every: int = 1
    #: Engine state file (offsets and in-flight join state); None: none.
    checkpoint_path: Optional[str] = None
    #: Degraded-mode join deadline (stream-time seconds): a side feed
    #: whose watermark trails the newest book tick by more than this stops
    #: blocking the join.  None keeps the strict inner-join stall.
    staleness_deadline_s: Optional[int] = None


@dataclass(frozen=True)
class SessionConfig:
    """The ingestion session driver's knobs."""

    freq_s: int = 300
    source: str = "IEX"
    symbol: str = "spy"
    countries: Tuple[str, ...] = ("United States",)
    importance: Tuple[str, ...] = ("1", "2", "3")
    cot_subject: str = "S&P 500 STOCK INDEX"
    timezone: str = "US/Eastern"


@dataclass(frozen=True)
class ObservabilityConfig:
    """The observability plane's knobs (:mod:`fmda_tpu_torch.obs`): one
    metrics registry and JSONL event ring, with an optional scrape
    endpoint."""

    #: False hands out no-op instruments, registers no collectors and
    #: starts no endpoint.
    enabled: bool = True
    #: Serve ``/metrics``, ``/healthz``, ``/snapshot`` ... over HTTP.  Off
    #: by default so tests and one-shot runs never bind a port
    #: (``serve-fleet --metrics-port`` turns it on for a run).
    endpoint_enabled: bool = False
    host: str = "127.0.0.1"
    #: 0 = ephemeral (the bound port is logged and on the handle).
    port: int = 9100
    #: Bounded event-ring capacity (the oldest events fall off).
    events_capacity: int = 2048
    #: Mirror events to this JSONL file; None = ring only.
    events_path: Optional[str] = None
    #: ``/healthz`` turns degraded when the newest completed tick is older
    #: than this (healthy until the first tick).
    max_tick_age_s: float = 900.0


@dataclass(frozen=True)
class TracingConfig:
    """End-to-end tick tracing (:mod:`fmda_tpu_torch.obs.trace`).  Off by
    default: disabled tracing costs one branch on every hot path (submit,
    flush, bus publish, engine step)."""

    #: Master switch for the process tracer.
    enabled: bool = False
    #: Fraction of trace roots sampled in [0, 1]; 1.0 traces every tick.
    sample_rate: float = 1.0
    #: Span-ring capacity; overflow evicts the oldest spans.
    max_spans: int = 16384


@dataclass(frozen=True)
class ProfilingConfig:
    """The device plane's knobs (:mod:`fmda_tpu_torch.obs.device`, the
    host profiler of :mod:`fmda_tpu_torch.obs.pyprof`).  The reference's
    ``cost_analysis`` has no counterpart (the port compiles nothing per
    shape: the kernel ledger's costs come from each launch's shapes), so
    the key is accepted and not read."""

    #: Master switch for the kernel ledger and the memory monitor.
    enabled: bool = True
    #: Run the continuous host sampling profiler (``/profile``).
    host_profiler: bool = False
    #: Host-profiler sampling period (milliseconds).
    profile_interval_ms: float = 10.0
    #: Bounded distinct-stack table; overflow folds into ``<other>``.
    profile_max_stacks: int = 4096
    #: Device memory sampling cadence (seconds).
    memory_interval_s: float = 5.0
    #: Consecutive strictly-growing samples of allocated bytes before the
    #: leak heuristic raises ``device_memory_leak_suspected``.
    memory_leak_window: int = 12


@dataclass(frozen=True)
class ReplayConfig:
    """Historical replay's knobs (:mod:`fmda_tpu_torch.replay`), with
    ``fmda_tpu``'s defaults: the history source and the run's bounds.  A
    replay serves at full speed on a virtual clock (the rows' own
    timestamps); its sessions are ordinary gateway sessions."""

    #: ``"synthetic"`` (the seeded generator: re-iterates bit for bit, no
    #: warehouse) or ``"warehouse"`` (chunked reads through
    #: ``Warehouse.iter_row_chunks``).
    source: str = "synthetic"
    #: Tickers (= replay sessions) the backfill drives.
    n_tickers: int = 8
    #: Rounds served when ``source="synthetic"``.
    n_rounds: int = 256
    #: Seed of the synthetic generator and the tenant assignment.
    seed: int = 0
    #: Fraction of tickers active a synthetic round (1.0 = lockstep, the
    #: composition the bit-identity checks need).
    duty: float = 1.0
    #: Virtual seconds between synthetic rounds.
    step_s: float = 60.0
    #: Warehouse row-range bounds (timestamp strings; None = unbounded)
    #: when ``source="warehouse"``.
    start_ts: Optional[str] = None
    end_ts: Optional[str] = None
    #: Rows per keyset-paginated warehouse read.
    chunk: int = 4096
    #: The wire dialect blocks round-trip through before serving: None
    #: (in-process), ``"binary"`` or ``"json"``.
    wire_dialect: Optional[str] = None

    def __post_init__(self) -> None:
        if self.source not in ("synthetic", "warehouse"):
            raise ValueError(
                f"replay.source must be 'synthetic' or 'warehouse', "
                f"got {self.source!r}")
        if self.wire_dialect not in (None, "binary", "json"):
            raise ValueError(
                f"replay.wire_dialect must be null, 'binary' or 'json', "
                f"got {self.wire_dialect!r}")
        if self.n_tickers < 1 or self.n_rounds < 1 or self.chunk < 1:
            raise ValueError(
                f"replay.n_tickers/n_rounds/chunk must be >= 1, got "
                f"{self.n_tickers}/{self.n_rounds}/{self.chunk}")
        if not 0.0 < self.duty <= 1.0:
            raise ValueError(
                f"replay.duty must be in (0, 1], got {self.duty}")


@dataclass(frozen=True)
class FleetTopologyConfig:
    """Multi-host serving topology knobs (fmda_tpu_torch.fleet;
    docs/multihost.md).

    Net-new vs the reference and vs the single-process fleet runtime:
    N worker processes each own a contiguous slot-range of the session
    hash space (each embedding the PR-1 FleetGateway/SessionPool), a
    router hashes session → owner and drives membership + migration over
    the cross-process bus (a BusServer-served NativeBus locally, Kafka
    in prod).
    """

    #: Worker-process count the local launcher spawns (`serve-fleet
    #: --role local`); membership itself is dynamic — workers may join
    #: and leave a running router at any time.
    n_workers: int = 2
    #: Worker ids are ``<worker_prefix><index>`` (w0, w1, ...) for the
    #: launcher; hand-started workers may use any id.
    worker_prefix: str = "w"
    #: Bus-server bind address for the local cross-process transport
    #: (the router hosts the bus; workers connect with SocketBus).
    host: str = "127.0.0.1"
    #: 0 = ephemeral (the launcher reads the bound port off the server).
    port: int = 0
    #: Worker heartbeat cadence on the control topic.
    heartbeat_interval_s: float = 0.5
    #: Router declares a worker dead after this long without a
    #: heartbeat (measured on the router's own clock at receipt, so
    #: cross-process clock skew cannot mis-kill a healthy worker).
    #: Deliberately ~20x the interval: a worker mid-drain under a deep
    #: backlog beats late, and a false death costs carried state.
    heartbeat_timeout_s: float = 10.0
    #: Size of the session hash space the ownership table partitions
    #: into contiguous per-worker ranges.
    hash_space: int = 1 << 16
    #: Bound on ticks the router buffers per migrating session while its
    #: state is in flight between owners; overflow sheds the oldest,
    #: counted (``migration_buffer_shed``) — same never-silent contract
    #: as the gateway queue.
    migration_buffer_bound: int = 4096
    #: Max inbox records a worker consumes per step (bounds one socket
    #: read's frame size; the backlog simply spans more steps).
    worker_poll_max_records: int = 512
    #: Router backpressure bound: once this many routed ticks are
    #: unanswered, ``saturated`` turns on and well-behaved producers
    #: pace themselves — otherwise an unbounded inbox backlog outruns
    #: the bus's retention and ticks silently age off the topic.
    max_inflight_ticks: int = 4096
    #: Age (router clock) after which an unanswered tick is declared
    #: lost (``results_missing``) — e.g. it rode into a worker that
    #: died undrained.
    result_timeout_s: float = 60.0
    #: Byte arena per topic for the router-hosted NativeBus — sized for
    #: deep tick backlogs (a ~700B tick message × max_inflight_ticks ×
    #: workers fits with wide margin).
    bus_arena_bytes: int = 1 << 26
    #: How long a shared-bus worker retries a dead broker before exiting
    #: cleanly (counted, rc 0 — the never-abort contract).  A
    #: worker-hosted-bus worker never exits on control loss: its data
    #: plane is local, so it keeps serving and re-dials instead.
    bus_error_grace_s: float = 10.0
    #: Control-plane re-dial cadence while the router/broker is
    #: unreachable (split topology; reconnect re-hellos with the session
    #: report, which is how a restarted router adopts the sessions).
    control_retry_s: float = 1.0
    #: Frame encoding on every SocketBus link (docs/multihost.md "Wire
    #: format v2"): ``auto`` negotiates the binary codec at connect and
    #: falls back to JSON against a peer that does not speak it (mixed-
    #: version fleets interoperate); ``binary`` insists (still falls
    #: back, loudly); ``json`` pins the pre-v2 text frames — the
    #: rollback switch.
    wire_format: str = "auto"


@dataclass(frozen=True)
class SLOConfig:
    """Fleet service-level objectives + telemetry knobs
    (:mod:`fmda_tpu_torch.obs`: tsdb/aggregate/slo/recorder;
    docs/observability.md "Fleet aggregation, SLOs, and the flight
    recorder").

    Declarative objectives evaluated as **multi-window burn rates**: an
    alert fires when both the fast (~5 m) and slow (~1 h) windows burn
    error budget faster than ``burn_threshold``, and clears as soon as
    the fast window recovers.  Evaluation is pull-based — one fold of
    heartbeat stats + scrape snapshots per ``interval_s``, never on the
    tick hot path.
    """

    #: Master switch for router-side fleet telemetry (the store, the
    #: aggregator, SLO evaluation, and the flight recorder).
    enabled: bool = True
    #: Time-series sample grid + SLO evaluation cadence (seconds).
    interval_s: float = 5.0
    #: History the store retains per series (ring capacity =
    #: retention_s / interval_s bins).
    retention_s: float = 7200.0
    #: Cadence for scraping worker ``/snapshot`` endpoints (announced
    #: in heartbeats); heartbeat stats fold in every ``interval_s``.
    scrape_interval_s: float = 10.0
    #: Burn-rate windows (seconds): fast trips quickly on a cliff,
    #: slow keeps a brief blip from paging.
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    #: Burn rate (budget consumption multiple) at which an alert fires.
    burn_threshold: float = 2.0
    #: Latency objective: at most ``latency_budget`` of served ticks may
    #: exceed ``latency_p99_ms`` end to end.  None disables.
    latency_p99_ms: Optional[float] = 250.0
    latency_budget: float = 0.05
    #: Loss objective: counted losses / (served + lost) stays under this.
    loss_budget: float = 0.001
    #: Journal objective: warehouse journal backlog above this depth is
    #: budget burn (``journal_budget`` of samples may exceed it).
    journal_depth: int = 1024
    journal_budget: float = 0.1
    #: Degraded-feed objective: minutes per slow window any side feed
    #: may serve ghost rows before the alert fires.
    degraded_feed_budget_minutes: float = 5.0
    #: (The reference's ``recompile_budget`` is accepted and not read:
    #: the port compiles nothing per shape, so its ``recompile``
    #: objective has no signal.)
    #: Memory-leak objective: fraction of samples the device memory
    #: monitor's monotonic-growth heuristic may be raised.
    memory_leak_budget: float = 0.05
    #: Quality objectives (fmda_tpu_torch.obs.quality's label-join evaluator
    #: writes the series; None-until-reported — a fleet without the
    #: quality plane never fires these).  Accuracy: exact-match misses
    #: over joined predictions stay under this fraction.
    quality_accuracy_budget: float = 0.35
    #: Per-label F-beta floor: fraction of sampled intervals where ANY
    #: (version, label) F-beta gauge sits below ``quality_fbeta_floor``.
    quality_fbeta_floor: float = 0.05
    quality_fbeta_budget: float = 0.25
    #: Drift: fraction of sampled intervals where the worst PSI
    #: (feature or prediction) exceeds ``quality_drift_psi`` (0.25 is
    #: the classic "action required" PSI threshold).
    quality_drift_psi: float = 0.25
    quality_drift_budget: float = 0.1
    #: Flight-recorder bundle directory; None disables postmortems.
    postmortem_dir: Optional[str] = None
    #: Rotated bundle count (oldest deleted past this).
    postmortem_keep: int = 4
    #: Debounce between bundles for one trigger reason (seconds).
    postmortem_min_interval_s: float = 60.0


@dataclass(frozen=True)
class ChaosConfig:
    """Fault-injection knobs (fmda_tpu_torch.chaos; docs/chaos.md).

    Off by default: with ``enabled=False`` nothing is injected and every
    compiled-in injection point costs exactly one branch (the tier-1 AST
    check pins this).  The rate knobs parameterise
    :meth:`~fmda_tpu_torch.chaos.plan.FaultPlan.generate` when no explicit
    ``--chaos-plan`` file is given — the plan is a pure function of
    ``seed`` and these counts, so a run is its own reproduction recipe.
    """

    #: Master switch for the process chaos runtime.
    enabled: bool = False
    #: Seed the generated fault plan derives from.
    seed: int = 0
    #: Worker processes killed (and revived ``revive_after`` steps
    #: later) per soak.
    worker_kills: int = 1
    #: Virtual steps a killed worker stays down before its replacement
    #: spawns.
    revive_after: int = 8
    #: Router kill/takeover events per soak (each exercises the
    #: registry-rebuild failover path).
    router_restarts: int = 1
    #: Router→worker data-link partition windows per soak.
    link_partitions: int = 1
    #: Control-bus outage windows per soak (the router keeps pumping its
    #: links while its own bus is down — counted, never fatal).
    bus_blips: int = 1
    #: Injected per-op delay events per soak.
    delays: int = 2
    #: Sleep per delayed op (seconds).
    delay_s: float = 0.02
    #: Fault-free steps at both ends of the schedule: a clean warm-up,
    #: and the post-chaos window the "ticks served after the last
    #: fault" gate measures in.
    settle_steps: int = 5

    # -- data-plane soak knobs (fmda_tpu.chaos.pipeline; the fleet soak
    # above ignores these) ---------------------------------------------

    #: Side-feed outage windows per pipeline soak (degraded-mode joins).
    feed_outages: int = 1
    #: Virtual steps a feed stays down.
    feed_outage_steps: int = 8
    #: Warehouse-unreachable windows per pipeline soak (journal spill).
    warehouse_outages: int = 1
    #: Virtual steps the warehouse stays down.
    warehouse_outage_steps: int = 4
    #: Engine kill/restore cycles per pipeline soak.
    engine_kills: int = 1
    #: Virtual steps the engine stays dead before its restore.
    engine_kill_steps: int = 2


@dataclass(frozen=True)
class ControlConfig:
    """Adaptive control plane knobs (:mod:`fmda_tpu_torch.control`), as
    ``fmda_tpu.config.ControlConfig`` defines them, every key and check.

    Three closed loops run beside the router, all reading the telemetry
    plane (``[slo]``'s windowed p99 / burn rates) and writing decisions
    to the EventLog: the **batching controller** (tunes gateway linger
    and bucket cap against the latency objective), **per-tenant QoS**
    (weighted admission + counted per-class shedding in front of the
    gateway queue), and the **elastic autoscaler** (spawns workers on
    sustained burn, retires them through the zero-loss drain/export/
    replay migration on sustained idle).  ``enabled=False`` removes
    every loop: the serving path is exactly the static fleet.
    """

    #: Master switch for the control plane (``serve-fleet
    #: --no-controller`` overrides per run for A/B).
    enabled: bool = True
    #: Decision cadence (seconds between control evaluations).
    interval_s: float = 1.0
    #: Last-N decision ring surfaced by ``/control`` and ``status``.
    decisions_keep: int = 64

    # -- batching controller --------------------------------------------
    #: Enable the linger/bucket feedback loop.
    batching: bool = True
    #: p99 target (ms) the loop steers toward; None derives it from
    #: ``slo.latency_p99_ms``.
    target_p99_ms: Optional[float] = None
    #: Hysteresis deadband as a fraction of target: no move while p99
    #: sits inside [(1-h)·target, (1+h)·target].
    hysteresis: float = 0.25
    #: Bounded step per decision (ms of linger) — the loop never jumps.
    linger_step_ms: float = 0.25
    #: Linger clamp (ms).  The controller explores inside these walls.
    min_linger_ms: float = 0.0
    max_linger_ms: float = 8.0

    # -- per-tenant QoS -------------------------------------------------
    #: Priority classes, highest first.  Parallel tuples: ``weights``
    #: set each class's fair share of the gateway queue (WFQ), and
    #: ``quota_frac`` caps each class's queued ticks at that fraction
    #: of ``runtime.queue_bound`` (over-quota submits shed the class's
    #: OWN oldest tick, counted ``quota_shed``).  Empty = QoS off
    #: (global oldest-drop, exactly the pre-control gateway).
    tenant_classes: Tuple[str, ...] = ()
    tenant_weights: Tuple[float, ...] = ()
    tenant_quota_frac: Tuple[float, ...] = ()
    #: Class assigned to sessions opened without a tenant label.
    default_class: str = "standard"

    # -- elastic autoscaler ---------------------------------------------
    #: Enable the worker-count loop (needs a spawn-capable actuator —
    #: the local launcher topology; a bare router run leaves it off).
    autoscale: bool = True
    min_workers: int = 1
    max_workers: int = 8
    #: Scale up when the latency objective's fast burn rate holds at or
    #: above this for ``up_sustain_s`` seconds.
    scale_up_burn: float = 1.0
    up_sustain_s: float = 3.0
    #: Scale down when p99 holds below ``scale_down_frac``·target (and
    #: no burn) for ``down_sustain_s`` seconds.
    scale_down_frac: float = 0.3
    down_sustain_s: float = 10.0
    #: Minimum seconds between scaling moves (either direction).
    cooldown_s: float = 5.0

    def __post_init__(self) -> None:
        n = len(self.tenant_classes)
        if len(self.tenant_weights) != n or len(self.tenant_quota_frac) != n:
            raise ValueError(
                "tenant_classes/tenant_weights/tenant_quota_frac must be "
                f"parallel tuples, got lengths {n}/"
                f"{len(self.tenant_weights)}/{len(self.tenant_quota_frac)}")
        if any(w <= 0 for w in self.tenant_weights):
            raise ValueError("tenant_weights must be positive")
        if self.min_workers < 1 or self.max_workers < self.min_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{self.min_workers}/{self.max_workers}")
        if self.min_linger_ms < 0 or self.max_linger_ms < self.min_linger_ms:
            raise ValueError(
                f"need 0 <= min_linger_ms <= max_linger_ms, got "
                f"{self.min_linger_ms}/{self.max_linger_ms}")


@dataclass(frozen=True)
class FrameworkConfig:
    features: FeatureConfig = field(default_factory=FeatureConfig)
    bus: BusConfig = field(default_factory=BusConfig)
    warehouse: WarehouseConfig = field(default_factory=WarehouseConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    session: SessionConfig = field(default_factory=SessionConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    fleet: FleetTopologyConfig = field(default_factory=FleetTopologyConfig)
    quality: QualityConfig = field(default_factory=QualityConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig)
    slo: SLOConfig = field(default_factory=SLOConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    profiling: ProfilingConfig = field(default_factory=ProfilingConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    control: ControlConfig = field(default_factory=ControlConfig)
    replay: ReplayConfig = field(default_factory=ReplayConfig)

    def __post_init__(self) -> None:
        if self.model.n_features is None:
            synced = dataclasses.replace(
                self.model, n_features=self.features.n_features)
            object.__setattr__(self, "model", synced)


_SECTIONS = {
    "features": FeatureConfig,
    "bus": BusConfig,
    "warehouse": WarehouseConfig,
    "engine": EngineConfig,
    "model": ModelConfig,
    "train": TrainConfig,
    "session": SessionConfig,
    "runtime": RuntimeConfig,
    "fleet": FleetTopologyConfig,
    "quality": QualityConfig,
    "observability": ObservabilityConfig,
    "slo": SLOConfig,
    "tracing": TracingConfig,
    "profiling": ProfilingConfig,
    "chaos": ChaosConfig,
    "control": ControlConfig,
    "replay": ReplayConfig,
}

#: Every section and key ``fmda_tpu.config.config_from_dict`` accepts (the
#: fields of its section dataclasses), as literals.  The port reads the
#: keys its own dataclasses in :data:`_SECTIONS` have and accepts the rest
#: without reading them:
#:
#: - ``model``: ``use_pallas`` (the port has no opt-in: its kernels always
#:   run on the card);
#: - ``runtime``: ``shard_pool`` (sharding the pool's slots across
#:   devices waits for the port's parallelism);
#: - ``quality``: read whole into :class:`QualityConfig`;
#: - ``profiling``: ``cost_analysis`` (the port compiles nothing per
#:   shape, so there is no program to analyse: the kernel ledger computes
#:   each launch's cost from its shapes);
#: - ``slo``: ``recompile_budget`` (the port compiles nothing per shape,
#:   so the ``recompile`` objective has no signal;
#:   :mod:`fmda_tpu_torch.obs.slo`);
#: - the section ``mesh`` whole (parallelism, item 8).
REFERENCE_KEYS = {
    "features": (
        "get_cot", "get_vix", "get_stock_volume", "bid_levels", "ask_levels",
        "volume_ma_periods", "price_ma_periods", "delta_ma_periods",
        "bollinger_period", "bollinger_std", "stochastic_oscillator",
        "stoch_preceding", "atr_preceding", "event_list", "target_n1",
        "target_n2", "target_lead1", "target_lead2", "floor_s",
        "join_tolerance_s", "watermark_s"),
    "bus": ("topics", "capacity", "servers"),
    "warehouse": (
        "backend", "path", "database_name", "table_name", "journal_path",
        "journal_bound", "journal_format", "user", "password", "hostname",
        "port"),
    "engine": ("join_backend", "checkpoint_every", "checkpoint_path",
               "staleness_deadline_s"),
    "model": (
        "hidden_size", "n_features", "output_size", "n_layers", "dropout",
        "spatial_dropout", "bidirectional", "cell", "n_heads", "attn_causal",
        "attn_dropout", "ssm_decay_range", "ssm_ema_init", "dtype",
        "use_pallas", "remat"),
    "train": (
        "batch_size", "window", "chunk_size", "learning_rate", "epochs",
        "clip", "val_size", "test_size", "fbeta_beta", "prob_threshold",
        "seed", "checkpoint_dir", "accum_steps", "prefetch_depth",
        "cache_chunks", "continuous_min_rows", "continuous_window_rows",
        "continuous_epochs", "continuous_follow_polls", "continuous_poll_s"),
    "mesh": ("dp", "sp", "processes", "dp_axis", "sp_axis"),
    "session": ("freq_s", "source", "symbol", "countries", "importance",
                "cot_subject", "timezone"),
    "runtime": (
        "capacity", "bucket_sizes", "max_linger_ms", "queue_bound", "window",
        "pipeline_depth", "shard_pool", "slo_p99_ms",
        "predictor_bucket_sizes", "predictor_max_linger_ms",
        "predictor_queue_bound", "predictor_window", "predictor_ring"),
    "fleet": (
        "n_workers", "worker_prefix", "host", "port", "heartbeat_interval_s",
        "heartbeat_timeout_s", "hash_space", "migration_buffer_bound",
        "worker_poll_max_records", "max_inflight_ticks", "result_timeout_s",
        "bus_arena_bytes", "bus_error_grace_s", "control_retry_s",
        "wire_format"),
    "observability": ("enabled", "endpoint_enabled", "host", "port",
                      "events_capacity", "events_path", "max_tick_age_s"),
    "slo": (
        "enabled", "interval_s", "retention_s", "scrape_interval_s",
        "fast_window_s", "slow_window_s", "burn_threshold", "latency_p99_ms",
        "latency_budget", "loss_budget", "journal_depth", "journal_budget",
        "degraded_feed_budget_minutes", "recompile_budget",
        "memory_leak_budget", "quality_accuracy_budget",
        "quality_fbeta_floor", "quality_fbeta_budget", "quality_drift_psi",
        "quality_drift_budget", "postmortem_dir", "postmortem_keep",
        "postmortem_min_interval_s"),
    "quality": (
        "enabled", "capture_capacity", "join_interval_s", "prob_threshold",
        "fbeta", "max_join_attempts", "drift_bins", "drift_min_samples",
        "profile_path", "swap_margin", "swap_eval_rounds",
        "swap_eval_sessions"),
    "tracing": ("enabled", "sample_rate", "max_spans"),
    "profiling": ("enabled", "cost_analysis", "host_profiler",
                  "profile_interval_ms", "profile_max_stacks",
                  "memory_interval_s", "memory_leak_window"),
    "chaos": (
        "enabled", "seed", "worker_kills", "revive_after", "router_restarts",
        "link_partitions", "bus_blips", "delays", "delay_s", "settle_steps",
        "feed_outages", "feed_outage_steps", "warehouse_outages",
        "warehouse_outage_steps", "engine_kills", "engine_kill_steps"),
    "control": (
        "enabled", "interval_s", "decisions_keep", "batching",
        "target_p99_ms", "hysteresis", "linger_step_ms", "min_linger_ms",
        "max_linger_ms", "tenant_classes", "tenant_weights",
        "tenant_quota_frac", "default_class", "autoscale", "min_workers",
        "max_workers", "scale_up_burn", "up_sustain_s", "scale_down_frac",
        "down_sustain_s", "cooldown_s"),
    "replay": ("source", "n_tickers", "n_rounds", "seed", "duty", "step_s",
               "start_ts", "end_ts", "chunk", "wire_dialect"),
}


def config_from_dict(data: dict) -> FrameworkConfig:
    """Rebuild the config from the nested dicts of a ``fmda_tpu`` config
    file (possibly partial).  A section or key the reference does not
    know raises, as the reference raises: a typo'd config must fail
    loudly.  Of the rest, the sections and keys this package models are
    read; the others are accepted and not read (:data:`REFERENCE_KEYS`)."""
    unknown = set(data) - set(REFERENCE_KEYS)
    if unknown:
        raise ValueError(f"unknown config sections: {sorted(unknown)}")
    for name, section in data.items():
        bad = set(section) - set(REFERENCE_KEYS[name])
        if bad:
            raise ValueError(f"unknown keys in [{name}]: {sorted(bad)}")
    kwargs = {}
    for name, cls in _SECTIONS.items():
        if name not in data:
            continue
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs[name] = cls(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in data[name].items() if k in names
        })
    return FrameworkConfig(**kwargs)


def config_to_dict(cfg: FrameworkConfig) -> dict:
    """Nested plain-dict form (tuples become lists; JSON-ready), as the
    reference writes it: ``model.n_features`` is written as null, state
    derived from the feature schema."""
    d = dataclasses.asdict(cfg)
    d["model"]["n_features"] = None
    return d


def save_config(cfg: FrameworkConfig, path: str) -> str:
    with open(path, "w") as fh:
        json.dump(config_to_dict(cfg), fh, indent=2)
        fh.write("\n")
    return path


def load_config(path: str) -> FrameworkConfig:
    with open(path) as fh:
        return config_from_dict(json.load(fh))
