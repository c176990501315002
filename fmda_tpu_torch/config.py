"""Configuration the ported slices read, kept as their own copy.

The same frozen dataclasses as ``fmda_tpu.config`` (field names, defaults
and the config -> schema codegen of :class:`FeatureConfig`), cut to what
the ported paths read: the feature schema, the warehouse, the model, the
training config (without its continuous fine-tuning fields) and the
session pool's part of the runtime config.  A JSON file that
``fmda_tpu.config.save_config`` wrote loads here too, and a file the
reference would refuse is refused: :func:`config_from_dict` checks every
section and key against :data:`REFERENCE_KEYS`, the reference's own table,
and raises on anything outside it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

TOPIC_PREDICT_TIMESTAMP = "predict_timestamp"
TOPIC_PREDICTION = "prediction"
DEFAULT_TOPICS: Tuple[str, ...] = (TOPIC_PREDICT_TIMESTAMP, TOPIC_PREDICTION)


@dataclass(frozen=True)
class WarehouseConfig:
    """Embedded SQLite warehouse: the same file layout ``fmda_tpu`` writes."""

    backend: str = "sqlite"
    path: str = ":memory:"
    table_name: str = "stock_data_joined"


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

    @property
    def event_list_repl(self) -> Tuple[str, ...]:
        return tuple(sanitize_event(e) for e in self.event_list)

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


@dataclass(frozen=True)
class RuntimeConfig:
    """The session pool's part of ``fmda_tpu``'s fleet runtime config."""

    #: Max concurrent sessions (slots in the pooled state).
    capacity: int = 128
    #: Ascending padded micro-batch sizes of a flush.
    bucket_sizes: Tuple[int, ...] = (8, 32, 64, 128)
    #: Pooled-head trailing window of the carried streaming state.
    window: int = 30


@dataclass(frozen=True)
class FrameworkConfig:
    features: FeatureConfig = field(default_factory=FeatureConfig)
    warehouse: WarehouseConfig = field(default_factory=WarehouseConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def __post_init__(self) -> None:
        if self.model.n_features is None:
            synced = dataclasses.replace(
                self.model, n_features=self.features.n_features)
            object.__setattr__(self, "model", synced)


_SECTIONS = {
    "features": FeatureConfig,
    "warehouse": WarehouseConfig,
    "model": ModelConfig,
    "train": TrainConfig,
    "runtime": RuntimeConfig,
}

#: Every section and key ``fmda_tpu.config.config_from_dict`` accepts (the
#: fields of its section dataclasses), as literals.  The port reads the
#: keys its own dataclasses in :data:`_SECTIONS` have and accepts the rest
#: without reading them:
#:
#: - ``features``: ``floor_s``, ``join_tolerance_s``, ``watermark_s`` (the
#:   stream engine's join);
#: - ``warehouse``: ``database_name``, ``journal_path``, ``journal_bound``,
#:   ``journal_format``, ``user``, ``password``, ``hostname``, ``port``
#:   (the MySQL backend and the write journal);
#: - ``model``: ``use_pallas`` (the port has no opt-in: its kernels always
#:   run on the card) and ``remat``;
#: - ``train``: the ``continuous_*`` fine-tuning fields;
#: - ``runtime``: every field but ``capacity``, ``bucket_sizes`` and
#:   ``window`` (the fleet gateway and the predictor pool);
#: - the sections ``bus``, ``engine``, ``mesh``, ``session``, ``fleet``,
#:   ``observability``, ``slo``, ``quality``, ``tracing``, ``profiling``,
#:   ``chaos``, ``control`` and ``replay`` whole.
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


def load_config(path: str) -> FrameworkConfig:
    with open(path) as fh:
        return config_from_dict(json.load(fh))
