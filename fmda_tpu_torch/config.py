"""Configuration the ported slices read, kept as their own copy.

The same frozen dataclasses as ``fmda_tpu.config`` (field names, defaults
and the config -> schema codegen of :class:`FeatureConfig`), cut to what
the window-re-scan serving path and the trainer read: the feature schema,
the warehouse, the model and the training config (without its continuous
fine-tuning fields).  A JSON file that ``fmda_tpu.config.save_config``
wrote loads here too: the sections and keys this package does not model
(the runtime, fleet, mesh, ...) belong to paths that are not ported yet
and are skipped.
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


#: The ``ModelConfig.cell`` values the port runs.
PORTED_CELLS = ("gru", "lstm")


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
    #: Sequence-core family: "gru" (the reference's model) or "lstm" (the
    #: same head over an LSTM core).  "ssm" and "attn" are not ported yet;
    #: they are queued in ROADMAP.md.
    cell: str = "gru"
    #: Compute dtype for the recurrent core and head; params stay float32.
    dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.cell not in PORTED_CELLS:
            raise NotImplementedError(
                f"cell={self.cell!r} is not ported to fmda_tpu_torch yet "
                f"(only {', '.join(PORTED_CELLS)}); see ROADMAP.md, queue 1")


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
class FrameworkConfig:
    features: FeatureConfig = field(default_factory=FeatureConfig)
    warehouse: WarehouseConfig = field(default_factory=WarehouseConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

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
}


def config_from_dict(data: dict) -> FrameworkConfig:
    """Rebuild the config from the nested dicts of a ``fmda_tpu`` config
    file, keeping the sections and keys this package models."""
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
