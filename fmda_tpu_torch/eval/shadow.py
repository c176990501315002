"""Hot-swap guardrail: shadow-score a candidate checkpoint, as
``fmda_tpu.eval.shadow`` scores it.

:class:`ShadowEvaluator` replays recent warehoused history
(:class:`~fmda_tpu_torch.replay.WarehouseHistory` through an unmodified
solo :class:`~fmda_tpu_torch.runtime.gateway.FleetGateway`) under the
incumbent's and the candidate's ``state_dict``, joins both prediction
streams against the warehouse's targets, and passes the candidate iff

    candidate_accuracy + swap_margin >= incumbent_accuracy

Both sides replay the same deterministic source with the same sessions,
so their joinable subsets are the same.  A warehouse with no joinable
history (too young, targets not final yet) cannot refuse: the verdict is
a pass with ``"scored": false``, or every swap of a fresh deployment
would block.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ShadowEvaluator"]


class ShadowEvaluator:
    """Callable guardrail for ``gateway_publisher(require_eval=...)``.

    ``gate(params)`` (also ``__call__``) returns ``(ok, detail)``; the
    incumbent is scored once, on first use, and reused across candidates
    (it does not change between refusals)."""

    def __init__(
        self,
        incumbent_params,
        *,
        model_config,
        warehouse,
        quality_config=None,
        max_lead: Optional[int] = None,
        window: int = 30,
        n_tickers: Optional[int] = None,
        seed: int = 0,
        row_transform=None,
        device=None,
    ) -> None:
        from fmda_tpu_torch.config import FeatureConfig, QualityConfig

        self.incumbent_params = incumbent_params
        self.model_config = model_config
        self.warehouse = warehouse
        self.cfg = quality_config or QualityConfig()
        self.max_lead = (int(max_lead) if max_lead is not None
                         else FeatureConfig().max_lead)
        self.window = int(window)
        self.n_tickers = int(n_tickers if n_tickers is not None
                             else self.cfg.swap_eval_sessions)
        self.seed = int(seed)
        #: a zero-argument factory (such as the bound
        #: ``warehouse.joined_row_transform``): each replay needs a fresh
        #: stateful mapper, and a gate replays twice
        self.row_transform = row_transform
        self.device = device
        self._incumbent_score: Optional[Dict] = None

    def score(self, params) -> Dict:
        """Replay recent history under ``params``; the joined streaming
        metrics (``joined`` 0 while no history has final targets)."""
        from fmda_tpu_torch.obs.quality import QualityEvaluator
        from fmda_tpu_torch.replay import ReplayDriver, WarehouseHistory
        from fmda_tpu_torch.runtime import (
            BatcherConfig,
            FleetGateway,
            SessionPool,
        )

        model_cfg = dataclasses.replace(self.model_config, dropout=0.0)
        rows_wanted = (self.cfg.swap_eval_rounds * self.n_tickers
                       + self.max_lead)
        recent = self.warehouse.recent_timestamps(rows_wanted)
        start_ts = recent[-1] if recent else None
        source = WarehouseHistory(
            self.warehouse, self.n_tickers, n_features=model_cfg.n_features,
            start_ts=start_ts,
            row_transform=(self.row_transform()
                           if self.row_transform is not None else None))
        pool = SessionPool(model_cfg, params, capacity=self.n_tickers,
                           window=self.window, device=self.device)
        gateway = FleetGateway(pool, None, batcher_config=BatcherConfig(
            bucket_sizes=(self.n_tickers,), max_linger_s=0.0))
        # the shadow run expires nothing: one final join settles every
        # capture whose targets are final, the rest stay pending
        eval_cfg = dataclasses.replace(self.cfg, capture_capacity=max(
            self.cfg.capture_capacity,
            self.cfg.swap_eval_rounds * self.n_tickers + 1))
        evaluator = QualityEvaluator(eval_cfg, warehouse=self.warehouse,
                                     max_lead=self.max_lead)
        ReplayDriver(gateway, source, seed=self.seed,
                     quality=evaluator).run()
        evaluator.join()
        summary = evaluator.summary()
        out = dict(summary["overall"])
        out["joined"] = summary["conservation"]["joined"]
        return out

    def gate(self, params) -> Tuple[bool, Dict]:
        if self._incumbent_score is None:
            self._incumbent_score = self.score(self.incumbent_params)
        incumbent = self._incumbent_score
        candidate = self.score(params)
        detail: Dict = {
            "margin": self.cfg.swap_margin,
            "joined": candidate["joined"],
            "incumbent_accuracy": incumbent["subset_accuracy"],
            "candidate_accuracy": candidate["subset_accuracy"],
        }
        if not candidate["joined"] or not incumbent["joined"]:
            detail["scored"] = False
            return True, detail
        detail["scored"] = True
        ok = (candidate["subset_accuracy"] + self.cfg.swap_margin
              >= incumbent["subset_accuracy"])
        return ok, detail

    __call__ = gate
