"""Declarative SLOs evaluated as multi-window burn rates, as
``fmda_tpu.obs.slo`` defines them.

An SLO is an error *budget*: "at most 5% of ticks slower than 250 ms",
"at most 0.1% counted loss".  A threshold alert on the raw number pages
on every blip and misses slow leaks; a **burn rate** — budget consumed
per unit budget allowed — caught over two windows does neither:

- the **fast window** (~5 m) trips quickly when the fleet falls off a
  cliff and clears quickly when it recovers (alerts must *clear* — a
  latched alert is noise);
- the **slow window** (~1 h) keeps a 30-second blip from firing at all:
  both windows must burn faster than ``burn_threshold`` to fire.

Objectives ship with the framework (the ``[slo]`` config section —
:class:`~fmda_tpu_torch.config.SLOConfig`):

========================  ===================================================
``latency_p99``           fraction of served ticks above ``latency_p99_ms``
                          (exact per window — histogram snapshots diff and
                          merge in the store) vs ``latency_budget``
``loss_ratio``            counted losses / (served + lost) vs ``loss_budget``
``journal_depth``         fraction of samples with a warehouse journal
                          backlog above ``journal_depth`` vs
                          ``journal_budget``
``degraded_feed``         minutes of any side feed serving ghost rows vs
                          ``degraded_feed_budget_minutes`` per slow window
``memory_leak``           fraction of samples with the device memory
                          monitor's monotonic-growth heuristic raised vs
                          ``memory_leak_budget``
``quality_accuracy``      exact-match misses / label-joined predictions
                          (fmda_tpu_torch.obs.quality's evaluator) vs
                          ``quality_accuracy_budget``
``quality_fbeta``         fraction of samples where any (version, label)
                          F-beta gauge sits below ``quality_fbeta_floor``
                          vs ``quality_fbeta_budget``
``quality_drift``         fraction of samples where the worst PSI exceeds
                          ``quality_drift_psi`` vs ``quality_drift_budget``
========================  ===================================================

Firing and resolving are **events** (the EventLog records both), the
active set is a gauge (``slo_alerts_active``) plus per-objective burn
gauges, and ``on_fire`` is the flight recorder's trigger.  Evaluation is
pull-based: one pass over the time-series store per ``interval_s``,
nothing on a tick hot path.  Router-role code: no torch.

No counterpart, and why: the reference's ``recompile`` objective counts
XLA recompiles after warm-up (``worker_recompiles_total``, from each
worker's heartbeat).  The port compiles nothing per shape (every kernel
is built once and takes every bucket), so that series has no signal and
the objective is left out; ``[slo] recompile_budget`` is accepted and
not read.  Every other objective, its window arithmetic and its alert
document are the reference's.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional

from fmda_tpu_torch.obs.registry import LatencyHistogram, Snapshot
from fmda_tpu_torch.obs.tsdb import TimeSeriesStore

log = logging.getLogger("fmda_tpu_torch.obs")

#: store series the shipped objectives read (fmda_tpu_torch.obs.aggregate
#: writes them)
SERIES_E2E = "fleet_e2e_seconds"
SERIES_TICKS = "fleet_ticks_total"
SERIES_LOSS = "fleet_loss_total"
SERIES_JOURNAL = "warehouse_journal_pending"
SERIES_DEGRADED = "engine_degraded_streams"
SERIES_LEAK = "worker_memory_leak_suspected"
#: quality-plane series (fmda_tpu_torch.obs.quality writes them; all three
#: quality objectives are None-until-reported, so fleets without the
#: quality plane neither alert nor read healthy-by-omission)
SERIES_QUALITY_JOINED = "quality_joined_total"
SERIES_QUALITY_EXACT = "quality_exact_total"
SERIES_QUALITY_FBETA = "quality_fbeta"
SERIES_QUALITY_DRIFT = "quality_drift_score"


def bad_fraction_above(hist: LatencyHistogram, bound_s: float) -> float:
    """Fraction of a window histogram's observations strictly above the
    bin containing ``bound_s`` — deterministic to the shared bin
    resolution (observations inside the bound's own bin count as good)."""
    snap = hist.snapshot()
    n = snap["n"]
    if not n:
        return 0.0
    cutoff = hist._bin(bound_s)
    bad = sum(snap["counts"][cutoff + 1:])
    return bad / n


class SLOEngine:
    """Evaluates the shipped objectives against a
    :class:`~fmda_tpu_torch.obs.tsdb.TimeSeriesStore`."""

    def __init__(
        self,
        config=None,
        store: Optional[TimeSeriesStore] = None,
        *,
        events=None,
        clock: Callable[[], float] = time.monotonic,
        on_fire: Optional[Callable[[str, dict], None]] = None,
        on_resolve: Optional[Callable[[str, dict], None]] = None,
    ) -> None:
        from fmda_tpu_torch.config import SLOConfig

        self.cfg = config or SLOConfig()
        self.store = store if store is not None else TimeSeriesStore(
            interval_s=self.cfg.interval_s,
            capacity=max(2, int(self.cfg.retention_s / self.cfg.interval_s)),
            clock=clock)
        self.events = events
        self.clock = clock
        self.on_fire = on_fire
        self.on_resolve = on_resolve
        #: objective -> latest alert dict (state "ok" | "firing")
        self._alerts: Dict[str, dict] = {}
        self._last_eval: Optional[float] = None

    # -- objectives ---------------------------------------------------------

    def _objectives(self) -> List[dict]:
        cfg = self.cfg
        out = []
        if cfg.latency_p99_ms is not None:
            out.append({
                "objective": "latency_p99",
                "budget": cfg.latency_budget,
                "detail": f"ticks over {cfg.latency_p99_ms:g}ms e2e",
                "bad": lambda w, now: self._latency_bad(w, now),
            })
        out.append({
            "objective": "loss_ratio",
            "budget": cfg.loss_budget,
            "detail": "counted losses / (served + lost)",
            "bad": lambda w, now: self._loss_bad(w, now),
        })
        out.append({
            "objective": "journal_depth",
            "budget": cfg.journal_budget,
            "detail": f"journal backlog over {cfg.journal_depth} rows",
            "bad": lambda w, now: self._gauge_bad(
                SERIES_JOURNAL, w, now, cfg.journal_depth),
        })
        degraded_budget = (
            cfg.degraded_feed_budget_minutes * 60.0 / cfg.slow_window_s)
        out.append({
            "objective": "degraded_feed",
            "budget": max(degraded_budget, 1e-9),
            "detail": (f"feeds degraded > "
                       f"{cfg.degraded_feed_budget_minutes:g} min/h"),
            "bad": lambda w, now: self._gauge_bad(
                SERIES_DEGRADED, w, now, 0.0),
        })
        out.append({
            "objective": "memory_leak",
            "budget": cfg.memory_leak_budget,
            "detail": "monotonic device-memory growth suspected",
            "bad": lambda w, now: self._gauge_bad(
                SERIES_LEAK, w, now, 0.0),
        })
        out.append({
            "objective": "quality_accuracy",
            "budget": cfg.quality_accuracy_budget,
            "detail": "exact-match misses / label-joined predictions",
            "bad": lambda w, now: self._quality_accuracy_bad(w, now),
        })
        out.append({
            "objective": "quality_fbeta",
            "budget": cfg.quality_fbeta_budget,
            "detail": (f"any per-label F-beta under "
                       f"{cfg.quality_fbeta_floor:g}"),
            "bad": lambda w, now: self._gauge_below_bad(
                SERIES_QUALITY_FBETA, w, now, cfg.quality_fbeta_floor),
        })
        out.append({
            "objective": "quality_drift",
            "budget": cfg.quality_drift_budget,
            "detail": f"feature/prediction PSI over "
                      f"{cfg.quality_drift_psi:g}",
            "bad": lambda w, now: self._gauge_bad(
                SERIES_QUALITY_DRIFT, w, now, cfg.quality_drift_psi),
        })
        return out

    def _quality_accuracy_bad(self, window_s: float, now: float
                              ) -> Optional[float]:
        """Window miss rate of the label-join evaluator: (joined -
        exact) / joined over the window's counter deltas.  None until
        the quality plane has reported — and None for windows where
        nothing joined (no evidence is not good OR bad evidence)."""
        if not self.store.query(SERIES_QUALITY_JOINED, window_s=window_s,
                                now=now)["points"]:
            return None
        joined = self.store.window_total(
            SERIES_QUALITY_JOINED, window_s=window_s, now=now)
        if joined <= 0:
            return None
        exact = self.store.window_total(
            SERIES_QUALITY_EXACT, window_s=window_s, now=now)
        return max(0.0, (joined - exact) / joined)

    def _gauge_below_bad(self, name: str, window_s: float, now: float,
                         floor: float) -> Optional[float]:
        """Mirror of :meth:`_gauge_bad` with an inverted bound: the
        fraction of sampled intervals where ANY label variant sits
        *below* ``floor`` (one collapsed label is the fleet's problem,
        whichever version serves it)."""
        bad_bins: set = set()
        all_bins: set = set()
        for point_set in self.store.query(
                name, window_s=window_s, now=now)["points"]:
            for t, v in point_set["values"]:
                all_bins.add(t)
                if v < floor:
                    bad_bins.add(t)
        if not all_bins:
            return None
        return len(bad_bins) / len(all_bins)

    def _latency_bad(self, window_s: float, now: float) -> Optional[float]:
        hist = self.store.window_histogram(
            SERIES_E2E, window_s=window_s, now=now)
        if not hist.n:
            return None  # no served ticks in the window: nothing to judge
        return bad_fraction_above(hist, self.cfg.latency_p99_ms / 1e3)

    def _loss_bad(self, window_s: float, now: float) -> Optional[float]:
        ticks = self.store.window_total(
            SERIES_TICKS, window_s=window_s, now=now)
        losses = self.store.window_total(
            SERIES_LOSS, window_s=window_s, now=now)
        if ticks + losses <= 0:
            return None
        return losses / (ticks + losses)

    def _gauge_bad(self, name: str, window_s: float, now: float,
                   bound: float) -> Optional[float]:
        """Fraction of sampled intervals where ANY label variant of the
        gauge exceeds ``bound`` (one worker's backlog is the fleet's)."""
        bad_bins: set = set()
        all_bins: set = set()
        for point_set in self.store.query(
                name, window_s=window_s, now=now)["points"]:
            for t, v in point_set["values"]:
                all_bins.add(t)
                if v > bound:
                    bad_bins.add(t)
        if not all_bins:
            return None
        return len(bad_bins) / len(all_bins)

    # -- evaluation ---------------------------------------------------------

    def maybe_evaluate(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Evaluate when a full interval has elapsed (one clock read
        otherwise) — the router-loop entry point."""
        now = self.clock() if now is None else now
        if (self._last_eval is not None
                and now - self._last_eval < self.cfg.interval_s):
            return self._alerts
        return self.evaluate(now)

    def evaluate(self, now: Optional[float] = None) -> Dict[str, dict]:
        """One evaluation pass: burn rates over both windows for every
        objective, state transitions emitted as events + callbacks."""
        now = self.clock() if now is None else now
        self._last_eval = now
        threshold = self.cfg.burn_threshold
        for obj in self._objectives():
            name = obj["objective"]
            budget = obj["budget"]
            bad_fast = obj["bad"](self.cfg.fast_window_s, now)
            bad_slow = obj["bad"](self.cfg.slow_window_s, now)
            burn_fast = (bad_fast / budget) if bad_fast is not None else 0.0
            burn_slow = (bad_slow / budget) if bad_slow is not None else 0.0
            prev = self._alerts.get(name)
            was_firing = prev is not None and prev["state"] == "firing"
            if was_firing:
                # multi-window hysteresis: fire on fast AND slow, clear
                # the moment the fast window recovers
                firing = burn_fast >= threshold
            else:
                firing = (bad_fast is not None
                          and burn_fast >= threshold
                          and burn_slow >= threshold)
            alert = {
                "objective": name,
                "state": "firing" if firing else "ok",
                "burn_fast": round(burn_fast, 4),
                "burn_slow": round(burn_slow, 4),
                "burn_threshold": threshold,
                "budget": budget,
                "detail": obj["detail"],
                "since": (prev["since"] if prev is not None
                          and (firing == was_firing) else now),
            }
            self._alerts[name] = alert
            if firing and not was_firing:
                log.warning(
                    "SLO alert FIRING: %s (burn fast %.2fx / slow %.2fx "
                    "of budget %.4g)", name, burn_fast, burn_slow, budget)
                if self.events is not None:
                    self.events.emit("slo.alert_fired", objective=name,
                                     burn_fast=burn_fast,
                                     burn_slow=burn_slow, budget=budget)
                if self.on_fire is not None:
                    try:
                        self.on_fire(name, alert)
                    except Exception:  # noqa: BLE001 — loss-free: a
                        # recorder failure must never take alerting
                        # down; the alert itself still fires/exports
                        log.exception("slo on_fire hook raised")
            elif was_firing and not firing:
                log.warning("SLO alert resolved: %s (fast burn %.2fx)",
                            name, burn_fast)
                if self.events is not None:
                    self.events.emit("slo.alert_resolved", objective=name,
                                     burn_fast=burn_fast)
                if self.on_resolve is not None:
                    try:
                        self.on_resolve(name, alert)
                    except Exception:  # noqa: BLE001 — loss-free: hook-only failure; the resolve still lands
                        log.exception("slo on_resolve hook raised")
        return self._alerts

    # -- export -------------------------------------------------------------

    def alerts(self) -> Dict[str, object]:
        """The ``/alerts`` document: every objective's latest verdict
        plus the active count."""
        firing = sorted(
            name for name, a in self._alerts.items()
            if a["state"] == "firing")
        return {
            "firing": firing,
            "alerts": dict(self._alerts),
            "burn_threshold": self.cfg.burn_threshold,
        }

    def firing(self) -> List[str]:
        return sorted(name for name, a in self._alerts.items()
                      if a["state"] == "firing")

    def families(self) -> Snapshot:
        """Scrape-time collector: the active-alert gauge + per-objective
        burn-rate gauges (registry snapshot shape)."""
        gauges = [{
            "name": "slo_alerts_active",
            "labels": {},
            "value": len(self.firing()),
        }]
        for name, a in sorted(self._alerts.items()):
            for window in ("fast", "slow"):
                gauges.append({
                    "name": "slo_burn_rate",
                    "labels": {"objective": name, "window": window},
                    "value": a[f"burn_{window}"],
                })
            gauges.append({
                "name": "slo_alert_firing",
                "labels": {"objective": name},
                "value": 1.0 if a["state"] == "firing" else 0.0,
            })
        return {"gauges": gauges}

    def health_check(self):
        """A health check (fmda_tpu_torch.obs.observability shape): degraded
        while any alert fires — `status` exit codes integrate free."""
        firing = self.firing()
        if not firing:
            return True, f"{len(self._alerts)} objectives within budget"
        return False, {name: self._alerts[name]["detail"] for name in firing}
