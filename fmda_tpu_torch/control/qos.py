"""Per-tenant QoS: weighted fair shedding + quotas for the gateway queue,
as ``fmda_tpu.control.qos`` defines it.

One gateway queue serves every tenant; under overload *someone's* tick
must go.  Global oldest-drop (the pre-control gateway) lets one noisy
tenant starve everyone — the classic shared-queue failure.  The policy
here is WFQ in drop form: each priority class owns a **weight** (its
fair share of the queue) and a **quota** (a hard cap on its queued
ticks).  Admission is work-conserving — a tick is only ever refused
when the queue is contended — and the victim of a forced drop is always
the class most over its *normalized* share (``queued / weight``, the
WFQ virtual-time ordering).  Two consequences the tests pin:

- **starvation-freedom**: a class at or under its fair share is never
  shed while any class sits over its share, no matter the priorities;
- **bounded damage**: a class flooding past its quota sheds its OWN
  oldest tick (counted ``quota_shed``), so its overflow never evicts a
  well-behaved tenant's traffic.

Router-role code (no torch) and state-light (two dicts): the gateway calls
:meth:`classify` per submit and :meth:`pick_victim` only on the rare
contended path.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple


class QosPolicy:
    """Weighted tenant classes over one bounded queue.

    ``classes``/``weights``/``quota_frac`` are parallel (highest
    priority first, by convention).  A tenant label not in ``classes``
    maps to ``default_class``; a ``default_class`` missing from the
    class list is appended with weight 1 and an uncapped quota, so an
    unlabeled session always has a lane.
    """

    def __init__(
        self,
        classes: Sequence[str],
        weights: Sequence[float],
        quota_frac: Sequence[float],
        *,
        default_class: str = "standard",
    ) -> None:
        if len(classes) != len(weights) or len(classes) != len(quota_frac):
            raise ValueError(
                f"classes/weights/quota_frac must be parallel, got "
                f"{len(classes)}/{len(weights)}/{len(quota_frac)}")
        if not classes:
            raise ValueError("need at least one class (or no policy at all)")
        if len(set(classes)) != len(classes):
            raise ValueError(f"duplicate class names: {list(classes)}")
        classes = list(classes)
        weights = list(weights)
        quota_frac = list(quota_frac)
        if default_class not in classes:
            classes.append(default_class)
            weights.append(1.0)
            quota_frac.append(1.0)
        for w in weights:
            if w <= 0:
                raise ValueError(f"weights must be positive: {weights}")
        for q in quota_frac:
            if not 0.0 < q <= 1.0:
                raise ValueError(
                    f"quota_frac must be in (0, 1]: {quota_frac}")
        self.classes: Tuple[str, ...] = tuple(classes)
        self.default_class = default_class
        self._weight: Dict[str, float] = dict(zip(classes, weights))
        self._quota_frac: Dict[str, float] = dict(zip(classes, quota_frac))
        #: deterministic tie-break: later (= lower-priority) classes
        #: shed first when normalized shares are exactly equal
        self._rank = {c: i for i, c in enumerate(self.classes)}

    @classmethod
    def from_config(cls, cfg) -> Optional["QosPolicy"]:
        """Build from a :class:`~fmda_tpu_torch.config.ControlConfig`; None
        when no tenant classes are configured (QoS off — the gateway
        keeps its global oldest-drop)."""
        if not cfg.tenant_classes:
            return None
        return cls(cfg.tenant_classes, cfg.tenant_weights,
                   cfg.tenant_quota_frac, default_class=cfg.default_class)

    # -- classification -----------------------------------------------------

    def classify(self, tenant: Optional[str]) -> str:
        """The priority class of a tenant label (default for unknown/
        unlabeled — an unconfigured tenant must not error the hot path)."""
        if tenant is not None and tenant in self._weight:
            return tenant
        return self.default_class

    def weight(self, cls_name: str) -> float:
        return self._weight.get(cls_name, 1.0)

    def quota(self, cls_name: str, queue_bound: int) -> int:
        """Max queued ticks the class may hold (>= 1 so a class is
        never statically locked out)."""
        frac = self._quota_frac.get(cls_name, 1.0)
        return max(1, int(frac * queue_bound))

    # -- the WFQ drop decision ----------------------------------------------

    def pick_victim(self, queued: Mapping[str, int]) -> Optional[str]:
        """The class a forced drop should come from: the one most over
        its normalized fair share (``queued / weight`` — WFQ virtual
        time), lower priority losing ties.  None when nothing is
        queued."""
        best = None
        best_key = None
        for cls_name, n in queued.items():
            if n <= 0:
                continue
            key = (n / self._weight.get(cls_name, 1.0),
                   self._rank.get(cls_name, len(self._rank)))
            if best_key is None or key > best_key:
                best, best_key = cls_name, key
        return best

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``/control`` document's QoS section."""
        return {
            "classes": [
                {
                    "name": c,
                    "weight": self._weight[c],
                    "quota_frac": self._quota_frac[c],
                }
                for c in self.classes
            ],
            "default_class": self.default_class,
        }
