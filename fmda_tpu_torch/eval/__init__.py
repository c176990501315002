"""Model evaluation, as ``fmda_tpu.eval`` has it: one numpy metric
vocabulary (:mod:`fmda_tpu_torch.eval.metrics`) shared by the offline
trainer reports and an online evaluator, and a PSI drift monitor against
the training-time reference profile written beside each checkpoint
(:mod:`fmda_tpu_torch.eval.drift`).  Both are numpy only.  The hot-swap
guardrail, :class:`fmda_tpu_torch.eval.shadow.ShadowEvaluator`, is
imported from its module, as the reference's is."""

from fmda_tpu_torch.eval.drift import (
    DriftMonitor,
    build_profile,
    load_profile,
    profile_path_for,
    psi,
    save_profile,
)
from fmda_tpu_torch.eval.metrics import (
    StreamingCounts,
    batch_counts,
    threshold_probs,
)

__all__ = [
    "DriftMonitor",
    "StreamingCounts",
    "batch_counts",
    "build_profile",
    "load_profile",
    "profile_path_for",
    "psi",
    "save_profile",
    "threshold_probs",
]
