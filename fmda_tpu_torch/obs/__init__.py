"""fmda_tpu_torch.obs: the observability plane.  So far the latency
histogram the fleet runtime reports through
(:class:`~fmda_tpu_torch.obs.registry.LatencyHistogram`)."""

from fmda_tpu_torch.obs.registry import LatencyHistogram

__all__ = ["LatencyHistogram"]
