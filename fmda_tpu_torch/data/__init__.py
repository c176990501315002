from fmda_tpu_torch.data.normalize import NormParams, chunk_norm_params, normalize
from fmda_tpu_torch.data.source import FeatureSource
from fmda_tpu_torch.data.windows import window_index_matrix

__all__ = [
    "FeatureSource", "NormParams", "chunk_norm_params",
    "normalize", "window_index_matrix",
]
