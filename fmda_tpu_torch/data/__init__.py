from fmda_tpu_torch.data.normalize import NormParams, chunk_norm_params, normalize
from fmda_tpu_torch.data.pipeline import (
    Batch,
    ChunkDataset,
    WindowBatches,
    background_compose,
    prefetch_batches,
)
from fmda_tpu_torch.data.source import ArraySource, FeatureSource
from fmda_tpu_torch.data.windows import (
    chunk_ranges,
    train_val_test_split,
    window_index_matrix,
)

__all__ = [
    "ArraySource", "Batch", "ChunkDataset", "FeatureSource", "NormParams",
    "WindowBatches", "background_compose", "chunk_norm_params",
    "chunk_ranges", "normalize", "prefetch_batches", "train_val_test_split",
    "window_index_matrix",
]
