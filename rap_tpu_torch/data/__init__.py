"""Data path of the port: PLY-folder datasets, the packer and the loader
(counterpart of rap_tpu/data)."""

from .dataset import DatasetConfig, PointCloudDataset, Sample, augment_sample
from .loader import BatchLoader, LoaderConfig, PaddingStats
from .packer import BatchPlan, collate_to_part_batch, plan_batches

__all__ = [
    "BatchLoader", "BatchPlan", "DatasetConfig", "LoaderConfig", "PaddingStats",
    "PointCloudDataset", "Sample", "augment_sample", "collate_to_part_batch",
    "plan_batches",
]
