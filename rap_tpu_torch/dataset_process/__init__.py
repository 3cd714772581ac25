"""Offline training-data generation (counterpart of rap_tpu/dataset_process).

Host numpy: SLAM-style sequences -> multi-view submap samples -> FPS
keypoints + SpinNet descriptors (on the extractor's device) -> PLY / HDF5
training datasets + splits.
"""

from . import datasets, geometry, io, preview, splits, submaps
from .extract_features import SampleProcessor, process_dataset_folder
from .process import SequenceProcessingConfig, process_sequence
