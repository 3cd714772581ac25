"""MiniSpinNet local descriptors (counterpart of rap_tpu/spinnet)."""

from .model import (
    MiniSpinNet,
    SpinNetConfig,
    build_feature_extractor,
    extract_features,
    extract_patches,
    init_spinnet,
    load_spinnet,
)

__all__ = [
    "MiniSpinNet", "SpinNetConfig", "build_feature_extractor", "extract_features",
    "extract_patches", "init_spinnet", "load_spinnet",
]
