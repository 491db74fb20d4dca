"""Datasets (counterpart of ``rtfs_tpu.data``): the synthetic set only."""

from .synthetic import SyntheticAVDataset  # noqa: F401
