"""Data (counterpart of ``rtfs_tpu.data``): the synthetic set, the mouth
preprocessing (``transforms``) and WAV files (``wav``)."""

from .synthetic import SyntheticAVDataset  # noqa: F401
