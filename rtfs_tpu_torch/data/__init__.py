"""Data (counterpart of ``rtfs_tpu.data``): the manifest dataset
``AVSpeechDataset`` with ``normalize_wav``, the threaded
``PrefetchLoader``, the synthetic set, the mouth preprocessing
(``transforms``), WAV files (``wav``) and the manifest builders
(``manifests``)."""

from .dataset import AVSpeechDataset, normalize_wav  # noqa: F401
from .loader import PrefetchLoader, pin_and_copy  # noqa: F401
from .synthetic import SyntheticAVDataset  # noqa: F401
