"""Training system (counterpart of ``rtfs_tpu.train``): ``AVSystem``, the
optimizer and schedules, checkpoints, and the entry ``train.main``."""

from .optim import (  # noqa: F401
    EpochDivideLR,
    ReduceLROnPlateau,
    make_optimizer,
)
from .system import AVSystem, make_generator  # noqa: F401
