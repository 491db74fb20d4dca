"""Evaluation metrics (counterpart of ``rtfs_tpu.metrics``): per-utterance
SI-SNR(i)/SDR(i) through the port's PIT losses, plus PESQ/STOI from
pypesq/pystoi when installed, else the bundled numpy ``pesq_np`` and
``stoi_np`` (numpy and scipy only)."""

from .tracker import ALLMetricsTracker  # noqa: F401
