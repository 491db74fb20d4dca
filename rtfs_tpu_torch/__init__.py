"""rtfs_tpu_torch: RTFS-Net serving in PyTorch, with hand-written CUDA kernels.

The PyTorch/CUDA counterpart of ``rtfs_tpu``. Module names mirror the JAX
package (``rtfs_tpu_torch/ops/sru_fused.py`` <-> ``rtfs_tpu/ops/sru_fused.py``
and so on); ``rtfs_tpu`` stays the numerical reference the tests hold this
package against. This package imports ``torch`` and never ``jax`` or
anything under ``rtfs_tpu``.

Layouts are channels-first, as PyTorch's convolutions are: 2-D maps are
(B, C, T, F), 1-D maps (B, C, T). Each kernel wrapper keeps the boundary
layout of the Pallas kernel it replaces (time-major ``(T, C, B)``).

Entry points run on the GPU unless the caller asks for the CPU::

    from rtfs_tpu_torch.config import build_avnet, load_config
    from rtfs_tpu_torch.utils.separator import separate_sample

    model = build_avnet(load_config("lrs2_RTFSNet_4_layer"))  # device="cuda"
    est = separate_sample(model, wav, mouth_emb)
"""
