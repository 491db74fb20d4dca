"""bf16 serving: the parameter cast and the dtype policy the modules read.

Counterpart of ``rtfs_tpu/utils/precision.py``. JAX's bf16 mode is the
pair ``replace(model, compute_dtype="bfloat16")`` plus
``cast_params(variables)``: every floating parameter and BatchNorm
statistic rounded to bf16, then each module computing as its inputs and
parameters promote (``rtfs_tpu/models/avnet.py:711-784``):

- a convolution casts its input to its weight's dtype (bf16 in, bf16
  out; ``rtfs_tpu/ops/convops.py``), so the STFT encoder's spectrum enters
  its conv as bf16 and the decoder's ConvTranspose2d runs in bf16 too;
- gLN and LayerNormalization4D take their statistics in float32,
  normalise, round to the input's dtype, then apply gamma and beta in it;
- the audio and video bottlenecks, the refinement module and the mask
  generator run in bf16; the 1-D MHSA's float32 positional table promotes
  that block to float32 until the next convolution casts back;
- attention takes its score and value products in float32;
- ``separated`` goes back to float32 before the decoder, and the iSTFT
  and the waveform are float32.

``build_avnet`` applies ``cast_params`` when a config's
``audionet.compute_dtype`` is ``"bfloat16"``; the port's kernels K1-K3
(and K5-K9 in the packed layout) then run their bf16 entries. bf16 is for
serving only.
"""

from __future__ import annotations

import torch
import torch.nn as nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``compute_dtype`` string."""
    if name not in DTYPES:
        raise NotImplementedError(
            f"compute_dtype {name!r}: the port takes "
            f"{' or '.join(DTYPES)}")
    return DTYPES[name]


def cast_params(obj, dtype: torch.dtype = torch.bfloat16):
    """Round every floating parameter and persistent buffer to ``dtype``.

    ``obj``: an ``nn.Module`` (cast in place and returned) or a state_dict
    (a new dict returned). Non-floating entries (BatchNorm's step counter)
    are left alone, and so are a module's non-persistent buffers, which
    JAX computes as float32 constants (the positional table).
    """
    if isinstance(obj, nn.Module):
        for p in obj.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
        for mod in obj.modules():
            skip = getattr(mod, "_non_persistent_buffers_set", set())
            for name, b in mod.named_buffers(recurse=False):
                if b is not None and b.is_floating_point() and name not in skip:
                    setattr(mod, name, b.to(dtype))
        return obj
    return {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in obj.items()}
