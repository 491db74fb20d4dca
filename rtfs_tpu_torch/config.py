"""Config loading, the AVNet builder and the lip backbone's (counterparts
of ``rtfs_tpu/config.py`` and ``rtfs_tpu/models/video.py:make_video_model``).

Presets ship as JSON copies of the JAX package's YAML files, read with the
standard library; a ``.yaml`` path is accepted only where PyYAML imports.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from .models.avnet import AVNet, init_weights
from .models.video import FRCNNVideoModel

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


def load_config(name_or_path: str) -> Dict[str, Any]:
    """Load a config by file path (.json, or .yaml if PyYAML is present)
    or by bundled preset name."""
    path = name_or_path
    if not os.path.exists(path):
        cand = os.path.join(CONFIG_DIR, name_or_path)
        if not cand.endswith(".json"):
            cand += ".json"
        if not os.path.exists(cand):
            raise FileNotFoundError(name_or_path)
        path = cand
    if path.endswith((".yaml", ".yml")):
        import yaml  # optional: only for YAML paths

        with open(path) as f:
            return yaml.safe_load(f)
    with open(path) as f:
        return json.load(f)


def list_presets() -> list[str]:
    return sorted(
        f[: -len(".json")] for f in os.listdir(CONFIG_DIR) if f.endswith(".json")
    )


def _device(device, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: CUDA requested but torch.cuda.is_available() is "
            "False; pass device='cpu' for the CPU path"
        )
    return device


def build_avnet(conf: Dict[str, Any], device: str | torch.device = "cuda",
                seed: int = 0) -> AVNet:
    """Build the AVNet from a full config (its ``audionet`` group), draw its
    weights from ``seed`` with a CPU ``torch.Generator`` (the same weights on
    every device), and move it to ``device`` in eval mode.

    Raises if ``device`` is CUDA and no GPU is present: there is no CPU
    fallback. Pass ``device="cpu"`` for the CPU path.
    """
    device = _device(device, "build_avnet")
    a = conf["audionet"]
    if a.get("compute_dtype", "float32") != "float32":
        raise NotImplementedError("rtfs_tpu_torch serves float32 only")
    if a.get("packed_tf", False) or a.get("batch_fold", 1) != 1:
        raise NotImplementedError("packed_tf / batch_fold are not ported")
    model = AVNet(
        n_src=a["n_src"],
        enc_dec_params=a["enc_dec_params"],
        audio_bn_params=a.get("audio_bn_params", {}),
        audio_params=a["audio_params"],
        mask_generation_params=a["mask_generation_params"],
        pretrained_vout_chan=a.get("pretrained_vout_chan", -1),
        video_bn_params=a.get("video_bn_params", {}),
        video_params=a.get("video_params", {}),
        fusion_params=a.get("fusion_params", {}),
    )
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def build_video_model(conf: Dict[str, Any],
                      device: str | torch.device = "cuda",
                      seed: int = 0) -> Optional[FRCNNVideoModel]:
    """The frozen lip backbone of a full config (its ``videonet`` group),
    eval mode, no gradients, on ``device``; None for an audio-only config.

    The weights are drawn from ``seed``, the JAX trainer's smoke mode
    (``train.py:135-139``): loading a pretrained checkpoint named by
    ``videonet.pretrain`` is not ported, so such a name only warns.
    """
    vconf = conf.get("videonet")
    if not vconf:
        return None
    device = _device(device, "build_video_model")
    if vconf.get("model_name", "FRCNNVideoModel") != "FRCNNVideoModel":
        raise NotImplementedError(
            f"video model {vconf['model_name']!r} is not ported")
    model = FRCNNVideoModel(vconf.get("backbone_type", "resnet"),
                            vconf.get("relu_type", "prelu"))
    if vconf.get("pretrain"):
        print(f"WARNING: videonet.pretrain={vconf['pretrain']} is not "
              "loaded by the port; the frozen lip backbone is drawn from the "
              "seed (smoke mode)")
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval().requires_grad_(False)
