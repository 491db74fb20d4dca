"""AVNet: the top-level audio-visual separation model (RTFS-Net family).

Counterpart of ``rtfs_tpu/models/avnet.py``, inference in float32:

  STFT encoder -> audio bottleneck -> RefinementModule (TDANet repeats +
  CAF fusion with the video net) -> S3 mask -> iSTFT decoder

Inputs: waveform (B, L) and the lip embedding (B, T2, C2), the JAX
package's boundary layouts; inside, maps are channels-first (B, C, T, F).
Parameter names are the reference's (``convert_avnet`` reads them).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..ops import stft as stft_ops
from . import layers as L
from .fusion_layers import ATTNFusionCell
from .separators import make_separator


def _kwargs_for(cls, conf: Dict[str, Any], exclude=()) -> Dict[str, Any]:
    params = inspect.signature(cls.__init__).parameters
    return {k: v for k, v in conf.items() if k in params and k not in exclude}


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every randomly initialised parameter of ``model`` from
    ``generator``, in module order."""
    for m in model.modules():
        if m is not model and hasattr(m, "init_weights"):
            m.init_weights(generator)


class STFTEncoder(nn.Module):
    """STFT -> (real, imag) channels -> 2-D conv (reference
    ``encoder.py:122-175``). (B, L) -> (B, C, T, F)."""

    def __init__(self, win, hop_length, out_chan=2, kernel_size=-1, stride=1,
                 act_type="ReLU", norm_type="gLN", bias=False):
        super().__init__()
        self.win, self.hop_length = win, hop_length
        self.conv = L.ConvNormAct(2, out_chan, kernel_size, stride=stride,
                                  act_type=act_type, norm_type=norm_type,
                                  xavier_init=True, bias=bias, is2d=True)

    def forward(self, x):
        window = stft_ops.hann_window(self.win, device=x.device, dtype=x.dtype)
        spec = stft_ops.stft(x, self.win, self.hop_length, window)  # (B, F, T)
        spec = torch.stack([spec.real, spec.imag], dim=1).transpose(2, 3)
        return self.conv(spec)


class STFTDecoder(nn.Module):
    """ConvTranspose2d -> complex -> iSTFT (reference ``decoder.py:72-132``).
    (B, n_src, C, T, F) -> (B, n_src, length)."""

    def __init__(self, win, hop_length, in_chan, n_src, kernel_size=-1,
                 stride=1, bias=False):
        super().__init__()
        self.win, self.hop_length = win, hop_length
        self.decoder = (
            L.ConvTranspose(in_chan, 2, kernel_size, stride=stride,
                            padding=(kernel_size - 1) // 2, bias=bias,
                            xavier_init=True, nd=2)
            if kernel_size > 0 else nn.Identity()
        )

    def forward(self, x, length: int):
        b, n_src = x.shape[:2]
        x = self.decoder(x.reshape(b * n_src, *x.shape[2:]))  # (B*n, 2, T, F)
        spec = torch.complex(x[:, 0], x[:, 1]).transpose(1, 2)  # (B*n, F, T)
        window = stft_ops.hann_window(self.win, device=x.device, dtype=x.dtype)
        wav = stft_ops.istft(spec, self.win, self.hop_length, window, length)
        return wav.reshape(b, n_src, length)


class MaskGenerator(nn.Module):
    """S3 mask head: PReLU + ConvNormAct; ``RI_split`` multiplies mask and
    embedding as complex numbers, (real, imag) = channel halves
    (reference ``mask_generator.py:20-99``)."""

    def __init__(self, n_src, audio_emb_dim, bottleneck_chan, kernel_size=1,
                 mask_act="ReLU", RI_split=False, output_gate=False,
                 dw_gate=False, direct=False, is2d=False):
        super().__init__()
        if output_gate or direct:
            raise NotImplementedError("output_gate / direct are not ported")
        self.n_src, self.c, self.ri_split = n_src, audio_emb_dim, RI_split
        self.mask_generator = nn.Sequential(
            nn.PReLU(),
            L.ConvNormAct(bottleneck_chan, n_src * audio_emb_dim, kernel_size,
                          act_type=mask_act, is2d=is2d),
        )

    def forward(self, refined, embedding):
        masks = self.mask_generator(refined)  # (B, n_src*C, T, F)
        c, h = self.c, self.c // 2
        out = []
        for s in range(self.n_src):
            m = masks[:, s * c:(s + 1) * c]
            if self.ri_split:
                er, ei = embedding[:, :h], embedding[:, h:]
                mr, mi = m[:, :h], m[:, h:]
                out.append(torch.cat([er * mr - ei * mi, er * mi + ei * mr], 1))
            else:
                out.append(m * embedding)
        return torch.stack(out, dim=1)  # (B, n_src, C, T, F)


class ATTNFusion(nn.Module):
    """CAF fusion (``TDAVNet/fusion.py:187-212``): audio refined by video;
    the reverse direction only when ``video_fusion``."""

    def __init__(self, ain_chan, vin_chan, kernel_size, video_fusion=True,
                 is2d=False):
        super().__init__()
        self.video_lstm = (ATTNFusionCell(vin_chan, ain_chan, kernel_size)
                           if video_fusion else None)
        self.audio_lstm = ATTNFusionCell(ain_chan, vin_chan, kernel_size,
                                         is2d=is2d)

    def forward(self, audio, video):
        video_fused = (self.video_lstm(video, audio)
                       if self.video_lstm is not None else video)
        return self.audio_lstm(audio, video), video_fused


class MultiModalFusion(nn.Module):
    """Shared or per-repeat fusion blocks (``TDAVNet/fusion.py:215-281``)."""

    def __init__(self, audio_bn_chan, video_bn_chan, kernel_size=1,
                 fusion_repeats=3, fusion_type="ATTNFusion",
                 fusion_shared=False, is2d=False):
        super().__init__()
        if fusion_type != "ATTNFusion":
            raise NotImplementedError(f"fusion {fusion_type} is not ported")
        self.fusion_shared = fusion_shared
        self.fusion_module = None
        if fusion_repeats == 0:
            return

        def make(i):
            vf = (fusion_repeats > 1 if fusion_shared
                  else i != fusion_repeats - 1)
            return ATTNFusion(audio_bn_chan, video_bn_chan, kernel_size,
                              video_fusion=vf, is2d=is2d)

        self.fusion_module = make(0) if fusion_shared else nn.ModuleList(
            make(i) for i in range(fusion_repeats))

    def fuse(self, i: int, audio, video):
        mod = self.fusion_module if self.fusion_shared else self.fusion_module[i]
        return mod(audio, video)


class RefinementModule(nn.Module):
    """``fusion_repeats`` joint audio + video + fusion repeats, then audio-only
    repeats, each re-injecting the input (``refinement_module.py:10-62``)."""

    def __init__(self, audio_params, video_params, audio_bn_chan,
                 video_bn_chan, fusion_params):
        super().__init__()
        self.fusion_repeats = video_params.get("repeats", 0)
        self.audio_repeats = audio_params["repeats"] - self.fusion_repeats
        self.audio_net = make_separator(audio_params, audio_bn_chan)
        self.video_net = make_separator(video_params, video_bn_chan)
        self.crossmodal_fusion = MultiModalFusion(
            audio_bn_chan=audio_bn_chan, video_bn_chan=video_bn_chan,
            fusion_repeats=self.fusion_repeats,
            **_kwargs_for(MultiModalFusion, fusion_params,
                          exclude=("audio_bn_chan", "video_bn_chan",
                                   "fusion_repeats")),
        )

    def forward(self, audio, video):
        audio_residual, video_residual = audio, video
        for i in range(self.fusion_repeats):
            audio = self.audio_net.block(i, audio + audio_residual if i else audio)
            video = self.video_net.block(i, video + video_residual if i else video)
            audio, video = self.crossmodal_fusion.fuse(i, audio, video)
        for i in range(self.fusion_repeats,
                       self.fusion_repeats + self.audio_repeats):
            audio = self.audio_net.block(i, audio + audio_residual if i else audio)
        return audio


class AVNet(nn.Module):
    """Top model (reference ``tdavnet.py:14-108``) for STFT encoder/decoder
    configs. ``forward(audio_mixture (B, L), mouth_embedding (B, T2, C2) or
    None) -> (B, n_src, L)``."""

    def __init__(self, n_src, enc_dec_params, audio_bn_params, audio_params,
                 mask_generation_params, pretrained_vout_chan=-1,
                 video_bn_params=None, video_params=None, fusion_params=None):
        super().__init__()
        video_bn_params = dict(video_bn_params or {})
        edp = dict(enc_dec_params)
        enc_type, dec_type = edp.pop("encoder_type"), edp.pop("decoder_type")
        if enc_type != "STFTEncoder" or dec_type != "STFTDecoder":
            raise NotImplementedError(f"{enc_type}/{dec_type} are not ported")
        self.encoder = STFTEncoder(**_kwargs_for(STFTEncoder, edp))
        enc_out_chan = edp["out_chan"] if edp.get("kernel_size", -1) > 0 else 2

        audio_bn_chan = audio_bn_params.get("out_chan", enc_out_chan)
        abn = dict(audio_bn_params)
        abn.setdefault("out_chan", audio_bn_chan)
        abn.setdefault("kernel_size", 1)
        self.audio_bottleneck = L.ConvNormAct(
            in_chan=enc_out_chan,
            **_kwargs_for(L.ConvNormAct, abn, exclude=("in_chan",)))
        video_bn_chan = video_bn_params.get("out_chan", pretrained_vout_chan)
        vbn = dict(video_bn_params)
        vbn.setdefault("kernel_size", -1)  # identity when unconfigured
        vbn.setdefault("out_chan", max(video_bn_chan, 1))
        self.video_bottleneck = L.ConvNormAct(
            in_chan=max(pretrained_vout_chan, 1),
            **_kwargs_for(L.ConvNormAct, vbn, exclude=("in_chan",)))
        if vbn["kernel_size"] <= 0:
            video_bn_chan = pretrained_vout_chan

        self.refinement_module = RefinementModule(
            audio_params, dict(video_params or {}), audio_bn_chan,
            video_bn_chan, dict(fusion_params or {}))
        mgp = dict(mask_generation_params)
        if mgp.pop("mask_generator_type", "MaskGenerator") != "MaskGenerator":
            raise NotImplementedError("only MaskGenerator is ported")
        self.mask_generator = MaskGenerator(
            n_src=n_src, audio_emb_dim=enc_out_chan,
            bottleneck_chan=audio_bn_chan,
            **_kwargs_for(MaskGenerator, mgp,
                          exclude=("n_src", "audio_emb_dim", "bottleneck_chan")))
        self.decoder = STFTDecoder(
            in_chan=enc_out_chan, n_src=n_src,
            **_kwargs_for(STFTDecoder, edp, exclude=("in_chan", "n_src")))

    def forward(self, audio_mixture: torch.Tensor,
                mouth_embedding: Optional[torch.Tensor] = None):
        length = audio_mixture.shape[-1]
        embedding = self.encoder(audio_mixture)  # (B, C, T, F)
        audio = self.audio_bottleneck(embedding)
        video = None
        if mouth_embedding is not None:
            video = self.video_bottleneck(mouth_embedding.transpose(1, 2))
        refined = self.refinement_module(audio, video)
        separated = self.mask_generator(refined, embedding)
        return self.decoder(separated, length)
