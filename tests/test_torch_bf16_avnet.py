"""The bf16 serving slice: the port's bf16 AVNet against rtfs_tpu's.

JAX's bf16 mode is ``replace(model, compute_dtype="bfloat16")`` applied to
``cast_params(variables)``; the port's is ``build_avnet`` with
``audionet.compute_dtype: "bfloat16"`` (its parameters rounded by
``rtfs_tpu_torch.utils.precision.cast_params``) filled by
``load_jax_params`` from the same cast variables. Geometry as
tests/test_torch_avnet.py: the preset with repeats 2 (audio) and 1
(video), published widths, a 3968-sample waveform, an (8, 512) mouth
embedding, perturbed weights. The JAX side runs with the Pallas SRU path
in interpret mode (``RTFS_SRU_BACKEND=interpret``): its fused stack is
what the port mirrors (bf16 h between layers), where the default CPU
backend's scan keeps the SRU in float32.

Whole-model gates (measured here: max error 8.4e-3 of max|ref|, SI-SNR
39.8 / 40.1 dB, the port's error against JAX's float32 output 2.3e-3
against JAX's own 2.5e-3):

- max |port - jax_bf16| <= 3e-2 max |jax_bf16|;
- SI-SNR of the port's waveform against JAX's >= 25 dB;
- the port's max error against JAX's float32 output no more than 2x
  JAX's own bf16 error against it.

The dtype at each module boundary is held against JAX's own
(``capture_intermediates`` under ``jax.eval_shape``): that oracle, not a
summary of it, shows the encoder's output bf16 already (its conv casts the
float32 spectrum to its bf16 weight's dtype), the video net's global
attention float32 (its positional table), ``separated``'s decoder conv
bf16 and the waveform float32. ~50 s alone (one JAX init, two jitted
applies of ~11 s in interpret mode).
"""

import dataclasses
import json

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.config import build_avnet as jax_build_avnet
from rtfs_tpu.config import load_config as jax_load_config
from rtfs_tpu.models import layers as JL
from rtfs_tpu.utils.precision import cast_params as jax_cast_params
from rtfs_tpu.utils.torch_import import convert_avnet
from rtfs_tpu_torch import inference
from rtfs_tpu_torch.config import build_avnet, build_video_model, load_config
from rtfs_tpu_torch.data.transforms import preprocess_mouth
from rtfs_tpu_torch.data.wav import read_wav, write_wav
from rtfs_tpu_torch.models import layers as TL
from rtfs_tpu_torch.train.checkpoints import export_model
from rtfs_tpu_torch.utils.precision import cast_params
from rtfs_tpu_torch.utils.separator import separate_sample
from rtfs_tpu_torch.utils.weights import load_jax_params

PRESET = "lrs2_RTFSNet_4_layer"
MAX_ERR_REL = 3e-2
SISNR_DB = 25.0
F32_ERR_FACTOR = 2.0


def sisnr_db(est: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """SI-SNR of est against ref over the last axis, in dB."""
    est = est - est.mean(-1, keepdims=True)
    ref = ref - ref.mean(-1, keepdims=True)
    proj = (est * ref).sum(-1, keepdims=True) / (ref * ref).sum(
        -1, keepdims=True) * ref
    return 10 * np.log10((proj ** 2).sum(-1) / ((est - proj) ** 2).sum(-1))


def _bf16_conf(conf):
    return dict(conf, audionet=dict(conf["audionet"],
                                    compute_dtype="bfloat16"))


@pytest.fixture(scope="module")
def pair():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    conf = jax_load_config(PRESET)
    conf["audionet"]["audio_params"]["repeats"] = 2
    conf["audionet"]["video_params"]["repeats"] = 1
    jmodel = jax_build_avnet(conf)
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 3968)) * 0.1).astype(np.float32)
    mouth = rng.standard_normal((2, 8, 512)).astype(np.float32)
    variables = jax.tree.map(
        np.asarray,
        jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)}, wav, mouth))

    def perturb(path, x):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    cast = jax.tree.map(np.asarray, jax_cast_params(variables))
    jmodel16 = dataclasses.replace(jmodel, compute_dtype="bfloat16")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTFS_SRU_BACKEND", "interpret")
        ref16 = np.asarray(jax.jit(jmodel16.apply)(cast, wav, mouth))
        ref32 = np.asarray(jax.jit(jmodel.apply)(variables, wav, mouth))
        _, state = jax.eval_shape(
            lambda v: jmodel16.apply(v, wav, mouth, capture_intermediates=True,
                                     mutable=["intermediates"]), cast)
    port = build_avnet(_bf16_conf(conf), device="cpu")
    load_jax_params(port, cast)
    yield dict(conf=conf, cast=cast, port=port, wav=wav, mouth=mouth,
               ref16=ref16, ref32=ref32, dtypes=state["intermediates"])
    torch.set_num_threads(threads)


def test_bf16_avnet_meets_the_gates_against_jax(pair):
    p = pair
    with torch.no_grad():
        got = p["port"](torch.from_numpy(p["wav"]),
                        torch.from_numpy(p["mouth"]))
    assert got.dtype == torch.float32 and p["ref16"].dtype == np.float32
    got = got.numpy()
    ref16, ref32 = p["ref16"], p["ref32"]
    assert got.shape == ref16.shape == (2, 1, 3968)
    err = np.abs(got - ref16).max()
    print(f"max err {err / np.abs(ref16).max():.3g} of max|ref|, SI-SNR "
          f"{sisnr_db(got, ref16).ravel()} dB, error against float32: port "
          f"{np.abs(got - ref32).max():.3g}, jax "
          f"{np.abs(ref16 - ref32).max():.3g}")
    assert err <= MAX_ERR_REL * np.abs(ref16).max(), err
    assert (sisnr_db(got, ref16) >= SISNR_DB).all()
    assert (np.abs(got - ref32).max()
            <= F32_ERR_FACTOR * np.abs(ref16 - ref32).max())


def test_bf16_forward_calls_each_kernel_as_chip_smoke_counts(pair,
                                                           monkeypatch):
    """A bf16 forward reaches K1, K2 and K3 as often as
    ``chip_smoke.BF16_LAUNCHES`` says a forward of the preset's repeats
    launches their bf16 entries on the card, scaled to this model's
    repeats, every call with bf16 inputs."""
    import chip_smoke
    from rtfs_tpu_torch.ops import convt_tm, sru_fused

    calls = {}

    def counted(name, fn):
        def wrap(*args, **kw):
            assert all(a.dtype == torch.bfloat16 for a in args
                       if torch.is_tensor(a)), name
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrap

    for mod, fn, entry in ((sru_fused, "_k1_forward",
                            "sru_dual_recurrence_fwd_bf16"),
                           (sru_fused, "_k2_forward",
                            "sru_hidden_layer_fwd_bf16"),
                           (convt_tm, "_forward", "convt1d_ola_tm_fwd_bf16")):
        monkeypatch.setattr(mod, fn, counted(entry, getattr(mod, fn)))
    with torch.no_grad():
        pair["port"](torch.from_numpy(pair["wav"]),
                     torch.from_numpy(pair["mouth"]))
    repeats = pair["conf"]["audionet"]["audio_params"]["repeats"]
    assert calls == {k: v * repeats // chip_smoke.REPEATS
                     for k, v in chip_smoke.BF16_LAUNCHES.items()}


def test_bf16_weights_round_trip_bit_for_bit(pair):
    """load_jax_params of cast_params(variables) into the bf16 port, then
    convert_avnet of its bf16 state_dict, gives the cast leaves back with
    the same bits."""
    sd = {k: v.float().numpy().astype(ml_dtypes.bfloat16)
          if v.dtype == torch.bfloat16 else v.numpy()
          for k, v in pair["port"].state_dict().items()}
    assert {str(v.dtype) for v in pair["port"].state_dict().values()
            if v.is_floating_point()} == {"torch.bfloat16"}
    back = convert_avnet(sd, pair["conf"]["audionet"])
    want = dict(jax.tree_util.tree_leaves_with_path(pair["cast"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, value in want.items():
        assert value.dtype == np.asarray(got[path]).dtype, path
        np.testing.assert_array_equal(
            np.asarray(got[path]).view(np.uint16), value.view(np.uint16),
            err_msg=str(path))


# JAX module path -> the port's module, for the boundaries both have
BOUNDARIES = {
    "encoder": "encoder",
    "audio_bottleneck": "audio_bottleneck",
    "video_bottleneck": "video_bottleneck",
    "refinement_module": "refinement_module",
    "mask_generator": "mask_generator",
    "decoder": "decoder",
    "decoder/ConvTranspose_0": "decoder.decoder",
    "refinement_module/crossmodal_fusion/fusion_module/ATTNFusionCell_0":
        "refinement_module.crossmodal_fusion.fusion_module.audio_lstm",
}
for _net, _layers in (("audio_net", ("gateway", "projection",
                                     "downsample_layers_0",
                                     "downsample_layers_1", "globalatt_0",
                                     "globalatt_1", "globalatt_2",
                                     "fusion_layers_0", "fusion_layers_1",
                                     "concat_layers_0", "residual_conv")),
                      ("video_net", ("gateway", "projection",
                                     "downsample_layers_3", "globalatt_0",
                                     "fusion_layers_3", "concat_layers_2",
                                     "residual_conv"))):
    _blk = f"refinement_module/{_net}/blocks"
    BOUNDARIES[_blk] = _blk.replace("/", ".")
    for _l in _layers:
        _name, _, _i = _l.rpartition("_")
        BOUNDARIES[f"{_blk}/{_l}"] = (
            f"{_blk}/{_name}.{_i}" if _i.isdigit() else f"{_blk}/{_l}"
        ).replace("/", ".")
_vga = "refinement_module/video_net/blocks/globalatt_0"
BOUNDARIES[f"{_vga}/MultiHeadSelfAttention_0"] = (
    _vga.replace("/", ".").replace("globalatt_0", "globalatt.0") + ".MHSA")
BOUNDARIES[f"{_vga}/MultiHeadSelfAttention_0/TorchMHA_0"] = (
    BOUNDARIES[f"{_vga}/MultiHeadSelfAttention_0"] + ".attention")
BOUNDARIES[f"{_vga}/FeedForwardNetwork_0"] = (
    _vga.replace("/", ".").replace("globalatt_0", "globalatt.0") + ".FFN")


def _jax_dtypes(tree, path):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return {str(x.dtype) for x in jax.tree.leaves(node["__call__"])}


def test_bf16_dtypes_at_module_boundaries_are_jax_s(pair):
    """Every listed boundary's output dtype(s) in the port's forward equal
    JAX's in its bf16 forward: bf16 through the bottlenecks, the
    refinement module and the mask generator; float32 where JAX's
    positional table promotes (the video net's global attention) and at
    the decoder's output."""
    port = pair["port"]
    seen = {name: set() for name in BOUNDARIES.values()}
    mods = dict(port.named_modules())
    hooks = []
    for name in seen:
        def hook(_m, _inp, out, name=name):
            outs = out if isinstance(out, tuple) else (out,)
            seen[name] |= {str(t.dtype).replace("torch.", "")
                           for t in outs if torch.is_tensor(t)}
        hooks.append(mods[name].register_forward_hook(hook))
    try:
        with torch.no_grad():
            port(torch.from_numpy(pair["wav"]), torch.from_numpy(pair["mouth"]))
    finally:
        for h in hooks:
            h.remove()
    for jpath, tname in BOUNDARIES.items():
        assert seen[tname] == _jax_dtypes(pair["dtypes"], jpath), (jpath,
                                                                    tname)
    assert _jax_dtypes(pair["dtypes"], "encoder") == {"bfloat16"}
    assert _jax_dtypes(pair["dtypes"], "decoder") == {"float32"}
    assert _jax_dtypes(pair["dtypes"], f"{_vga}/MultiHeadSelfAttention_0") \
        == {"float32"}


@pytest.mark.parametrize("norm", ["gLN", "LN4D"])
def test_bf16_norms_take_float32_statistics(norm):
    """gLN and LN4D on a bf16 map with an offset (mean 16, std 1: a bf16
    mean is off by up to 1/16, a std by more) against JAX's norms with
    bf16 parameters, which take float32 statistics, normalise, round, then
    apply gamma and beta in bf16: |diff| <= 2^-6 max(|ref|, 2^-6), the
    normalised value's rounding and the affine's two roundings apart
    (bf16 statistics miss by several times that)."""
    rng = np.random.default_rng(4)
    x = (16 + rng.standard_normal((2, 5, 6, 8))).astype(np.float32).astype(
        ml_dtypes.bfloat16)  # (B, T, F, C), JAX's layout
    g = (1 + 0.1 * rng.standard_normal(8)).astype(np.float32)
    b = (0.1 * rng.standard_normal(8)).astype(np.float32)
    if norm == "gLN":
        jmod, tmod = JL.GlobalLayerNorm(8), TL.GlobalLayerNorm(8)
        params = {"scale": g, "bias": b}
        tmod.norm.weight.data, tmod.norm.bias.data = (torch.from_numpy(g),
                                                      torch.from_numpy(b))
    else:
        jmod, tmod = JL.LayerNormalization4D(8), TL.LayerNormalization4D(8)
        params = {"scale": g.reshape(1, 1, 1, 8), "bias": b.reshape(1, 1, 1, 8)}
        tmod.gamma.data = torch.from_numpy(g.reshape(1, 8, 1, 1))
        tmod.beta.data = torch.from_numpy(b.reshape(1, 8, 1, 1))
    ref = np.asarray(jmod.apply(jax_cast_params({"params": params}),
                                jnp.asarray(x)), np.float32)
    cast_params(tmod)
    tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got = tmod(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    bound = 2.0 ** -6 * np.maximum(np.abs(ref), 2.0 ** -6)
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()
    assert np.abs(ref).max() < 8  # normalised: the offset is gone


def test_bf16_refusals():
    """batch_fold raises at build, and so does float16. An SRU off the
    fused stack (unidirectional, K4), refused until K4 took bf16, now
    builds in bf16 and serves; packed_tf, with K5-K9's bf16 entries,
    builds and serves, whether set in the config or on a built bf16 model.
    Every bf16 model trains (AVSystem and the train entry's build_system
    take the standard, the packed and the unidirectional one, K4's and
    K5-K9's bf16 backwards ported); the train entry still raises for
    batch_fold before it writes anything."""
    from rtfs_tpu_torch.ops.sru import SRU
    from rtfs_tpu_torch.train import main as train_main
    from rtfs_tpu_torch.train.system import AVSystem

    conf = _bf16_conf(load_config(PRESET))
    a = conf["audionet"]
    with pytest.raises(NotImplementedError):
        build_avnet(dict(conf, audionet=dict(a, batch_fold=2)), device="cpu")
    with pytest.raises(NotImplementedError):
        build_avnet(dict(conf, audionet=dict(a, compute_dtype="float16")),
                    device="cpu")
    small = json.loads(json.dumps(conf))
    small["audionet"]["audio_params"]["repeats"] = 1
    small["audionet"]["video_params"]["repeats"] = 1
    uni = json.loads(json.dumps(small))
    for layer in ("layer_1", "layer_2"):
        uni["audionet"]["audio_params"]["layers"][layer]["bidirectional"] = False
    uni_model = build_avnet(uni, device="cpu")
    srus = [m for m in uni_model.modules() if isinstance(m, SRU)]
    assert srus and not any(m.uses_fused_stack for m in srus)
    assert {p.dtype for p in uni_model.parameters()} == {torch.bfloat16}
    model = build_avnet(small, device="cpu")
    AVSystem(model)
    model.packed_tf = True
    AVSystem(model)
    packed = build_avnet(dict(small, audionet=dict(small["audionet"],
                                                   packed_tf=True)),
                         device="cpu")
    assert packed.packed_tf
    AVSystem(uni_model)
    for m in (model, packed, uni_model):
        with torch.no_grad():
            out = m(torch.full((1, 3968), 0.1), torch.zeros(1, 8, 512))
        assert out.dtype == torch.float32 and out.shape == (1, 1, 3968)
        assert torch.isfinite(out).all()
    small_packed = dict(small, audionet=dict(small["audionet"],
                                              packed_tf=True))
    for trainable in (small_packed, uni):
        assert train_main.build_system(trainable, "cpu").model.compute_dtype \
            == torch.bfloat16
    with pytest.raises(NotImplementedError):
        train_main.main(dict(small_packed, audionet=dict(
            small_packed["audionet"], batch_fold=2),
            log={"path": "/nonexistent/never", "exp_name": "x"}), "cpu")


@pytest.mark.parametrize("packed", [False, True])
def test_bf16_bundle_serves_through_the_inference_entry(tmp_path, packed):
    """A run whose conf.json says bfloat16 (and packed_tf, in the packed
    case) and whose best_model.pt holds float32 weights: the serving entry
    builds the bf16 model, rounds the weights once at load, and gives what
    the same model gives by hand; waveforms in and out are float32."""
    conf = load_config(PRESET)
    conf["audionet"]["audio_params"]["repeats"] = 1
    conf["audionet"]["video_params"]["repeats"] = 1
    model32 = build_avnet(conf, device="cpu", seed=1)
    video = build_video_model(conf, device="cpu", seed=1)
    export_model(str(tmp_path / "best_model.pt"), conf["audionet"],
                 model32.state_dict(), video.state_dict())
    conf16 = _bf16_conf(conf)
    conf16["audionet"]["packed_tf"] = packed
    with open(tmp_path / "conf.json", "w") as f:
        json.dump(conf16, f)
    rng = np.random.default_rng(5)
    write_wav(str(tmp_path / "mix.wav"),
              (rng.standard_normal(16000) * 0.1).astype(np.float32), 16000)
    frames = rng.integers(0, 256, (25, 96, 96)).astype(np.uint8)
    np.savez(tmp_path / "mouth.npz", data=frames)
    est = inference.main(["--conf-dir", str(tmp_path / "conf.json"),
                          "--wav", str(tmp_path / "mix.wav"),
                          "--mouth", str(tmp_path / "mouth.npz"),
                          "--out-dir", str(tmp_path / "out"), "--cpu"])
    model16 = build_avnet(conf16, device="cpu")
    model16.load_state_dict(model32.state_dict())
    assert next(model16.parameters()).dtype == torch.bfloat16
    assert model16.packed_tf == packed
    mouth = preprocess_mouth(frames, train=False)
    with torch.inference_mode():
        emb = video(torch.from_numpy(mouth[None]))[0]
    want = separate_sample(model16, read_wav(str(tmp_path / "mix.wav")), emb)
    assert est.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(est, want)
