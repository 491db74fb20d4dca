"""The port's serving entry, ``python -m rtfs_tpu_torch.inference``, on the
CPU.

Its data helpers equal ``rtfs_tpu``'s exactly; the entry, on a micro bundle
(audio repeats 2, video repeats 1, published widths, 8 mouth frames, 3968
samples), writes the wavs that the same weights give through the lip
backbone and ``separate_sample``, with and without ``--packed-tf``.
"""

import json
import os

import numpy as np
import pytest
import torch

from rtfs_tpu.data import transforms as jax_transforms
from rtfs_tpu.data.native_wav import read_wav as jax_read_wav
from rtfs_tpu_torch import inference
from rtfs_tpu_torch.config import build_avnet, build_video_model, load_config
from rtfs_tpu_torch.data.transforms import preprocess_mouth
from rtfs_tpu_torch.data.wav import read_wav, write_wav
from rtfs_tpu_torch.train.checkpoints import export_model
from rtfs_tpu_torch.utils.separator import separate_sample

PRESET = "lrs2_RTFSNet_4_layer"
SAMPLES = 3968
FRAMES = 8


def _mouth(rng, frames=FRAMES):
    return rng.integers(0, 256, (frames, 96, 96), dtype=np.uint8)


def test_preprocess_mouth_equals_jax():
    rng = np.random.default_rng(0)
    frames = _mouth(rng)
    np.testing.assert_array_equal(
        preprocess_mouth(frames, train=False),
        jax_transforms.preprocess_mouth(frames, train=False))
    # train: crops and flips drawn from the same generator states
    for seed in range(4):
        np.testing.assert_array_equal(
            preprocess_mouth(frames, True, np.random.default_rng(seed)),
            jax_transforms.preprocess_mouth(frames, True,
                                            np.random.default_rng(seed)))
    with pytest.raises(ValueError):
        preprocess_mouth(frames, train=True)


@pytest.mark.parametrize("dtype", ["float32", "int16", "int32"])
def test_read_wav_equals_jax(tmp_path, dtype):
    from scipy.io import wavfile

    rng = np.random.default_rng(1)
    wav = rng.uniform(-1, 1, 1000)
    if dtype == "float32":
        data = wav.astype(np.float32)
    else:
        data = (wav * np.iinfo(dtype).max).astype(dtype)
    path = str(tmp_path / "x.wav")
    wavfile.write(path, 16000, data)
    np.testing.assert_array_equal(read_wav(path), jax_read_wav(path))
    np.testing.assert_array_equal(read_wav(path, 10), jax_read_wav(path, 10))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A run directory: conf.json, best_model.pt (weights from seed 1),
    a wav and a mouth .npz."""
    root = tmp_path_factory.mktemp("run")
    conf = load_config(PRESET)
    conf["audionet"]["audio_params"]["repeats"] = 2
    conf["audionet"]["video_params"]["repeats"] = 1
    with open(root / "conf.json", "w") as f:
        json.dump(conf, f)
    model = build_avnet(conf, device="cpu", seed=1)
    video = build_video_model(conf, device="cpu", seed=1)
    export_model(str(root / "best_model.pt"), conf["audionet"],
                 model.state_dict(), video.state_dict())
    rng = np.random.default_rng(2)
    wav = (rng.standard_normal(SAMPLES) * 0.1).astype(np.float32)
    write_wav(str(root / "mix.wav"), wav, 16000)
    np.savez(root / "mouth.npz", data=_mouth(rng))
    # the same weights, by hand: lip backbone, then separate_sample
    mouth = preprocess_mouth(np.load(root / "mouth.npz")["data"], train=False)
    with torch.inference_mode():
        emb = video(torch.from_numpy(mouth[None]))[0]
    want = separate_sample(model, read_wav(str(root / "mix.wav")), emb)
    return root, want


def _run(root, out, *extra):
    return inference.main(["--conf-dir", str(root / "conf.json"),
                           "--wav", str(root / "mix.wav"),
                           "--mouth", str(root / "mouth.npz"),
                           "--out-dir", str(out), *extra])


@pytest.mark.parametrize("packed,rel", [(False, 1e-6), (True, 1e-5)])
def test_inference_entry_writes_the_separated_wavs(bundle, tmp_path, packed,
                                                   rel):
    root, want = bundle
    extra = ["--cpu"] + (["--packed-tf"] if packed else [])
    est = _run(root, tmp_path, *extra)
    assert est.shape == want.shape == (1, SAMPLES)
    path = tmp_path / "mix_est1.wav"
    assert os.path.exists(path)
    got = read_wav(str(path))
    scale = np.abs(want).max()
    # the written file is the estimate clipped to [-1, 1]
    np.testing.assert_allclose(got, np.clip(want[0], -1, 1), rtol=0,
                               atol=rel * scale)
    np.testing.assert_allclose(est, want, rtol=0, atol=rel * scale)


def test_inference_entry_without_cuda_raises(bundle, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root, _ = bundle
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(root, tmp_path)
