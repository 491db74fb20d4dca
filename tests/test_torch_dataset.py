"""The port's file data path against rtfs_tpu.data, bit for bit.

On a micro LRS2-layout corpus that the test writes (``{mix,s1,s2}/*.wav``
under each split, ``mouths/*.npz``, the manifests): five mixtures, one of
them shorter than the train segment (train mode drops it) and one longer
than 2 s (both modes cut it to 2 s), three written as float32 and two as
int16 PCM. The port's ``read_wav`` gives the JAX dataset's samples (its
native decoder where ``native/libwavio.so`` is built); the port's
``AVSpeechDataset`` items, ``batch_index_plan``, ``sample_rng`` draws and
batches equal ``rtfs_tpu.data.AVSpeechDataset``'s for n_src 1 and 2, train
and test mode, ``normalize_audio``, ``audio_only`` and the
``mix_clean.json`` fallback; the port's ``PrefetchLoader`` gives the same
batches as JAX's and as the synchronous path, surfaces a decode error and
stops on an early ``break``; its ``preprocess_dataset`` writes JAX's
manifests. About 5 s alone (one torch thread).
"""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from rtfs_tpu.data import AVSpeechDataset as JAVSpeechDataset
from rtfs_tpu.data import PrefetchLoader as JPrefetchLoader
from rtfs_tpu.data import manifests as jmanifests
from rtfs_tpu_torch.data import (AVSpeechDataset, PrefetchLoader,
                                 SyntheticAVDataset, normalize_wav,
                                 pin_and_copy)
from rtfs_tpu_torch.data import manifests
from rtfs_tpu_torch.data.loader import WaitTimer
from rtfs_tpu_torch.data.wav import read_wav

SR = 16000
# samples a mixture: the third is shorter than SEGMENT, the fourth longer
# than the 2 s cap
LENGTHS = (4800, 4352, 2000, 33000, 4608)
INT16 = (1, 3)  # written as int16 PCM, the others as float32
SEGMENT = 0.25  # 4000 samples
FRAMES = 5


def write_corpus(root, lengths, frames=FRAMES, int16=(), seed=0,
                 mix_name="mix"):
    """An LRS2-layout split under ``root``: ``{mix,s1,s2}/<stem>.wav``
    (float32, or int16 PCM for the indices in ``int16``), the speakers'
    mouth crops ``mouths/<spk>.npz`` (uint8 (frames, 96, 96), named as
    the LRS2 manifest builder resolves them) and the manifests
    ``{mix_name,s1,s2}.json``. Returns ``root``."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    entries = {mix_name: [], "s1": [], "s2": []}
    os.makedirs(os.path.join(root, "mouths"), exist_ok=True)
    for i, n in enumerate(lengths):
        s1 = (rng.standard_normal(n) * 0.1).astype(np.float32)
        s2 = (rng.standard_normal(n) * 0.1).astype(np.float32)
        spks = (f"spkA{i}_0000{i}", f"spkB{i}_1111{i}")
        stem = f"{spks[0]}_-3_{spks[1]}_3"
        for name, sig in ((mix_name, s1 + s2), ("s1", s1), ("s2", s2)):
            os.makedirs(os.path.join(root, name), exist_ok=True)
            path = os.path.join(root, name, stem + ".wav")
            data = (np.round(np.clip(sig, -1, 1) * 32767).astype(np.int16)
                    if i in int16 else sig)
            wavfile.write(path, SR, data)
            if name == mix_name:
                entries[name].append((path, n))
            else:
                mouth = os.path.join(root, "mouths",
                                     spks[name == "s2"] + ".npz")
                np.savez(mouth, data=rng.integers(0, 256, (frames, 96, 96),
                                                  dtype=np.uint8))
                entries[name].append((path, mouth, n))
    for name, info in entries.items():
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(info, f)
    return str(root)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module, restored after it (the suite's
    workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus"), LENGTHS,
                        int16=INT16)


@pytest.fixture(scope="module")
def wham(tmp_path_factory):
    """A split whose mixture manifest is ``mix_clean.json``."""
    return write_corpus(tmp_path_factory.mktemp("wham"), LENGTHS[:2],
                        seed=1, mix_name="mix_clean")


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert g == w
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "key":
                assert g[k] == w[k]
            else:
                gk = g[k].numpy() if torch.is_tensor(g[k]) else g[k]
                assert gk.dtype == w[k].dtype, k
                np.testing.assert_array_equal(gk, w[k], err_msg=k)


def test_read_wav_equals_the_jax_dataset_reader(corpus):
    """float32 and int16 files, whole and cut: the port's scipy reader and
    the JAX dataset's (native where built) give the same samples."""
    jds = JAVSpeechDataset(corpus, segment=None)
    paths = [info[0] for info in jds.mix[::2]]  # n_src 1: each one twice
    for i, path in enumerate(paths + [s[0] for s in jds.sources]):
        for stop in (None, 4000, 40000):
            got, want = read_wav(path, stop), jds._read_wav(path, stop)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=f"{i} {stop}")
    assert read_wav(paths[INT16[0]]).shape == (LENGTHS[INT16[0]],)


CASES = [  # n_src, segment, normalize_audio, audio_only
    (1, SEGMENT, False, False),
    (1, None, False, False),
    (2, SEGMENT, False, False),
    (2, None, True, False),
    (1, SEGMENT, True, True),
    (1, None, False, True),
]


@pytest.mark.parametrize("n_src,segment,normalize,audio_only", CASES)
def test_items_equal_jax(corpus, n_src, segment, normalize, audio_only):
    kw = dict(n_src=n_src, segment=segment, normalize_audio=normalize,
              audio_only=audio_only)
    ds, jds = AVSpeechDataset(corpus, **kw), JAVSpeechDataset(corpus, **kw)
    assert ds.mix == jds.mix and ds.sources == jds.sources
    kept = len(LENGTHS) - (segment is not None)  # the short one dropped
    assert len(ds) == len(jds) == kept * (2 if n_src == 1 else 1)
    for idx in range(len(ds)):
        _assert_items_equal(ds[idx], jds[idx])
        # train-mode crops and flips drawn from equal generator states
        _assert_items_equal(ds.__getitem__(idx, ds.sample_rng(idx, 3, 1)),
                            jds.__getitem__(idx, jds.sample_rng(idx, 3, 1)))
    mix = ds[0][0]
    cap = 2 * SR if segment is None else int(segment * SR)
    assert mix.shape[-1] <= cap
    if segment is None:  # the long utterance is cut to 2 s
        assert max(ds[i][0].shape[-1] for i in range(len(ds))) == 2 * SR


def test_mix_clean_fallback(wham):
    ds = AVSpeechDataset(wham, segment=SEGMENT)
    jds = JAVSpeechDataset(wham, segment=SEGMENT)
    assert ds.mix == jds.mix and len(ds) == 4
    for idx in range(len(ds)):
        _assert_items_equal(ds[idx], jds[idx])


def test_normalize_wav_equals_jax():
    from rtfs_tpu.data import normalize_wav as jnormalize_wav

    x = np.random.default_rng(0).standard_normal((2, 300)).astype(np.float32)
    np.testing.assert_array_equal(normalize_wav(x), jnormalize_wav(x))
    std = x[:1].std(-1, keepdims=True)
    np.testing.assert_array_equal(normalize_wav(x, std),
                                  jnormalize_wav(x, std))


@pytest.mark.parametrize("batch_size", [1, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_index_plan_and_sample_rng_equal_jax(corpus, batch_size,
                                                   drop_last):
    ds = AVSpeechDataset(corpus, segment=SEGMENT)
    jds = JAVSpeechDataset(corpus, segment=SEGMENT)
    for seed in (0, 7):
        for epoch in (0, 1, 5):
            for shuffle in (True, False):
                for host_id, num_hosts in ((0, 1), (0, 2), (1, 2), (2, 3)):
                    kw = dict(shuffle=shuffle, seed=seed, epoch=epoch,
                              host_id=host_id, num_hosts=num_hosts,
                              drop_last=drop_last)
                    got = ds.batch_index_plan(batch_size, **kw)
                    want = jds.batch_index_plan(batch_size, **kw)
                    assert len(got) == len(want)
                    for g, w in zip(got, want):
                        np.testing.assert_array_equal(g, w)
            for idx in range(len(ds)):
                np.testing.assert_array_equal(
                    ds.sample_rng(idx, seed, 2).random(4),
                    jds.sample_rng(idx, seed, 2).random(4))


@pytest.mark.parametrize("n_src,segment,normalize,audio_only", CASES)
def test_batches_equal_jax(corpus, n_src, segment, normalize, audio_only):
    kw = dict(n_src=n_src, segment=segment, normalize_audio=normalize,
              audio_only=audio_only)
    ds, jds = AVSpeechDataset(corpus, **kw), JAVSpeechDataset(corpus, **kw)
    plan = dict(seed=3, epoch=1, drop_last=segment is not None,
                shuffle=segment is not None)
    got = list(ds.batches(3, **plan))
    _assert_batches_equal(got, jds.batches(3, **plan))
    if segment is None:  # test mode: padded to the batch max, with lengths
        assert all("length" in b for b in got)
        lengths = np.concatenate([b["length"] for b in got])
        assert len(set(lengths.tolist())) > 1
        for b in got:
            assert b["mix"].shape[-1] == b["length"].max()
            for i, n in enumerate(b["length"]):
                assert not b["mix"][i, n:].any()


@pytest.mark.parametrize("n_src,segment", [(1, SEGMENT), (2, None)])
def test_prefetch_loader_equals_jax_and_the_sync_path(corpus, n_src,
                                                      segment):
    kw = dict(n_src=n_src, segment=segment)
    ds, jds = AVSpeechDataset(corpus, **kw), JAVSpeechDataset(corpus, **kw)
    plan = dict(seed=5, epoch=2, shuffle=segment is not None,
                drop_last=False)
    for workers, lookahead in ((1, 1), (3, 2)):
        got = list(PrefetchLoader(ds, 2, num_workers=workers,
                                  lookahead=lookahead).epoch(**plan))
        _assert_batches_equal(got, ds.batches(2, **plan))
        _assert_batches_equal(got, JPrefetchLoader(
            jds, 2, num_workers=workers, lookahead=lookahead).epoch(**plan))


def test_prefetch_loader_places_one_ahead_and_carries_the_key(corpus):
    ds = AVSpeechDataset(corpus, segment=SEGMENT)
    placed = []

    def place(batch):
        assert "key" not in batch
        placed.append(batch["mix"].shape)
        return pin_and_copy("cpu")(batch)

    it = PrefetchLoader(ds, 2, num_workers=2, place=place).epoch(seed=1)
    first = next(it)
    # the second batch was placed before the first was handed over
    assert len(placed) == 2
    assert torch.is_tensor(first["mix"]) and isinstance(first["key"], list)
    rest = list(it)
    _assert_batches_equal([first, *rest], ds.batches(2, seed=1))


def test_prefetch_loader_surfaces_a_decode_error(corpus):
    ds = AVSpeechDataset(corpus, segment=SEGMENT)
    ds.mix = [(p + ".missing", n) for p, n in ds.mix]
    with pytest.raises(FileNotFoundError):
        list(PrefetchLoader(ds, 2, num_workers=2).epoch(shuffle=False))


def test_prefetch_loader_stops_on_an_early_break(corpus):
    ds = AVSpeechDataset(corpus, segment=SEGMENT)
    before = threading.active_count()
    for batch in PrefetchLoader(ds, 1, num_workers=2,
                                lookahead=1).epoch(shuffle=False):
        break
    del batch
    # the generator's close joined the producer and shut the pool down
    for _ in range(100):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


def test_synthetic_set_passes_through():
    ds = SyntheticAVDataset(n_samples=4, segment=0.01, video_frames=2,
                            mouth_size=8)
    got = list(PrefetchLoader(ds, 2, place=pin_and_copy("cpu")).epoch(
        seed=2, epoch=1))
    _assert_batches_equal(got, ds.batches(2, seed=2, epoch=1))


def test_wait_timer_sums_the_blocked_time():
    def slow():
        for x in "abc":
            threading.Event().wait(0.02)  # blocked 20 ms a batch
            yield x

    timer = WaitTimer(slow())
    t0 = time.perf_counter()
    assert list(timer) == ["a", "b", "c"]
    assert timer.count == 3
    assert 0.06 <= timer.wait <= time.perf_counter() - t0
    assert 0.02 <= timer.first <= timer.wait - 0.04


def test_preprocess_dataset_writes_the_jax_manifests(tmp_path, corpus,
                                                     monkeypatch):
    """The port's CLI and JAX's ``preprocess_dataset`` on the same wavs."""
    src = tmp_path / "wavs"
    for split in ("tr", "cv", "tt"):
        for spk in ("mix", "s1", "s2"):
            shutil.copytree(os.path.join(corpus, spk), src / split / spk)
    mouths = os.path.join(corpus, "mouths")
    monkeypatch.setattr("sys.argv", [
        "manifests", "--in-audio-dir", str(src), "--in-mouth-dir", mouths,
        "--out-dir", str(tmp_path / "port")])
    manifests.main()
    jmanifests.preprocess_dataset(str(src), str(tmp_path / "jax"), "lrs2",
                                  mouths)
    for split in ("tr", "cv", "tt"):
        for spk in ("mix", "s1", "s2"):
            with open(tmp_path / "port" / split / f"{spk}.json") as f:
                got = json.load(f)
            with open(tmp_path / "jax" / split / f"{spk}.json") as f:
                assert got == json.load(f)
            assert [e[-1] for e in got] == list(LENGTHS)
    # the manifests drive the dataset: each s1 entry names its mouth file
    ds = AVSpeechDataset(str(tmp_path / "port" / "tr"), segment=SEGMENT)
    assert all(os.path.exists(s[1]) for s in ds.sources)
