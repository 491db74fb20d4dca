"""The port's evaluation entry, ``python -m rtfs_tpu_torch.test``, against
the JAX package's ``test.py`` on one bundle, and the train entry on files.

Both entries on one bundle: the preset with repeats cut to 2 (audio) and 1
(video), published widths, its variables drawn from a seed with numpy
(their shapes from ``jax.eval_shape``: BatchNorm variances in [0.5, 1.5],
weights N(0, 1 / fan-in)), exported as a JAX bundle and, crossed into the
port by ``load_jax_params``, as the port's. The test set is three
mixtures of 7168, 6656 and 7168 samples (0.45 / 0.42 s, long enough for
STOI's 30 frames) with 8-frame mouths: six samples after n_src-1
doubling. ``rtfs_tpu_torch.test.main --cpu`` gives the JAX ``test.py``'s
rows at bs 1, bs 2 and bs 3 (whose first batch pads the 6656-sample
utterance to 7168 and must trim it back): si-snr, si-snr_i, sdr and
sdr_i to 1e-2 dB, stoi to 1e-3, pesq to 2e-2 (measured maxima, float32
through ~100 layers in another order: 1.9e-5 dB, 1.5e-7 and 1.1e-7). Its
example wavs equal JAX's (the mixture and sources exactly, the estimates
to 1e-3 of max), and ``--packed-tf`` gives the standard rows to the same
limits.

Train, then score, on files: ``rtfs_tpu_torch.train.main --device cpu``
trains the micro AVNet of ``tests/test_train.py`` (with the real lip
backbone) for one epoch from the files of a train and a validation split
(no ``--data.synthetic``), writes a checkpoint, ``conf.json`` with the
code version and ``best_model.pt``; the evaluation entry then scores that
bundle.

About 100 s alone, one torch thread: the JAX entry's three runs (five
compilations of its forward, ~9 s each) take ~65 s of it.
"""

import copy
import csv
import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

import jax

from rtfs_tpu.config import build_avnet as jax_build_avnet
from rtfs_tpu.config import load_config as jax_load_config
from rtfs_tpu.models.video import make_video_model
from rtfs_tpu.train.checkpoints import export_model as jax_export_model
from rtfs_tpu_torch import test as eval_entry
from rtfs_tpu_torch.config import build_avnet, build_video_model
from rtfs_tpu_torch.data.wav import read_wav
from rtfs_tpu_torch.train import main as train_main
from rtfs_tpu_torch.train.checkpoints import (CheckpointManager, export_model,
                                              load_exported)
from rtfs_tpu_torch.utils.weights import load_jax_params
from test_torch_dataset import write_corpus
from test_train import MICRO_AUDIONET

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "lrs2_RTFSNet_4_layer"
LENGTHS = (7168, 6656, 7168)
FRAMES = 8
EXAMPLES = 2
# row limits of the two entries on one bundle
LIMITS = {"sdr": 1e-2, "sdr_i": 1e-2, "si-snr": 1e-2, "si-snr_i": 1e-2,
          "stoi": 1e-3, "pesq": 2e-2}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module, restored after it: the suite's
    workers share the machine's cores, and the port's CPU forwards run
    the kernels' plain versions (many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_variables(init, rng, *shapes):
    """The variables ``init`` makes, their shapes from ``jax.eval_shape``
    (no compilation), their values drawn from ``rng``."""
    struct = jax.eval_shape(init, jax.random.PRNGKey(0), *[
        jax.ShapeDtypeStruct(s, np.float32) for s in shapes])

    def draw(path, leaf):
        name, shape = str(getattr(path[-1], "key", "")), leaf.shape
        if name == "var":
            x = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            x = 0.1 * rng.standard_normal(shape)
        elif "scale" in name:
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "alpha" or name.endswith("prelu"):
            x = 0.25 + 0.05 * rng.standard_normal(shape)
        elif "bias" in name or len(shape) < 2:
            x = 0.05 * rng.standard_normal(shape)
        else:
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(draw, struct)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The corpus, and one run directory a package (conf.json and the
    bundle of the same weights): ``jax/best_model.bin``,
    ``port/best_model.pt``."""
    root = tmp_path_factory.mktemp("eval")
    for split, seed in (("tt", 0), ("tr", 1), ("cv", 2)):
        write_corpus(root / split, LENGTHS, frames=FRAMES, seed=seed)
    conf = jax_load_config(PRESET)
    conf["audionet"]["audio_params"]["repeats"] = 2
    conf["audionet"]["video_params"]["repeats"] = 1
    rng = np.random.default_rng(0)
    video = _seeded_variables(make_video_model(conf["videonet"]).init, rng,
                              (1, FRAMES, 88, 88))
    model = jax_build_avnet(conf)
    audio = _seeded_variables(
        lambda key, *x: model.init({"params": key}, *x), rng,
        (1, LENGTHS[0]), (1, FRAMES, 512))
    for name in ("jax", "port"):
        os.makedirs(root / name)
        with open(root / name / "conf.json", "w") as f:
            json.dump(conf, f)
    jax_export_model(str(root / "jax" / "best_model.bin"), conf["audionet"],
                     audio["params"], audio["batch_stats"], video)
    port = load_jax_params(build_avnet(conf, device="cpu"), audio)
    port_video = load_jax_params(build_video_model(conf, device="cpu"), video)
    export_model(str(root / "port" / "best_model.pt"), conf["audionet"],
                 port.state_dict(), port_video.state_dict())
    return root


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _examples(run_dir):
    d = os.path.join(run_dir, "results", "examples")
    return {n: read_wav(os.path.join(d, n)) for n in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def jax_results(runs):
    """The JAX ``test.py`` at bs 1, 2 and 3: {bs: (metrics.csv rows,
    results.csv rows, example wavs)}."""
    spec = importlib.util.spec_from_file_location("jax_test_entry",
                                                  os.path.join(ROOT,
                                                               "test.py"))
    entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(entry)
    out = {}
    for bs in (1, 2, 3):
        entry.main(types.SimpleNamespace(
            conf_dir=str(runs / "jax" / "conf.json"),
            test_dir=str(runs / "tt"), model=None, batch_size=bs,
            save_examples=EXAMPLES, cpu=True))
        results = runs / "jax" / "results"
        out[bs] = (_read_csv(results / "metrics.csv"),
                   _read_csv(results / "results.csv"),
                   _examples(runs / "jax"))
    return out


def _port_test(runs, *extra):
    return eval_entry.main(["--conf-dir", str(runs / "port" / "conf.json"),
                            "--test-dir", str(runs / "tt"), *extra])


def _assert_rows_agree(got, want, label):
    """Per-utterance rows (the port's, as returned) against the JAX CSV's;
    returns the largest difference a column."""
    assert [r["snt_id"] for r in got] == [r["snt_id"] for r in want[:-3]]
    worst = dict.fromkeys(LIMITS, 0.0)
    for g, w in zip(got, want):
        for k, lim in LIMITS.items():
            assert np.isfinite(g[k]), (label, k, g)
            d = abs(g[k] - float(w[k]))
            worst[k] = max(worst[k], d)
            assert d <= lim, (label, k, g, w)
    print(f"{label}: largest difference {worst}")
    return worst


@pytest.mark.parametrize("bs", [1, 2, 3])
def test_eval_entry_gives_the_jax_rows(runs, jax_results, bs):
    want, want_results, want_examples = jax_results[bs]
    out = _port_test(runs, "--cpu", "--batch-size", str(bs),
                     "--save-examples", str(EXAMPLES))
    assert out["utterances"] == 2 * len(LENGTHS)
    _assert_rows_agree(out["rows"], want, f"bs {bs}")
    results = runs / "port" / "results"
    # metrics.csv: the same rows, then avg / std / backend as JAX's
    got = _read_csv(results / "metrics.csv")
    assert [r["snt_id"] for r in got] == [r["snt_id"] for r in want]
    assert got[-1] == want[-1]  # the backends' row
    # results.csv: mean and std a metric and the two backends
    got_results = _read_csv(results / "results.csv")
    assert [r["metric"] for r in got_results] == [
        r["metric"] for r in want_results]
    for g, w in zip(got_results, want_results):
        if g["metric"].endswith("_backend"):
            assert g == w
        else:
            assert abs(float(g["mean"]) - float(w["mean"])) <= LIMITS[
                g["metric"]]
            assert float(g["mean"]) == pytest.approx(out["mean"][g["metric"]])
    # the example wavs
    got_examples = _examples(runs / "port")
    assert got_examples.keys() == want_examples.keys()
    assert len(got_examples) == EXAMPLES * 3
    for name, wav in want_examples.items():
        if "_est" in name:
            np.testing.assert_allclose(got_examples[name], wav, rtol=0,
                                       atol=1e-3 * np.abs(wav).max())
        else:
            np.testing.assert_array_equal(got_examples[name], wav)


def test_eval_entry_packed_gives_the_standard_rows(runs, jax_results):
    out = _port_test(runs, "--cpu", "--packed-tf", "--batch-size", "2")
    _assert_rows_agree(out["rows"], jax_results[2][0], "packed bs 2")


def test_eval_entry_without_cuda_raises(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _port_test(runs)


def test_train_from_files_then_score(runs):
    """One epoch of the micro AVNet from the tr / cv files (segment 0.25 s,
    bs 2: 6 samples, 3 steps), then the evaluation entry on the exported
    bundle."""
    a = copy.deepcopy(MICRO_AUDIONET)
    a["pretrained_vout_chan"] = 512
    conf = {
        "audionet": a,
        "videonet": {"model_name": "FRCNNVideoModel",
                     "backbone_type": "resnet", "relu_type": "prelu",
                     "pretrain": None},
        "training": {"epochs": 1, "batch_size": 2, "num_workers": 2,
                     "half_lr": True, "early_stop": True,
                     "divide_lr_by": None, "online_mix": False},
        "optim": {"optimizer": "adamw", "lr": 0.001, "weight_decay": 0.1},
        "sche": {"patience": 2, "factor": 0.5},
        "data": {"train_dir": "unset", "valid_dir": "unset",
                 "sample_rate": 16000, "segment": 0.25,
                 "normalize_audio": False},
        "log": {"path": str(runs / "train"), "exp_name": "micro"},
    }
    path = runs / "micro.json"
    with open(path, "w") as f:
        json.dump(conf, f)
    row = train_main.cli(["--conf-dir", str(path), "--device", "cpu",
                          "--data.train_dir", str(runs / "tr"),
                          "--data.valid_dir", str(runs / "cv")])
    assert row["epoch"] == 0 and row["steps"] == 3
    assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_loss"])
    assert 0 <= row["loader_first_wait"] <= row["loader_wait"] <= row[
        "train_secs"]
    exp = runs / "train" / "micro"
    assert CheckpointManager(str(exp)).restore()["step"] == 3
    with open(exp / "conf.json") as f:
        written = json.load(f)
    assert written["code_version"].keys() >= {"git_sha"}
    assert written["data"]["train_dir"] == str(runs / "tr")
    bundle = load_exported(str(exp / "best_model.pt"))
    assert bundle["infos"]["code_version"] == written["code_version"]

    out = eval_entry.main(["--conf-dir", str(exp / "conf.json"),
                           "--test-dir", str(runs / "tt"), "--cpu",
                           "--batch-size", "2"])
    assert len(out["rows"]) == out["utterances"] == 2 * len(LENGTHS)
    for r in out["rows"]:
        assert all(np.isfinite(r[k]) for k in LIMITS), r
    assert (exp / "results" / "results.csv").exists()


def test_chip_smoke_file_phase_helpers(jax_results):
    """Phase 11's pure helpers: the launches it expects of the train and
    evaluation entries, and its row comparison (on the JAX entry's rows)."""
    import chip_smoke

    per_step, per_fwd = chip_smoke.TRAIN_LAUNCHES, chip_smoke.SERVE_LAUNCHES
    assert per_fwd == {"sru_dual_recurrence_fwd": 8,
                       "sru_hidden_layer_fwd": 24, "convt1d_ola_tm_fwd": 8}
    got = chip_smoke.file_launches(4, 1)
    assert got == {k: 4 * v + per_fwd.get(k, 0) for k, v in per_step.items()}
    assert got["sru_hidden_layer_bwd"] == 96 and got["convt1d_ola_tm_fwd"] == 40
    assert chip_smoke.file_launches(0, 2) == {k: 2 * v
                                              for k, v in per_fwd.items()}
    assert chip_smoke.file_launches(0, 0) == {}

    rows = [{k: (v if k == "snt_id" else float(v)) for k, v in r.items()}
            for r in jax_results[1][0][:-3]]
    worst = chip_smoke.compare_rows(rows, rows, "same")
    assert worst == dict.fromkeys(chip_smoke.EVAL_ROW_TOL, 0.0)
    for k, tol in chip_smoke.EVAL_ROW_TOL.items():
        near = [dict(r) for r in rows]
        near[1][k] += 0.5 * tol
        assert chip_smoke.compare_rows(near, rows, "near")[k] > 0
        for bad in (2 * tol, float("nan")):
            far = [dict(r) for r in rows]
            far[1][k] = bad if bad != bad else far[1][k] + bad
            with pytest.raises(AssertionError, match=k):
                chip_smoke.compare_rows(far, rows, "far")
    with pytest.raises(AssertionError, match="other utterances"):
        chip_smoke.compare_rows(rows[::-1], rows, "order")


def test_chip_smoke_shortens_a_mixture(tmp_path):
    """Phase 11's ``shorten_mixture``: the mixture's wavs keep their first
    samples bit for bit, its mouths the frames that cover them, the
    manifests its new length; the other mixtures stay; and a bs-3 test
    batch pads the short samples and carries their length."""
    import chip_smoke
    from rtfs_tpu_torch.data import AVSpeechDataset

    split = write_corpus(tmp_path / "tt", (3200, 3200, 3200), frames=FRAMES)
    before = AVSpeechDataset(split, segment=None)
    items = [before[i] for i in range(len(before))]
    key = chip_smoke.shorten_mixture(split, 1, 1600)
    after = AVSpeechDataset(split, segment=None)
    assert key == after[2][-1] == after[3][-1]
    for i, (mix, src, mouths, k) in enumerate(items):
        got = after[i]
        n = 1600 if i in (2, 3) else 3200
        np.testing.assert_array_equal(got[0], mix[:n])
        np.testing.assert_array_equal(got[1], src[..., :n])
        np.testing.assert_array_equal(got[2], mouths[:, :3 if n == 1600
                                                      else FRAMES])
        assert got[3] == k
    for name in ("mix", "s1", "s2"):
        with open(os.path.join(split, f"{name}.json")) as f:
            assert [e[-1] for e in json.load(f)] == [3200, 1600, 3200]
    batch = next(iter(after.batches(3, shuffle=False, drop_last=False)))
    assert list(batch["length"]) == [3200, 3200, 1600]
    assert batch["mix"].shape == (3, 3200)
    assert not batch["mix"][2, 1600:].any()
