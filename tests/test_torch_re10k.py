"""The RealEstate10K slice of the port on the CPU against the JAX package:
`scenedino_torch.datasets.re10k` items on a seeded tree in the release's
layout (frames as PIL-written JPEGs under `frames_720/<split>/<seq>/<ms>.jpg`,
a pickle of per-sequence metadata), the factory branch, the preprocessing
CLI (`process`, `mine-split`, the download manifest), one stage-1 step on an
RE10K batch with the recipe's "alternate" split, and
`configs/train_scenedino_re10k.yaml` through `cli.train --device cpu`.

Tolerances: images within 1e-6 (the JPEG decode is bit for bit, the
INTER_AREA resize within float32 round-off of cv2's); poses, intrinsics
and indices bit for bit; the CLIs' outputs equal. The training step as
tests/test_torch_kitti360_cli.py holds it (the loss dict rtol 1e-5, each
gradient's relative L2 error <= 1e-3), the JAX step's draws rebuilt from
its key, its alternate coin `randint(k_split, (), 0, 3) > 0` (the even
frames give the loss) mapped to the port's `split_coin` (1: the odd ones).
"""
import dataclasses
import json
import logging
import os
import pickle
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.losses.reconstruction as jrec
import scenedino_tpu.training.trainer as jtrain
from scenedino_tpu.datasets import make_datasets as j_make_datasets
from scenedino_tpu.datasets.re10k import RealEstate10kDataset as JRealEstate10kDataset
from scenedino_torch.cli import process_re10k as pr
from scenedino_torch.cli import train as train_cli
from scenedino_torch.datasets import make_datasets, make_test_dataset
from scenedino_torch.datasets.re10k import RealEstate10kDataset, center_crop_to_aspect, process_proj
from scenedino_torch.losses import reconstruction as rec
from scenedino_torch.training import trainer
from scenedino_torch.utils import config as yaml_config
from tests.test_torch_training import (  # noqa: F401  (models: the shared module fixture)
    ART_SHAPE,
    H,
    N_COARSE,
    W,
    _configs,
    _grad_rel_err,
    _jax_draws,
    _port_state,
    _t,
    models,
)

PIL = pytest.importorskip("PIL.Image")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = (45, 80)  # a frame's (height, width): 16:9 as the release's
# rows of each sequence; the pickle also names a sequence without frames
SEQS = {"seqA": 45, "seqB": 40, "seqC": 12}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _pose(rng):
    a = rng.uniform(-0.2, 0.2, 3)
    cx, sx, cy, sy = np.cos(a[0]), np.sin(a[0]), np.cos(a[1]), np.sin(a[1])
    rot = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]) @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return np.concatenate([rot, rng.uniform(-1, 1, (3, 1))], 1)


def write_re10k_tree(root, split="train", seed=0):
    """A tree in the release's layout: per sequence microsecond timestamps
    (33.367 ms apart), pixel-normalized intrinsics, 3x4 world-to-camera
    poses, and a JPEG a row (PIL, quality 75, 4:2:0); seqGhost has metadata
    but no frames."""
    rng = np.random.default_rng(seed)
    data = {}
    for j, (name, n) in enumerate({**SEQS, "seqGhost": 20}.items()):
        ts = 1_000_000 * (j + 1) + np.arange(n, dtype=np.int64) * 33_367
        intr = np.tile([0.9, 1.6, 0.5, 0.5, 0.0, 0.0], (n, 1)) + rng.uniform(-0.02, 0.02, (n, 6))
        data[name] = {"timestamps": ts, "intrinsics": intr, "poses": np.stack([_pose(rng) for _ in range(n)])}
        if name == "seqGhost":
            continue
        frames = root / "frames_720" / split / name
        frames.mkdir(parents=True)
        y, x = np.mgrid[0:FRAME[0], 0:FRAME[1]]
        for i, t in enumerate(ts):
            img = np.stack([128 + 90 * np.sin(x / (4 + c) + y / (6 + c) + i / 5 + j) for c in range(3)], -1)
            img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)
            PIL.fromarray(img).save(frames / f"{int(t) // 1000}.jpg")
    with open(root / f"{split}.pickle", "wb") as f:
        pickle.dump(data, f)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_re10k_tree(tmp_path_factory.mktemp("re10k"))


def _pair(tree, **kw):
    kw = {"data_path": str(tree / "train.pickle"), **kw}
    return RealEstate10kDataset(**kw), JRealEstate10kDataset(**kw)


def _assert_items_equal(a, b):
    assert sorted(a) == sorted(b) == ["imgs", "index", "poses", "projs"]
    assert a["imgs"].dtype == b["imgs"].dtype and a["imgs"].shape == b["imgs"].shape
    assert np.abs(a["imgs"] - b["imgs"]).max() <= 1e-6
    for k in ("poses", "projs", "index"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# the resize regimes: 80x40 crops shrunk by 1.667 (overlap weights), by 2 (box) and enlarged (linear)
@pytest.mark.parametrize("size", [(24, 48), (20, 40), (48, 96), (36, 48)])
def test_window_items_match_jax(tree, size):
    """The full split: every 10th row, windows of 3 frames 2 apart, one a
    row but the last, sequences shorter than the window skipped, the last
    windows clamped at the sequence's end."""
    ours, ref = _pair(tree, image_size=size, frame_count=3, dilation=2)
    assert ours._datapoints == ref._datapoints == [("seqA", i) for i in range(4)] + [("seqB", i) for i in range(3)]
    for index in range(len(ref)):
        _assert_items_equal(ours[index], ref[index])
    last = ours[3]  # rows 3, 5 -> 4, 7 -> 4 of seqA's subsampled 5
    np.testing.assert_array_equal(last["poses"][1], last["poses"][2])
    assert ours[0]["imgs"].shape == (3, 3, *size)


def test_split_file_pairs_match_jax(tree, tmp_path):
    """A split file's `seq t0 t1` lines (milliseconds or microseconds) name
    exact frame pairs; no subsample; unknown sequences dropped."""
    ts = pickle.load(open(tree / "train.pickle", "rb"))["seqB"]["timestamps"]
    lines = [f"seqB {ts[3] // 1000} {ts[17] // 1000}", f"seqB {ts[30]} {ts[2]}", "seqGhost 1 2", "",
             f"seqA {1_000_000 // 1000} {(1_000_000 + 44 * 33_367) // 1000}"]
    split = tmp_path / "pairs.txt"
    split.write_text("\n".join(lines))
    ours, ref = _pair(tree, split_path=str(split), image_size=(24, 48))
    assert ours._datapoints == ref._datapoints == [("seqB", (3, 17)), ("seqB", (30, 2)), ("seqA", (0, 44))]
    for index in range(len(ref)):
        _assert_items_equal(ours[index], ref[index])
    assert ours[0]["imgs"].shape == (2, 3, 24, 48)


def test_crop_and_intrinsics_match_jax():
    from scenedino_tpu.datasets import re10k as jre

    rng = np.random.default_rng(0)
    for shape, aspect in (((45, 80), 2.0), ((45, 80), 1.5), ((360, 640), 512 / 288), ((37, 65), 0.5)):
        img = rng.random(shape + (3,)).astype(np.float32)
        a, crop = center_crop_to_aspect(img, aspect)
        b, jcrop = jre.center_crop_to_aspect(img, aspect)
        assert crop == jcrop
        np.testing.assert_array_equal(a, b)
        K = np.array([[0.9, 0, 0.51], [0, 1.6, 0.49], [0, 0, 1]], np.float32)
        np.testing.assert_array_equal(process_proj(K, shape, crop), jre.process_proj(K, shape, crop))


def test_factory_builds_the_re10k_instances(tree, tmp_path):
    """A split directory: train_files.txt where present (else the full
    windows), val_files.txt for the test instance; no split: the training
    set is the test instance; make_test_dataset takes make_datasets' test
    instance. Each as JAX's factory builds it."""
    ts = pickle.load(open(tree / "train.pickle", "rb"))["seqA"]["timestamps"]
    splits = tmp_path / "splits"
    splits.mkdir()
    (splits / "val_files.txt").write_text(f"seqA {ts[1]} {ts[6]}\nseqA {ts[2]} {ts[9]}")
    config = {"type": "RealEstate10k", "data_path": str(tree / "train.pickle"), "image_size": [24, 48],
              "data_fc": 3, "dilation": 2}
    for conf in (config, {**config, "split_path": str(splits)}):
        for kind in ("RealEstate10k", "RealEstate10K", "re10k"):
            conf = {**conf, "type": kind}
            (train, test), (jtrain_ds, jtest_ds) = make_datasets(conf), j_make_datasets(conf)
            assert isinstance(train, RealEstate10kDataset) and train.split_path is None
            assert train._datapoints == jtrain_ds._datapoints and test._datapoints == jtest_ds._datapoints
            assert (test is train) == (jtest_ds is jtrain_ds) == ("split_path" not in conf)
            assert make_test_dataset(conf)._datapoints == test._datapoints
    (splits / "train_files.txt").write_text(f"seqGhost {ts[0]} {ts[1]}\nseqA {ts[0]} {ts[3]}")
    train, test = make_datasets({**config, "split_path": str(splits)})
    assert train.split_path.endswith("train_files.txt") and test.split_path.endswith("val_files.txt")
    assert train._datapoints == [("seqA", (0, 3))] and len(test) == 2
    _assert_items_equal(test[1], j_make_datasets({**config, "split_path": str(splits)})[1][1])


def test_shipped_mine_split_raises_in_both_packages(tree):
    """A known divergence, kept: the repository's
    datasets/realestate10k/splits/mine/*_files.txt (and mine-split's output)
    hold `<seq> <row>` lines, the loader reads `<seq> <t0> <t1>`; both
    packages raise IndexError on them."""
    path = os.path.join(ROOT, "datasets", "realestate10k", "splits", "mine", "val_files.txt")
    assert all(len(line.split()) == 2 for line in open(path) if line.strip())
    for cls in (RealEstate10kDataset, JRealEstate10kDataset):
        with pytest.raises(IndexError):
            cls(data_path=str(tree / "train.pickle"), split_path=path)


# ------------------------------------------------------------- the CLIs
def _camera_tree(root, mode, seqs):
    (root / mode).mkdir(parents=True)
    rng = np.random.default_rng(len(seqs))
    for name, (url, timestamps) in seqs.items():
        lines = [url] + [" ".join([str(t)] + [f"{v:.6f}" for v in rng.normal(size=18)]) for t in timestamps]
        (root / mode / f"{name}.txt").write_text("\n".join(lines))


def test_process_and_mine_split_match_jax(tmp_path):
    from scenedino_tpu.cli.process_re10k import main as jmain

    seqs = {"seqA": ("https://v/1", [100_000, 133_367, 166_734]), "seqB": ("https://v/1", [50_000, 83_367]),
            "seqBad": ("https://v/2", [1, 2])}
    outs = {}
    for name, fn in (("ours", pr.main), ("ref", jmain)):
        root = tmp_path / name / "re10k"
        _camera_tree(root, "test", seqs)
        (root / "failed_videos_test.txt").write_text("seqBad\n")
        fn(["process", "-m", "test", "-d", str(root)])
        pairs = tmp_path / name / "pairs"
        pairs.mkdir()
        samples = [{"sequence_id": "seqA", "src_img_obj": {"frame_ts": "133367"}},
                   {"sequence_id": "seqMissing", "src_img_obj": {"frame_ts": "1"}},
                   {"sequence_id": "seqB", "src_img_obj": {"frame_ts": "60000"}}]
        (pairs / "test_pairs.json").write_text("\n".join(json.dumps(s) for s in samples))
        (pairs / "validation_pairs.json").write_text(json.dumps(samples[2]) + "\n\n")
        fn(["mine-split", "-d", str(root), "-o", str(tmp_path / name / "splits"), "-s", str(pairs)])
        with open(root / "test.pickle", "rb") as f:
            outs[name] = (pickle.load(f), {n: (tmp_path / name / "splits" / n).read_text()
                                            for n in ("val_files.txt", "test_files.txt")})
    (ours, ours_split), (ref, ref_split) = outs["ours"], outs["ref"]
    assert sorted(ours) == sorted(ref) == ["seqA", "seqB"]
    for seq in ref:
        for key, value in ref[seq].items():
            assert ours[seq][key].dtype == value.dtype
            np.testing.assert_array_equal(ours[seq][key], value)
    assert ours_split == ref_split == {"val_files.txt": "seqB 1", "test_files.txt": "seqA 1\nseqB 1"}
    with pytest.raises(ValueError, match="Invalid split mode"):
        pr.main(["process", "-m", "val", "-d", str(tmp_path / "ours" / "re10k")])


def test_download_writes_the_manifest_and_fetches_nothing(tmp_path, monkeypatch, capsys):
    from scenedino_tpu.cli.process_re10k import main as jmain

    seqs = {"seqA": ("https://v/1", [3_723_456_000, 100_000]), "seqB": ("https://v/1", [500_000]),
            "seqC": ("https://v/2", [61_000_000])}
    for name in ("ours", "ref"):
        _camera_tree(tmp_path / name, "train", seqs)
    monkeypatch.setattr(shutil, "which", lambda _: None)  # JAX's fetch runs where yt-dlp and ffmpeg exist

    def no_process(*args, **kwargs):
        raise AssertionError("the port's download ran a program")

    monkeypatch.setattr(subprocess, "run", no_process)
    jmain(["download", "-m", "train", "-d", str(tmp_path / "ref"), "-o", "frames_out"])
    pr.main(["download", "-m", "train", "-d", str(tmp_path / "ours"), "-o", "frames_out"])
    assert "not part of the port" in capsys.readouterr().out
    name = "download_manifest_train.json"
    assert (tmp_path / "ours" / name).read_text() == (tmp_path / "ref" / name).read_text()
    manifest = json.loads((tmp_path / "ours" / name).read_text())
    assert manifest[0]["sequences"][0]["frames"][0]["seek"] == "01:02:03.456"
    # without -o both write under <root>/frames/<mode>
    monkeypatch.setattr(shutil, "which", lambda name: "/usr/bin/" + name)  # the port ignores the tools
    pr.main(["download", "-m", "train", "-d", str(tmp_path / "ours")])
    assert json.loads((tmp_path / "ours" / name).read_text())[1]["sequences"][0]["frames"][0]["out"] == str(
        tmp_path / "ours" / "frames" / "train" / "seqC" / "61000000.jpg")
    with pytest.raises(FileNotFoundError):
        pr.main(["download", "-m", "test", "-d", str(tmp_path / "ours")])


# ------------------------------------------------------- the training step
def test_stage1_step_on_an_re10k_batch_matches_jax(tree, models):  # noqa: F811
    """A batch of 2 windows of 4 frames from each package's loader; the
    loss dict and every gradient of one stage-1 step under the alternate
    split, for both outcomes of its coin."""
    jfield, params, model = models
    ours, ref = _pair(tree, image_size=(H, W), frame_count=4, dilation=1)
    items = [(ours[i], ref[i]) for i in (0, 3)]
    batch = {k: np.stack([a[k] for a, _ in items]) for k in ("imgs", "poses", "projs")}
    jbatch = {k: jnp.asarray(np.stack([b[k] for _, b in items])) for k in batch}
    assert batch["imgs"].shape == (2, 4, 3, H, W)
    assert np.abs(batch["imgs"] - np.asarray(jbatch["imgs"])).max() <= 1e-6
    jt, tt, jr, rcfg = _configs(loss_renderer_strategy="alternate")
    state, _ = jtrain.init_train_state(jfield, params, jt, artifact_shape=ART_SHAPE, key=jax.random.PRNGKey(3))
    pstate = _port_state(model, state, tt)
    grad = jax.jit(jax.value_and_grad(
        lambda p, art, key: jtrain.stage1_forward(jfield, p, jbatch, key, jt, jr, jrec.ReconstructionLossConfig(),
                                                  art, training=True), argnums=(0, 1), has_aux=True))
    from scenedino_torch.utils.convert import from_jax_params

    outcomes = set()
    for key in (jax.random.PRNGKey(21), jax.random.PRNGKey(2)):
        (_, ref_losses), (gparams, gart) = grad(state.params, state.artifact_field, key)
        r = int(jax.random.randint(jax.random.split(key, 6)[0], (), 0, 3))
        draws = dataclasses.replace(_jax_draws(key, jt, jr), split_coin=(int(r == 0),) * 2)
        outcomes.add(draws.split_coin)
        model.zero_grad(set_to_none=True)
        pstate.artifact_field.grad = None
        loss, losses = trainer.stage1_forward(model, {k: _t(v) for k, v in batch.items()}, draws, tt, rcfg,
                                              rec.ReconstructionLossConfig(), pstate.artifact_field)
        loss.backward()
        assert sorted(losses) == sorted(ref_losses)
        for name in ref_losses:
            np.testing.assert_allclose(losses[name].item(), float(ref_losses[name]), rtol=1e-5, err_msg=name)
        ref_grads = from_jax_params(gparams["params"])[0]
        params_t = dict(model.named_parameters())
        errs = {n: _grad_rel_err(params_t[n].grad, ref_grads[n]) for n in params_t
                if float(ref_grads[n].abs().max()) > 0}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-3, (worst, errs[worst])
        assert _grad_rel_err(pstate.artifact_field.grad, _t(gart)) <= 1e-3
    assert outcomes == {(0, 0), (1, 1)}  # the even and the odd frames each gave the loss once


def test_re10k_recipe_runs_through_the_cli(tree, tmp_path, caplog):
    """configs/train_scenedino_re10k.yaml through cli.train --device cpu at
    the smoke recipe's widths (its loss/render split kept): 2 steps, a
    validation of 2 windows (no depth ground truth: the dino metric), a
    checkpoint."""
    conf = yaml_config.load(os.path.join(ROOT, "configs", "train_scenedino_re10k.yaml"))
    smoke = yaml_config.load(os.path.join(ROOT, "configs", "train_synthetic_smoke.yaml"))
    assert conf["model"]["loss_renderer_strategy"] == {"name": "alternate"}
    conf["model"] = {**smoke["model"], "loss_renderer_strategy": conf["model"]["loss_renderer_strategy"]}
    conf["model"]["encoder"]["image_size"] = [H, W]
    conf["renderer"]["n_coarse"] = N_COARSE
    conf["dataset"].update(data_path=str(tree / "train.pickle"), image_size=[H, W], dilation=1)
    conf.update(with_amp=False, num_workers=2, batch_size=2)
    conf["training"].update(stop_iteration=2, checkpoint_every=2, log_every=1)
    conf["training"]["ray_sampler"]["args"]["ray_batch_size"] = 256
    conf["validation"]["validation"]["events"][0]["args"]["every"] = 2
    conf["validation"]["validation"]["subset"]["args"] = {"start": 0, "end": 2}
    conf["output"]["path"] = str(tmp_path / "run")
    (tmp_path / "re10k.yaml").write_text(yaml_config.dumps(conf))
    with caplog.at_level(logging.INFO):
        train_cli.main(["--config", str(tmp_path / "re10k.yaml"), "--device", "cpu"])
    steps = [r for r in caplog.records if hasattr(r, "losses")]
    vals = [r for r in caplog.records if hasattr(r, "validator")]
    assert [r.iteration for r in steps] == [1, 2] and all(np.isfinite(list(r.losses.values())).all() for r in steps)
    assert steps[-1].losses["nonfinite_total"] == 0
    assert len(vals) == 1 and np.isfinite(vals[0].metrics["dino_cos_sim"])
    assert (tmp_path / "run" / "training_checkpoint_2.pt").exists()
    run = yaml_config.load_run_config(str(tmp_path / "run"))
    assert run["model"]["loss_renderer_strategy"] == {"name": "alternate"}
