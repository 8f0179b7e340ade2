"""The KITTI-360 slice of the port end to end on the CPU, against the JAX
package: the preprocess CLIs (`scenedino_torch.cli.preprocess_kitti_360`
resize and bbox-split), one stage-1 training step on a KITTI-360 batch,
one 2D-evaluation frame on a KITTI-360 item, and the three KITTI-360
recipes (`train_scenedino_kitti_360.yaml`, `train_semantic_kitti_360.yaml`,
`evaluate_semantic_kitti_360.yaml`) through the port's CLIs on
tests/test_torch_kitti360.py's seeded tree at tiny width.

The models are tests/test_torch_training.py's (a ViT-S/8 cut to width 64,
depth 3, 2 heads; DPT 16; 32x64; 8 samples a ray) and
tests/test_torch_stage2.py's head, on weights drawn with numpy in the JAX
layout. fp32; JAX at "highest" matmul precision.

Tolerances: the fisheye cache PNGs equal pixel for pixel (the same warp
and the same uint8 conversion, truncation included); the perspective ones
too, except where the value before truncation lies within 1e-3 of an
integer, where they may differ by 1: the resize is held to cv2's to 1e-6,
not bit for bit, and a pixel whose neighbours are equal lands on an
integer, which round-off puts on either side (about 6% of these random
frames' pixels); split files line for line; an item read
through the cache against the same item resampled on the fly within one
8-bit step after the [-1, 1] scaling, 2/255. The training step as
tests/test_torch_training.py holds it (the loss dict rtol 1e-5, each
gradient's relative L2 error <= 1e-3), each side on its own loader's
batch (the batches differ by the resize's round-off, <= 2e-6). The
evaluation frame as tests/test_torch_seg2d.py holds it (depth rtol and
atol 1e-4; labels equal where the mode's top two scores differ by more
than 1e-4, at least 90% of the pixels).
"""
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.losses.reconstruction as jrec
import scenedino_tpu.training.trainer as jtrain
from scenedino_torch.cli import evaluate as eval_cli
from scenedino_torch.cli import preprocess_kitti_360 as pp
from scenedino_torch.cli import train as train_cli
from scenedino_torch.datasets import image_io, make_datasets, make_test_dataset
from scenedino_torch.losses import reconstruction as rec
from scenedino_torch.training import trainer
from scenedino_torch.utils import config as yaml_config
from tests.test_torch_kitti360 import SEQ, TGT, _datasets, _items, write_kitti_tree
from tests.test_torch_seg2d import MODES, _draws, _scores
from tests.test_torch_stage2 import HEAD, setup  # noqa: F401  (the shared module fixture)
from tests.test_torch_training import (  # noqa: F401  (models: the shared module fixture)
    ART_SHAPE,
    N_COARSE,
    _configs,
    _grad_rel_err,
    _port_state,
    _t,
    models,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, V = 2, 8
# a longer sequence than the loader tests': the test instance's fisheye offset
# is pinned to 10, and the resize cache holds every frame but the last
N_CLI = 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same seeded tree twice: one for the port's CLI, one for JAX's."""
    ours = write_kitti_tree(tmp_path_factory.mktemp("kitti_port"), n_frames=N_CLI)
    ref = tmp_path_factory.mktemp("kitti_jax") / "kitti"
    shutil.copytree(ours, ref)
    return ours, ref


@pytest.fixture(scope="module")
def cached(trees):
    """Both trees after their package's resize CLI; the port's in 2
    processes."""
    from scenedino_tpu.cli.preprocess_kitti_360 import main as jmain

    ours, ref = trees
    pp.main(["resize", "-d", str(ours), "-r", *map(str, TGT), "--workers", "2"])
    jmain(["resize", "-d", str(ref), "-r", *map(str, TGT)])
    return trees


def test_resize_cli_writes_the_references_cache(cached):
    ours, ref = cached
    folders = [f"image_00/data_{TGT[0]}x{TGT[1]}", f"image_01/data_{TGT[0]}x{TGT[1]}",
               f"image_02/data_{TGT[0]}x{TGT[1]}_0x-15", f"image_03/data_{TGT[0]}x{TGT[1]}_0x-15"]
    ds = pp._resize_dataset(ours, TGT, (0, -15))
    n = 0
    for view, folder in enumerate(folders):
        names = sorted(p.name for p in (ref / "data_2d_raw" / SEQ / folder).glob("*.png"))
        assert names == sorted(p.name for p in (ours / "data_2d_raw" / SEQ / folder).glob("*.png")) != []
        for name in names:
            a = image_io.read_png(ours / "data_2d_raw" / SEQ / folder / name).astype(np.int64)
            b = image_io.read_png(ref / "data_2d_raw" / SEQ / folder / name).astype(np.int64)
            assert a.shape == (*TGT, 3)
            if view >= 2:
                np.testing.assert_array_equal(a, b, err_msg=f"{folder}/{name}")
            else:
                v = (ds[2 * int(name[:10])]["imgs"][view].transpose(1, 2, 0) * 0.5 + 0.5) * 255.0
                edge = np.abs(v - np.round(v)) < 1e-3
                np.testing.assert_array_equal(a[~edge], b[~edge], err_msg=f"{folder}/{name}")
                assert np.abs(a - b)[edge].max(initial=0) <= 1 and edge.mean() < 0.1
            n += 1
    assert n == 4 * (N_CLI - 1)  # every frame but the last (the resize dataset's full split)
    # a second run finds every frame cached and writes nothing
    pp.main(["resize", "-d", str(ours), "-r", *map(str, TGT)])


def test_to_uint8_truncates_as_the_reference():
    x = np.array([-1.5, -1.0, -0.00001, 0.0, 0.99999, 1.0, 2.0], np.float32).reshape(1, 1, -1).repeat(3, 0)
    ours = pp.to_uint8(x)
    expect = np.clip((np.transpose(x, (1, 2, 0)) * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(ours, expect)
    assert ours[0, :, 0].tolist() == [0, 0, 127, 127, 254, 255, 255]


def test_cached_items_match_jax_and_the_raw_frames(cached):
    """The port's cache read by both packages, equal; and within one 8-bit
    step of the same items resampled from the raw frames."""
    ours_root = cached[0]
    kw = dict(split_path=str(ours_root / "splits" / "test_files.txt"), fisheye_offset=(2, 3))
    ours, ref = _datasets(ours_root, is_preprocessed=True, **kw)
    raw, _ = _datasets(ours_root, **kw)
    for index in range(len(ours)):
        a, b = _items(ours, ref, index, seed=index)
        np.testing.assert_array_equal(a["imgs"], b["imgs"])
        ours._rng_local.rng = np.random.RandomState(index)
        raw._rng_local.rng = np.random.RandomState(index)
        c = raw[index]
        np.testing.assert_array_equal(a["poses"], c["poses"])
        assert np.abs(a["imgs"] - c["imgs"]).max() <= 2 / 255


def test_bbox_split_cli_matches_jax(tmp_path):
    from scenedino_tpu.cli.preprocess_kitti_360 import main as jmain

    data = tmp_path / "kitti"
    sem = data / "data_2d_semantics" / "train"
    sem.mkdir(parents=True)
    train = [f"data_2d_raw/{SEQ}/image_00/data_rect/{i:010d}.png seg/{i:010d}.png" for i in range(6)]
    val = [f"data_2d_raw/{SEQ}/image_00/data_rect/{100 + i:010d}.png seg/{100 + i:010d}.png" for i in range(250)]
    (sem / "2013_05_28_drive_train_frames.txt").write_text("\n".join(train))
    (sem / "2013_05_28_drive_val_frames.txt").write_text("\n".join(val))
    for i in [j for j in range(6) if j != 3] + [100 + j for j in range(250) if j % 7]:
        for cam, folder in (("00", "data_rect"), ("02", "data_rgb")):
            p = data / "data_2d_raw" / SEQ / f"image_{cam}" / folder / f"{i:010d}.png"
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(b"")
    pp.main(["bbox-split", "-d", str(data), "-o", str(tmp_path / "ours"), "--offset", "3"])
    jmain(["bbox-split", "-d", str(data), "-o", str(tmp_path / "ref"), "--offset", "3"])
    for name in ("train_files.txt", "val_files.txt", "test_files.txt"):
        a = (tmp_path / "ours" / name).read_text().splitlines()
        assert a == (tmp_path / "ref" / name).read_text().splitlines() and a, name
    assert len((tmp_path / "ours" / "train_files.txt").read_text().splitlines()) == 10


# ------------------------------------------------------- the training step
def _jax_draws(key, tcfg, rcfg, gt_patch=8):
    """tests/test_torch_training.py's draws rebuilt from the JAX key, for 8 views."""
    H, W = TGT
    k_split, k_shift, _, k_patch, k_render, _ = jax.random.split(key, 6)
    coin = tuple(int(c) for c in np.asarray(jax.random.randint(k_split, (V // 2,), 0, 3) == 0))
    shift = None
    if tcfg.grid_shift_augmentation:
        shift = tuple(int(s) for s in np.asarray(
            jax.random.randint(k_shift, (2,), -(gt_patch // 2), gt_patch // 2)))
    s = int(shift is not None)
    PC = tcfg.ray_batch_size // tcfg.patch_size ** 2
    k_v, k_y, k_x = jax.random.split(k_patch, 3)
    picks = [torch.from_numpy(np.asarray(jax.random.randint(kk, (B, PC), 0, hi)).astype(np.int64))
             for kk, hi in ((k_v, V // 2), (k_y, H // tcfg.patch_size - s), (k_x, W // tcfg.patch_size - s))]
    k_coarse = jax.random.split(k_render, 5)[0]
    u = _t(jax.random.uniform(k_coarse, (B * tcfg.ray_batch_size, rcfg.n_coarse)))
    return trainer.Stage1Draws(coin, shift, False, *picks, u)


def test_stage1_step_on_a_kitti_360_batch_matches_jax(trees, models):  # noqa: F811
    """A batch of 2 items (8 views: stereo pairs and resampled fisheyes at
    two timesteps, colour jitter, random fisheye offsets) from each
    package's loader under the same draws; the loss dict and every
    gradient of one stage-1 step on it."""
    jfield, params, model = models
    ours, ref = _datasets(trees[0], fisheye_offset=(2, 3), color_aug=True)
    items = [_items(ours, ref, i, seed=40 + i) for i in (0, 3)]
    batch = {k: np.stack([a[k] for a, _ in items]) for k in ("imgs", "poses", "projs")}
    jbatch = {k: jnp.asarray(np.stack([b[k] for _, b in items])) for k in batch}
    assert batch["imgs"].shape == (B, V, 3, *TGT)
    assert np.abs(batch["imgs"] - np.asarray(jbatch["imgs"])).max() <= 2e-6

    jt, tt, jr, rcfg = _configs()
    state, _ = jtrain.init_train_state(jfield, params, jt, artifact_shape=ART_SHAPE, key=jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(21)

    def loss_fn(p, art):
        return jtrain.stage1_forward(jfield, p, jbatch, key, jt, jr, jrec.ReconstructionLossConfig(), art,
                                     training=True)

    (_, ref_losses), (gparams, gart) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        state.params, state.artifact_field)

    from scenedino_torch.utils.convert import from_jax_params

    pstate = _port_state(model, state, tt)
    draws = _jax_draws(key, jt, jr)
    model.zero_grad(set_to_none=True)
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
    assert any(n.startswith("encoder.vit_encoder.") for n in errs)
    assert _grad_rel_err(pstate.artifact_field.grad, _t(gart)) <= 1e-3


# ------------------------------------------------------ the 2D evaluation
def test_seg2d_frame_of_a_kitti_360_item_matches_jax(trees, setup):  # noqa: F811
    """Seg2DEvaluator on a KITTI-360 test item (8 views; view 0 encoded
    and rendered, the fast path) against JAX's evaluator on JAX's item."""
    from scenedino_tpu.eval.seg2d import Seg2DEvaluator as JSeg2DEvaluator

    from scenedino_torch.eval.seg2d import Seg2DEvaluator
    from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig
    from scenedino_torch.utils.convert import load_jax_head

    head = SemanticHead(SemanticHeadConfig(**HEAD))
    load_jax_head(head, setup["hvars"])
    head.eval()
    ours_ev = Seg2DEvaluator(field=setup["model"], head=head, image_size=TGT, n_coarse=N_COARSE, n_classes=5)
    ref_ev = JSeg2DEvaluator(field=setup["jfield"], head=setup["jhead"], field_params=setup["params"],
                             head_variables=setup["hvars"], image_size=TGT, n_coarse=N_COARSE, n_classes=5)
    ours, ref = _datasets(trees[0], split_path=str(trees[0] / "splits" / "test_files.txt"), fisheye_offset=(1,),
                          return_depth=True, return_segmentation=True)
    a, b = ours[0], ref[0]
    assert a["imgs"].shape == (V, 3, *TGT) and ours_ev.uses_fast_render()
    batch = [torch.from_numpy(a[k])[None] for k in ("imgs", "projs", "poses")]
    with torch.no_grad():
        rendered = ours_ev.render(*batch, _draws(0))
        preds = ours_ev.labels(rendered)
        feats = ours_ev.field.expand_dim(rendered[1])
    jpreds = ref_ev._predict(ref_ev.field_params, ref_ev.head_variables,
                             *(jnp.asarray(b[k])[None] for k in ("imgs", "projs", "poses")), jax.random.PRNGKey(0))
    np.testing.assert_allclose(preds["depth"].numpy(), np.asarray(jpreds["depth"]), rtol=1e-4, atol=1e-4)
    below = 0
    for mode in MODES:
        top2 = torch.topk(_scores(ours_ev.head, feats, mode), 2, -1).values
        clear = ((top2[..., 0] - top2[..., 1]) > 1e-4).numpy()
        assert clear.mean() >= 0.9, (mode, clear.mean())
        below += int((~clear).sum())
        np.testing.assert_array_equal(preds[mode].numpy()[clear], np.asarray(jpreds[mode])[clear])
    # the confusions of the frame against its KITTI-360 ids, out-of-range ids as JAX counts them
    res = ours_ev.run([a], draws=_draws)
    jres = ref_ev.run([b])
    for mode in MODES:
        diff = np.abs(res[mode]["confusion_matrix"] - np.asarray(jres[mode]["confusion_matrix"])).sum()
        assert diff <= 2 * below, (mode, diff, below)
        assert np.asarray(jres[mode]["confusion_matrix"]).sum() > 0


def test_confusion_matrix_counts_out_of_range_ids_as_jax():
    from scenedino_tpu.eval.metrics import seg_confusion_matrix as jconfusion

    from scenedino_torch.eval.metrics import seg_confusion_matrix

    rng = np.random.default_rng(7)
    target = rng.integers(-3, 45, size=500)
    pred = rng.integers(0, 19, size=500)
    for n_pred in (None, 25):
        ref = np.asarray(jconfusion(jnp.asarray(target), jnp.asarray(pred), 19, n_pred))
        np.testing.assert_array_equal(seg_confusion_matrix(target, pred, 19, n_pred), ref)


# --------------------------------------------------------- the recipes
def _kitti_dataset_block(conf, root):
    conf["dataset"].update(data_path=str(root), pose_path=str(root / "data_poses"), split_path=str(root / "splits"),
                           image_size=list(TGT), fisheye_offset=[2, 3, 4])


def _tiny_model(conf):
    smoke = yaml_config.load(os.path.join(ROOT, "configs", "train_synthetic_smoke.yaml"))
    conf["model"] = {**smoke["model"], **{k: v for k, v in conf.get("model", {}).items() if k == "sample_radius_3d"}}
    conf["model"]["encoder"]["image_size"] = list(TGT)
    conf["renderer"] = {**conf.get("renderer", {}), "n_coarse": N_COARSE}
    conf["with_amp"] = False
    conf["num_workers"] = 2


def test_kitti_360_recipes_run_through_the_cli(cached, tmp_path, caplog):
    """configs/train_scenedino_kitti_360.yaml (2 steps, a validation on the
    velodyne depths), then configs/train_semantic_kitti_360.yaml from that
    run (2 steps, a validation on the KITTI-360 labels), then
    configs/evaluate_semantic_kitti_360.yaml with the stage-2 run: the
    port's CLIs on the CPU, the shipped recipes with the smoke recipe's
    tiny model and the tree's paths."""
    root = cached[0]
    s1 = yaml_config.load(os.path.join(ROOT, "configs", "train_scenedino_kitti_360.yaml"))
    _kitti_dataset_block(s1, root)
    _tiny_model(s1)
    s1["batch_size"] = 2
    s1["training"].update(stop_iteration=2, checkpoint_every=2, log_every=1)
    s1["training"]["ray_sampler"]["args"]["ray_batch_size"] = 256
    s1["validation"]["validation"]["events"][0]["args"]["every"] = 2
    s1["validation"]["validation"]["subset"]["args"] = {"start": 0, "end": 2}
    s1["output"]["path"] = str(tmp_path / "s1")
    (tmp_path / "s1.yaml").write_text(yaml_config.dumps(s1))
    with caplog.at_level(logging.INFO):
        train_cli.main(["--config", str(tmp_path / "s1.yaml"), "--device", "cpu"])
    steps = [r for r in caplog.records if hasattr(r, "losses")]
    vals = [r for r in caplog.records if hasattr(r, "validator")]
    assert [r.iteration for r in steps] == [1, 2] and all(np.isfinite(list(r.losses.values())).all() for r in steps)
    assert len(vals) == 1 and np.isfinite(vals[0].metrics["depth_abs_rel"]) and "dino_cos_sim" in vals[0].metrics
    assert (tmp_path / "s1" / "training_checkpoint_2.pt").exists()

    caplog.clear()
    s2 = yaml_config.load(os.path.join(ROOT, "configs", "train_semantic_kitti_360.yaml"))
    _kitti_dataset_block(s2, root)
    _tiny_model(s2)
    s2["batch_size"] = 2
    s2["resume_from"] = str(tmp_path / "s1")
    s2["downstream"].update(input_dim=64, buffer_size=8, patch_sample_size=16)
    s2["training"].update(stop_iteration=2, checkpoint_every=2, log_every=1, num_epochs=4)
    s2["validation"]["validation"]["events"][0]["args"]["every"] = 2
    s2["validation"]["validation"]["subset"] = {"type": "range", "args": {"start": 0, "end": 2}}
    s2["output"]["path"] = str(tmp_path / "s2")
    (tmp_path / "s2.yaml").write_text(yaml_config.dumps(s2))
    with caplog.at_level(logging.INFO):
        train_cli.main(["--config", str(tmp_path / "s2.yaml"), "--stage", "semantic", "--device", "cpu"])
    steps = [r for r in caplog.records if hasattr(r, "losses")]
    vals = [r for r in caplog.records if hasattr(r, "validator")]
    assert [r.iteration for r in steps] == [1, 2] and all(np.isfinite(list(r.losses.values())).all() for r in steps)
    seg = {k: v for k, v in vals[0].metrics.items() if k.endswith(("_miou", "_acc"))}
    assert len(vals) == 1 and seg and all(0.0 <= v <= 1.0 for v in seg.values())

    ev = yaml_config.load(os.path.join(ROOT, "configs", "evaluate_semantic_kitti_360.yaml"))
    ev["dataset"].update(data_path=str(root), pose_path=str(root / "data_poses"), split_path=str(root / "splits"),
                         image_size=list(TGT), fisheye_offset=[2])
    run = yaml_config.load_run_config(str(tmp_path / "s2"))
    ev.pop("variant")
    ev["model"], ev["downstream"], ev["renderer"] = run["model"], run["downstream"], run["renderer"]
    (tmp_path / "ev.yaml").write_text(yaml_config.dumps(ev))
    out = eval_cli.main(["--config", str(tmp_path / "ev.yaml"), "--ckpt", str(tmp_path / "s2"), "--device", "cpu"])
    assert out["n_frames"] == len(make_test_dataset(ev["dataset"])) == 2
    for mode in MODES:
        assert all(0.0 <= out[mode][k] <= 1.0 for k in ("miou", "weighted_miou", "acc"))
    assert make_datasets(s1["dataset"])[1].return_depth


def test_kitti_360_labels_reach_the_head_as_train_ids(trees):
    """The loader returns the PNG's KITTI-360 ids as the JAX loader does;
    the stage-2 and evaluation CLIs read them as train ids
    (datasets.TrainIdSegs), as the reference's head takes them. On the
    unmapped ids the JAX package's probe loss is NaN (an id >= 19 indexes
    past the 19 logits), which would skip every stage-2 step."""
    from scenedino_tpu.models.downstream import cross_entropy_ignore as jcross_entropy

    from scenedino_torch.datasets import TrainIdSegs, with_train_ids
    from scenedino_torch.datasets.labels import map_id_to_train_id
    from scenedino_torch.models.downstream import cross_entropy_ignore

    config = {"type": "old_KITTI_360", "data_path": str(trees[0]), "pose_path": str(trees[0] / "data_poses"),
              "split_path": str(trees[0] / "splits"), "image_size": list(TGT), "data_segmentation": True}
    train, test = make_datasets(config)
    view = with_train_ids(test, config)
    assert isinstance(view, TrainIdSegs) and len(view) == len(test)
    assert with_train_ids(test, {"type": "Cityscapes_seg"}) is test
    raw, mapped = test[0]["segs"], view[0]["segs"]
    assert raw.max() >= 19 and mapped.max() < 19 and (mapped == -1).any()
    np.testing.assert_array_equal(mapped, map_id_to_train_id(raw))
    np.testing.assert_array_equal(view[0]["imgs"], test[0]["imgs"])
    logits = np.random.default_rng(8).normal(size=(1, *TGT, 19)).astype(np.float32)
    assert np.isnan(float(jcross_entropy(jnp.asarray(logits), jnp.asarray(raw))))
    ours = cross_entropy_ignore(torch.from_numpy(logits), torch.from_numpy(mapped))
    np.testing.assert_allclose(ours.item(), float(jcross_entropy(jnp.asarray(logits), jnp.asarray(mapped))),
                               rtol=1e-6)
