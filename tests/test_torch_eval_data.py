"""The port's evaluation data against the JAX package's: the PNG codec
(`datasets/image_io.py`) against PIL, its resizes against OpenCV, the
label map, the KITTI-360 calibration and poses, and the items of
`SSCBenchDataset`, `CityscapesSeg` and `BDDSeg` on small on-disk trees in
the releases' layouts.

Tolerances: pixels and labels exactly; bilinear resizes 1e-6 on [0, 1]
data (float32 blends of float64 source positions, as OpenCV's, summed in
another order: one or two ulp); dataset images 1e-6 after the [-1, 1]
mapping; calibration and poses exactly (the same float32 arithmetic). The
PIL and OpenCV comparisons skip where either is absent, as on the card's
machine.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from scenedino_torch.datasets import image_io, make_test_dataset
from scenedino_torch.datasets import labels as tlabels
from scenedino_torch.datasets.kitti_360 import load_calibs, load_poses
from scenedino_torch.datasets.seg2d import BDDSeg, CityscapesSeg
from scenedino_torch.datasets.sscbench import SSCBenchDataset

SEQ = "2013_05_28_drive_0009_sync"
RAW = (24, 48)
N_FRAMES = 3


def _pil():
    return pytest.importorskip("PIL.Image")


def _cv2():
    return pytest.importorskip("cv2")


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (37, 53, 4)], ids=["grey", "rgb", "rgba"])
@pytest.mark.parametrize("filter_type", range(5), ids=["none", "sub", "up", "average", "paeth"])
def test_png_round_trip_and_pil_reads_it(tmp_path, shape, filter_type):
    Image = _pil()
    img = np.random.default_rng(filter_type).integers(0, 256, size=shape, dtype=np.uint8)
    path = tmp_path / "x.png"
    image_io.write_png(path, img, filter_type=filter_type)
    np.testing.assert_array_equal(image_io.read_png(path), img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)


@pytest.mark.parametrize("shape", [(376, 1408, 3), (1024, 2048, 3), (1024, 2048)],
                         ids=["sscbench-rgb", "cityscapes-rgb", "cityscapes-labels"])
def test_png_reader_matches_pil_at_the_evaluators_shapes(tmp_path, shape):
    """PIL's writer picks a filter per row (adaptive): smooth images with
    noise make it use several, the reader undoes each."""
    Image = _pil()
    rng = np.random.default_rng(1)
    ramp = np.linspace(0, 255, shape[1])[None, :] + np.linspace(0, 60, shape[0])[:, None]
    img = (ramp if len(shape) == 2 else np.stack([ramp, 255 - ramp, ramp * 0.5], -1))
    img = np.clip(img + rng.normal(0, 8, size=shape), 0, 255).astype(np.uint8)
    path = tmp_path / "x.png"
    Image.fromarray(img).save(path)
    ours = image_io.read_png(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(ours, np.asarray(im))
    rgb = image_io.read_rgb(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(rgb, np.asarray(im.convert("RGB"), np.float32) / 255.0)


@pytest.mark.parametrize("mode", ["I;16", "P", "LA"])
def test_png_reader_refuses_what_it_does_not_read(tmp_path, mode):
    Image = _pil()
    path = tmp_path / "x.png"
    Image.new(mode, (8, 4)).save(path)
    with pytest.raises(ValueError, match="8-bit"):
        image_io.read_png(path)


def test_png_reader_refuses_interlaced(tmp_path):
    path = tmp_path / "x.png"
    image_io.write_png(path, np.zeros((4, 8, 3), np.uint8))
    data = bytearray(path.read_bytes())
    data[28] = 1  # IHDR's interlace method: Adam7
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlac"):
        image_io.read_png(path)


@pytest.mark.parametrize("src,dst", [((376, 1408), (192, 640)), ((1024, 2048), (320, 640)), ((24, 48), (192, 640))],
                         ids=["sscbench", "cityscapes", "upscale"])
def test_resizes_match_opencv(src, dst):
    """resize_bilinear is cv2.INTER_LINEAR to 1e-6 and resize_nearest is
    cv2.INTER_NEAREST exactly; F.interpolate's legacy "nearest" agrees with
    OpenCV here, its bilinear (float32 source positions) does not."""
    cv2 = _cv2()
    rng = np.random.default_rng(2)
    img = rng.random((*src, 3), dtype=np.float32)
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(image_io.resize_bilinear(img, dst), ref, rtol=0, atol=1e-6)
    lab = rng.integers(0, 34, size=src).astype(np.int32)
    ref_lab = cv2.resize(lab, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(image_io.resize_nearest(lab, dst), ref_lab)
    legacy = torch.nn.functional.interpolate(torch.from_numpy(lab).float()[None, None], size=dst, mode="nearest")
    np.testing.assert_array_equal(legacy[0, 0].long().numpy(), ref_lab)
    if src[0] > dst[0]:
        f32 = torch.nn.functional.interpolate(torch.from_numpy(img).permute(2, 0, 1)[None], size=dst,
                                              mode="bilinear", align_corners=False, antialias=False)
        assert np.abs(f32[0].permute(1, 2, 0).numpy() - ref).max() > 1e-5


def test_label_map_matches_jax():
    from scenedino_tpu.datasets import labels as jlabels

    ids = np.arange(-1, 256)
    np.testing.assert_array_equal(tlabels.map_id_to_train_id(ids.clip(0)), jlabels.map_id_to_train_id(ids.clip(0)))
    assert [(l.name, l.id, l.trainId, l.color) for l in tlabels.LABELS] == \
        [(l.name, l.id, l.trainId, l.color) for l in jlabels.LABELS]
    assert tlabels.N_TRAIN_CLASSES == jlabels.N_TRAIN_CLASSES


def _write_kv(path, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for k, v in rows:
            f.write(k + ": " + " ".join(str(float(x)) for x in np.asarray(v).reshape(-1)) + "\n")


@pytest.fixture(scope="module")
def ssc_root(tmp_path_factory):
    """tests/test_cli_sscbench.py's tree: rectified front images, calibration
    (with the fisheye files the JAX loader reads), poses, voxel GT, written
    by the port's PNG writer with a row filter per frame."""
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp("sscbench")
    calib = root / "calibration"
    _write_kv(calib / "calib_cam_to_pose.txt", [
        ("image_00", np.hstack([np.eye(3), [[0.1], [0.2], [0.3]]])),
        ("image_01", np.hstack([np.eye(3), [[0.6], [0], [0]]])),
        ("image_02", np.hstack([np.eye(3), [[-0.1], [0], [0]]])),
        ("image_03", np.hstack([np.eye(3), [[0.7], [0], [0]]])),
    ])
    with open(calib / "calib_cam_to_velo.txt", "w") as f:
        f.write(" ".join(str(float(x)) for x in np.hstack([np.eye(3)[[1, 2, 0]], [[0.5], [0], [-0.2]]]).reshape(-1))
                + "\n")
    H, W = RAW
    P = np.array([[30.0, 0, W / 2 + 0.3, 0], [0, 31.0, H / 2 - 0.2, 0], [0, 0, 1, 0]])
    R = np.array([[0.99, 0.01, 0.0], [-0.01, 0.99, 0.0], [0.0, 0.0, 1.0]])
    _write_kv(calib / "perspective.txt", [
        ("P_rect_00", P), ("R_rect_00", R), ("R_rect_01", np.eye(3)), ("S_rect_00", [W, H]),
    ])
    fish = ("%YAML:1.0\nimage_height: 20\nimage_width: 40\nmirror_parameters: {xi: 2.0}\n"
            "distortion_parameters: {k1: 0.0, k2: 0.0}\n"
            "projection_parameters: {gamma1: 32.0, gamma2: 16.0, u0: 20.0, v0: 10.0}\n")
    (calib / "image_02.yaml").write_text(fish)
    (calib / "image_03.yaml").write_text(fish)
    d = root / "data_2d_raw" / SEQ / "image_00" / "data_rect"
    d.mkdir(parents=True)
    for i in range(N_FRAMES):
        image_io.write_png(d / f"{i:010d}.png", (rng.rand(*RAW, 3) * 255).astype(np.uint8), filter_type=i + 2)
    pose_dir = root / "data_poses" / SEQ
    pose_dir.mkdir(parents=True)
    rows = []
    for i in range(N_FRAMES + 1):  # a pose row without an image or voxels
        M = np.eye(4)
        M[0, 3], M[2, 3] = 0.5 * i, 0.1 * i
        rows.append([i] + list(M[:3].reshape(-1)))
    np.savetxt(pose_dir / "poses.txt", np.asarray(rows))
    gt_dir = root / "voxel_gt" / SEQ
    gt_dir.mkdir(parents=True)
    labels = np.array(list(range(20)) + [255], np.uint8)
    for i in range(N_FRAMES):
        np.save(gt_dir / f"{i:06d}_1_1.npy", rng.choice(labels, size=(256, 256, 32)))
    return root


def test_calibration_and_poses_match_jax(ssc_root):
    from scenedino_tpu.datasets.kitti_360 import load_calibs as jload_calibs
    from scenedino_tpu.datasets.kitti_360 import load_poses as jload_poses

    ours, ref = load_calibs(ssc_root), jload_calibs(ssc_root)
    np.testing.assert_array_equal(ours["K_perspective"], ref["K_perspective"])
    np.testing.assert_array_equal(ours["K_fisheye"], ref["K_fisheye"])
    for cam in ("00", "01", "02", "03"):
        np.testing.assert_array_equal(ours["T_cam_to_pose"][cam], ref["T_cam_to_pose"][cam])
    for cam in ("00", "01"):
        np.testing.assert_array_equal(ours["T_velo_to_cam"][cam], ref["T_velo_to_cam"][cam])
    np.testing.assert_array_equal(ours["T_velo_to_pose"], ref["T_velo_to_pose"])
    assert ours["im_size"] == ref["im_size"]
    (ids, poses), (jids, jposes) = load_poses(ssc_root / "data_poses", [SEQ]), jload_poses(ssc_root / "data_poses",
                                                                                             [SEQ])
    np.testing.assert_array_equal(ids[SEQ], jids[SEQ])
    np.testing.assert_array_equal(poses[SEQ], jposes[SEQ])


@pytest.mark.parametrize("size", [(16, 32), tuple(RAW)], ids=["resized", "raw"])
def test_sscbench_items_match_jax(ssc_root, size):
    _pil(), _cv2()
    from scenedino_tpu.datasets.sscbench import SSCBenchDataset as JSSCBenchDataset

    ours = SSCBenchDataset(data_path=str(ssc_root), voxel_gt_path=str(ssc_root / "voxel_gt"), target_image_size=size)
    ref = JSSCBenchDataset(data_path=str(ssc_root), voxel_gt_path=str(ssc_root / "voxel_gt"), target_image_size=size)
    assert len(ours) == len(ref) == N_FRAMES
    for i in range(N_FRAMES):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        np.testing.assert_allclose(a["imgs"], b["imgs"], rtol=0, atol=1e-6)
        for k in ("poses", "projs", "voxel_gt", "index"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype, k
    # no voxel GT: every front image, no "voxel_gt"
    listed = SSCBenchDataset(data_path=str(ssc_root), target_image_size=size)
    assert len(listed) == N_FRAMES and "voxel_gt" not in listed[0]


def test_sscbench_without_fisheyes_and_kitti_360_raise(ssc_root, tmp_path):
    # the fisheye views and the KITTI-360 loader are ported (their parity is
    # tests/test_torch_kitti360.py's): SSCBench builds the fisheye resamplers,
    # make_test_dataset the KITTI-360 test instance, and RealEstate10K's (make_datasets' test instance)
    from scenedino_torch.datasets.kitti_360 import KITTI360Dataset

    assert sorted(SSCBenchDataset(data_path=str(ssc_root), load_fisheye=True)._resamplers) == ["02", "03"]
    kitti = make_test_dataset({"type": "KITTI_360", "data_path": str(ssc_root),
                               "pose_path": str(ssc_root / "data_poses")})
    assert isinstance(kitti, KITTI360Dataset) and kitti.return_depth and kitti.fisheye_offset == (1,)
    from scenedino_torch.datasets.re10k import RealEstate10kDataset

    (tmp_path / "train.pickle").write_bytes(pickle.dumps({}))
    re10k = make_test_dataset({"type": "re10k", "data_path": str(tmp_path / "train.pickle")})
    assert isinstance(re10k, RealEstate10kDataset) and len(re10k) == 0
    with pytest.raises(ValueError, match="unknown"):
        make_test_dataset({"type": "nope"})
    ds = make_test_dataset({"type": "SSCBench", "data_path": str(ssc_root),
                            "voxel_gt_path": str(ssc_root / "voxel_gt")})
    assert isinstance(ds, SSCBenchDataset) and len(ds) == N_FRAMES


@pytest.fixture(scope="module")
def seg_roots(tmp_path_factory):
    """A Cityscapes tree (leftImg8bit, gtFine labelIds) and a BDD tree
    (images and sem_seg masks, PNG) of 2 frames at 64x128."""
    rng = np.random.RandomState(1)
    cs = tmp_path_factory.mktemp("cityscapes")
    bdd = tmp_path_factory.mktemp("bdd")
    for i, city in enumerate(("aachen", "bremen")):
        (cs / "leftImg8bit" / "val" / city).mkdir(parents=True)
        (cs / "gtFine" / "val" / city).mkdir(parents=True)
        image_io.write_png(cs / "leftImg8bit" / "val" / city / f"{city}_{i:06d}_leftImg8bit.png",
                           (rng.rand(64, 128, 3) * 255).astype(np.uint8), filter_type=4)
        image_io.write_png(cs / "gtFine" / "val" / city / f"{city}_{i:06d}_gtFine_labelIds.png",
                           rng.randint(0, 34, (64, 128)).astype(np.uint8), filter_type=1)
    (bdd / "images" / "10k" / "val").mkdir(parents=True)
    (bdd / "labels" / "sem_seg" / "masks" / "val").mkdir(parents=True)
    for i in range(2):
        image_io.write_png(bdd / "images" / "10k" / "val" / f"b{i}.png", (rng.rand(64, 128, 3) * 255).astype(np.uint8))
        mask = np.where(rng.rand(64, 128) < 0.2, 255, rng.randint(0, 19, (64, 128))).astype(np.uint8)
        image_io.write_png(bdd / "labels" / "sem_seg" / "masks" / "val" / f"b{i}.png", mask, filter_type=3)
    return cs, bdd


@pytest.mark.parametrize("kind", ["Cityscapes_seg", "BDD_seg"])
def test_seg2d_items_match_jax(seg_roots, kind):
    _pil(), _cv2()
    from scenedino_tpu.datasets import make_test_dataset as jmake_test_dataset

    root = seg_roots[0] if kind == "Cityscapes_seg" else seg_roots[1]
    conf = {"type": kind, "data_path": str(root), "split": "val", "image_size": [192, 640]}
    ours, ref = make_test_dataset(conf), jmake_test_dataset(conf)
    assert isinstance(ours, CityscapesSeg if kind == "Cityscapes_seg" else BDDSeg)
    assert len(ours) == len(ref) == 2
    for i in range(2):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        np.testing.assert_allclose(a["imgs"], b["imgs"], rtol=0, atol=1e-6)
        for k in ("segs", "poses", "projs", "index"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["imgs"].shape == (1, 3, 192, 640) and a["segs"].dtype == np.int64
        assert set(np.unique(a["segs"])) <= set(range(-1, 19))
    # another crop size passes through to the items
    small = make_test_dataset({**conf, "image_size": [32, 64]})
    assert small[0]["imgs"].shape == (1, 3, 32, 64) and small[0]["segs"].shape == (1, 32, 64)
    assert os.path.basename(str(small.items[0][0])).endswith(".png")
