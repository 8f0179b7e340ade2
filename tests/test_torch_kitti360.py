"""The port's KITTI-360 loader (`scenedino_torch/datasets/kitti_360.py`,
`annotations.py`, `core/point_sampling.py`, the KITTI-360 kinds of the
dataset factories and SSCBench's fisheye views) against the JAX package's
on the CPU, on a seeded tree in the release's layout written here: 12
posed frames of one sequence, rectified perspective pairs (48x96) and
fisheye pairs (40x40) written by the port's PNG writer with every row
filter, the calibration files with the fisheye YAMLs in the test layout
(flow mappings) or the release's (OpenCV FileStorage: `---`, block
mappings, scientific floats), velodyne scans, semantic PNGs of KITTI-360
ids, a 3D-box XML and a split directory.

Random draws are made equal as the JAX loader makes them per thread: both
sides get the same `np.random.RandomState` as their thread-local stream
(`_rng_local.rng`) before each item.

Tolerances: calibration, poses, intrinsics, timesteps, depths, labels,
boxes, fisheye warps and the overlap estimate exact (the same float
operations in the same order); the frustum overlap of seeded poses exact;
the colour jitter on one input 1e-6; an item's images 2e-6: a resized
view is `image_io.resize_bilinear`, held to cv2.INTER_LINEAR to 1e-6 on
[0, 1] (tests/test_torch_eval_data.py), and the [-1, 1] scaling doubles
that; the jitter's contrast, saturation and hue (a division by a pixel's
max - min) amplify the resize's float32 round-off (measured here: 2.4e-7
without the jitter, 1.7e-6 with it).
"""
import copy
import dataclasses
import pickle
import shutil

import numpy as np
import pytest
import torch

from scenedino_torch.datasets import image_io, make_datasets, make_test_dataset
from scenedino_torch.datasets import kitti_360 as K

SEQ = "2013_05_28_drive_0000_sync"
RAW_P = (48, 96)  # rectified perspective H, W
RAW_F = (40, 40)  # fisheye H, W
TGT = (32, 64)
N_FRAMES = 12
IMG_TOL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _write_kv(path, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for k, v in rows:
            f.write(k + ": " + " ".join(repr(float(x)) for x in np.asarray(v).reshape(-1)) + "\n")


def fisheye_yaml(layout: str, cam: str, size=RAW_F) -> str:
    """A fisheye calibration at `size` in the test's flow layout or the
    release's FileStorage layout (the release's image_02 values, scaled
    from 1400x1400)."""
    fh, fw = size
    s = fw / 1400.0
    xi, k1, k2 = (2.2134047507854890, 1.6798235660113681e-02, 1.6548773243373522) if cam == "02" else \
        (2.5535139132482758, 4.9370396274089505e-02, 4.5068455478645308)
    g1, g2, u0, v0 = 1336.3220825849971 * s, 1335.7883350012958 * s, 716.94323510126321 * s, 705.76498308221585 * s
    if layout == "flow":
        return (f"%YAML:1.0\nimage_height: {fh}\nimage_width: {fw}\nmirror_parameters: {{xi: {xi!r}}}\n"
                f"distortion_parameters: {{k1: {k1!r}, k2: {k2!r}}}\n"
                f"projection_parameters: {{gamma1: {g1!r}, gamma2: {g2!r}, u0: {u0!r}, v0: {v0!r}}}\n")
    return (f"%YAML:1.0\n---\nmodel_type: MEI\ncamera_name: image_{cam}\nimage_width: {fw}\nimage_height: {fh}\n"
            f"mirror_parameters:\n   xi: {xi:.16e}\ndistortion_parameters:\n   k1: {k1:.16e}\n   k2: {k2:.16e}\n"
            f"   p1: 4.2223943394772046e-04\n   p2: 4.2462134260997584e-04\nprojection_parameters:\n"
            f"   gamma1: {g1:.16e}\n   gamma2: {g2:.16e}\n   u0: {u0:.16e}\n   v0: {v0:.16e}\n")


def _mat(m):
    m = np.asarray(m, np.float64)
    return (f"<rows>{m.shape[0]}</rows><cols>{m.shape[1]}</cols>"
            f"<data>{' '.join(repr(float(v)) for v in m.reshape(-1))}</data>")


def bbox_xml() -> str:
    """A car 10 m ahead of the first camera (static), a far stuff box of
    frame 3 and one of frame 1 in view, and a node without a transform."""
    verts = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)])
    faces = np.array([[0, 1, 2], [1, 3, 2]])

    def obj(tag, body, T):
        return (f"<{tag}>{body}<start_frame>0</start_frame><end_frame>100</end_frame>"
                f"<transform type_id='opencv-matrix'>{_mat(T)}</transform>"
                f"<vertices type_id='opencv-matrix'>{_mat(verts)}</vertices>"
                f"<faces type_id='opencv-matrix'>{_mat(faces)}</faces></{tag}>")

    T1, T2, T3 = np.eye(4), np.eye(4), np.eye(4)
    T1[:3, 3] = [0.3, 1.0, 10.0]
    T2[:3, 3] = [500.0, 0.0, -50.0]
    T3[:3, 3] = [-1.0, 0.5, 6.0]
    return ("<?xml version='1.0'?><opencv_storage>"
            + obj("object_car", "<label>car</label><semanticId>13</semanticId><instanceId>7</instanceId>"
                                "<timestamp>-1</timestamp>", T1)
            + obj("object_far", "<label>trafficSign</label><timestamp>3</timestamp>", T2)
            + obj("object_pole", "<label>bigPole</label><timestamp>1</timestamp>", T3)
            + "<noise_node><foo>1</foo></noise_node></opencv_storage>")


def write_kitti_tree(root, layout="release", n_frames=N_FRAMES, seed=0):
    """The seeded KITTI-360 tree described above under `root`."""
    rng = np.random.RandomState(seed)
    calib = root / "calibration"
    rot = np.array([[0.9998, -0.0175, 0.0], [0.0175, 0.9998, 0.0], [0.0, 0.0, 1.0]])
    _write_kv(calib / "calib_cam_to_pose.txt", [
        ("image_00", np.hstack([np.eye(3), [[0.05], [-0.1], [0.2]]])),
        ("image_01", np.hstack([np.eye(3), [[0.6], [-0.1], [0.2]]])),
        ("image_02", np.hstack([rot, [[-0.1], [0.0], [0.1]]])),
        ("image_03", np.hstack([rot.T, [[0.7], [0.0], [0.1]]])),
    ])
    with open(calib / "calib_cam_to_velo.txt", "w") as f:  # velodyne x forward, camera z forward
        f.write(" ".join(repr(float(x)) for x in np.hstack([[[0, 0, 1], [-1, 0, 0], [0, -1, 0]],
                                                            [[0.8], [0.3], [-0.7]]]).reshape(-1)) + "\n")
    H, W = RAW_P
    _write_kv(calib / "perspective.txt", [
        ("P_rect_00", np.array([[40.0, 0, W / 2 + 0.3, 0], [0, 41.0, H / 2 - 0.4, 0], [0, 0, 1, 0]])),
        ("R_rect_00", np.array([[0.9999, 0.01, 0.0], [-0.01, 0.9999, 0.0], [0.0, 0.0, 1.0]])),
        ("R_rect_01", np.eye(3)), ("S_rect_00", [W, H]),
    ])
    for cam in ("02", "03"):
        (calib / f"image_{cam}.yaml").write_text(fisheye_yaml(layout, cam))
    raw = root / "data_2d_raw" / SEQ
    for cam, folder, size in (("00", "data_rect", RAW_P), ("01", "data_rect", RAW_P),
                              ("02", "data_rgb", RAW_F), ("03", "data_rgb", RAW_F)):
        d = raw / f"image_{cam}" / folder
        d.mkdir(parents=True)
        for i in range(n_frames):
            image_io.write_png(d / f"{i:010d}.png", (rng.rand(*size, 3) * 255).astype(np.uint8), filter_type=i % 5)
    sem = root / "data_2d_semantics" / "train" / SEQ / "image_00" / "semantic"
    velo = root / "data_3d_raw" / SEQ / "velodyne_points" / "data"
    sem.mkdir(parents=True)
    velo.mkdir(parents=True)
    for i in range(n_frames):
        image_io.write_png(sem / f"{i:010d}.png", rng.randint(0, 45, size=RAW_P).astype(np.uint8), filter_type=2)
        pts = np.stack([rng.uniform(-5, 40, 400), rng.uniform(-15, 15, 400), rng.uniform(-2, 1, 400),
                        rng.uniform(0, 1, 400)], -1).astype(np.float32)
        pts.tofile(velo / f"{i:010d}.bin")
    pose_dir = root / "data_poses" / SEQ
    pose_dir.mkdir(parents=True)
    rows = []
    for i in range(n_frames):
        c, s = np.cos(0.02 * i), np.sin(0.02 * i)
        M = np.array([[c, 0, s, 0.1 * i], [0, 1, 0, 0.01 * i], [-s, 0, c, 0.9 * i]])
        rows.append([i] + list(M.reshape(-1)))
    np.savetxt(pose_dir / "poses.txt", np.asarray(rows))
    bbox = root / "data_3d_bboxes" / "train_full"
    bbox.mkdir(parents=True)
    (bbox / f"{SEQ}.xml").write_text(bbox_xml())
    splits = root / "splits"
    splits.mkdir()
    (splits / "train_files.txt").write_text(f"{SEQ} 0000000001 l\n{SEQ} 0000000001 r\n{SEQ} 0000000004 r\n")
    (splits / "test_files.txt").write_text(f"{SEQ} 0000000002 l\n{SEQ} 0000000003 l\n")
    return root


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    return write_kitti_tree(tmp_path_factory.mktemp("kitti360"))


@pytest.fixture(scope="module")
def flow_root(tmp_path_factory):
    return write_kitti_tree(tmp_path_factory.mktemp("kitti360_flow"), layout="flow", n_frames=4)


def _datasets(root, **kw):
    from scenedino_tpu.datasets.kitti_360 import KITTI360Dataset as JKITTI360Dataset

    kw = {"data_path": str(root), "pose_path": str(root / "data_poses"), "target_image_size": TGT, **kw}
    return K.KITTI360Dataset(**kw), JKITTI360Dataset(**kw)


def _items(ours, ref, index, seed):
    """Item `index` of both datasets, each drawn from RandomState(seed) as
    its thread-local stream."""
    ours._rng_local.rng = np.random.RandomState(seed)
    ref._rng_local.rng = np.random.RandomState(seed)
    return ours[index], ref[index]


def assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in b:
        if k == "3d_bboxes":
            assert len(a[k]) == len(b[k]) == 1 and len(a[k][0]) == len(b[k][0])
            for x, y in zip(a[k][0], b[k][0]):
                assert x.keys() == y.keys() and x["semanticId"] == y["semanticId"]
                assert x["instanceId"] == y["instanceId"]
                np.testing.assert_array_equal(x["vertices"], y["vertices"])
                np.testing.assert_array_equal(x["faces"], y["faces"])
            continue
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if k == "imgs":
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=IMG_TOL)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------- calibration
def _assert_calibs_equal(ours, ref, fisheye=True):
    for k in ("K_perspective", "K_fisheye", "T_velo_to_pose"):
        np.testing.assert_array_equal(ours[k], ref[k])
        assert ours[k].dtype == ref[k].dtype
    for cam in ("00", "01", "02", "03"):
        np.testing.assert_array_equal(ours["T_cam_to_pose"][cam], ref["T_cam_to_pose"][cam])
    for cam in ("00", "01"):
        np.testing.assert_array_equal(ours["T_velo_to_cam"][cam], ref["T_velo_to_cam"][cam])
    assert ours["im_size"] == ref["im_size"]
    if fisheye:
        for key in ("calib_02", "calib_03"):
            assert ours["fisheye"][key] == ref["fisheye"][key]
        for key in ("R_02", "R_03"):
            np.testing.assert_array_equal(ours["fisheye"][key], ref["fisheye"][key])


@pytest.mark.parametrize("layout", ["release", "flow"])
@pytest.mark.parametrize("rotation", [(0, -15), (3, 10)])
def test_load_calibs_matches_jax(kitti_root, flow_root, layout, rotation):
    from scenedino_tpu.datasets.kitti_360 import load_calibs as jload_calibs

    root = kitti_root if layout == "release" else flow_root
    ours, ref = K.load_calibs(root, rotation, fisheye=True), jload_calibs(root, rotation)
    _assert_calibs_equal(ours, ref)
    assert ours["fisheye"]["calib_02"]["mirror_parameters"]["xi"] == 2.213404750785489
    if layout == "release":
        assert ours["fisheye"]["calib_02"]["model_type"] == "MEI"


def test_perspective_calibs_need_no_fisheye_files(kitti_root, tmp_path):
    """An SSCBench tree has no fisheye YAMLs: load_calibs without `fisheye`
    reads the perspective files only, with the same results."""
    from scenedino_tpu.datasets.kitti_360 import load_calibs as jload_calibs

    shutil.copytree(kitti_root / "calibration", tmp_path / "calibration")
    for cam in ("02", "03"):
        (tmp_path / "calibration" / f"image_{cam}.yaml").unlink()
    ours = K.load_calibs(tmp_path)
    assert "fisheye" not in ours
    _assert_calibs_equal(ours, jload_calibs(kitti_root), fisheye=False)
    with pytest.raises(FileNotFoundError):
        K.load_calibs(tmp_path, fisheye=True)


def test_fisheye_sampler_matches_jax(kitti_root):
    from scenedino_tpu.datasets.kitti_360 import FisheyeToPinholeSampler as JSampler

    calibs = K.load_calibs(kitti_root, fisheye=True)
    rng = np.random.default_rng(0)
    img = rng.random((*RAW_F, 3), dtype=np.float32)
    for cam in ("02", "03"):
        args = (calibs["K_fisheye"], TGT, calibs["fisheye"][f"calib_{cam}"], calibs["fisheye"][f"R_{cam}"])
        ours, ref = K.FisheyeToPinholeSampler(*args), JSampler(*copy.deepcopy(args))
        np.testing.assert_allclose(ours.sample_pts, ref.sample_pts, rtol=0, atol=1e-6)
        np.testing.assert_allclose(ours.resample(img), ref.resample(img), rtol=0, atol=1e-6)
        # the warp reaches into the fisheye image and out of it (zeros)
        inside = (np.abs(ours.sample_pts) < 1).all(-1)
        assert 0.2 < inside.mean() <= 1.0


def test_frustum_overlap_matches_jax():
    from scenedino_tpu.datasets.kitti_360 import estimate_frustum_overlap as jestimate

    rng = np.random.default_rng(1)
    Kp = np.array([[0.9, 0, 0.01], [0, 2.8, -0.02], [0, 0, 1.0]], np.float32)
    values = []
    for _ in range(20):
        poses = []
        for _ in range(2):
            a = rng.uniform(-0.5, 0.5)
            P = np.eye(4)
            P[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
            P[:3, 3] = rng.uniform(-15, 15, 3)
            poses.append(P.astype(np.float32))
        ours = K.estimate_frustum_overlap(Kp, poses[0], Kp, poses[1])
        assert ours == jestimate(Kp, poses[0], Kp, poses[1])
        values.append(ours)
    assert min(values) < 0.5 < max(values)


def test_color_aug_matches_jax():
    from scenedino_tpu.datasets.kitti_360 import sample_color_aug_fn as jsample

    img = np.random.default_rng(2).random((16, 24, 3), dtype=np.float32)
    img[0, 0] = img[0, 0, 0]  # a grey pixel: hue 0, saturation 0
    for seed in range(6):
        ours = K.sample_color_aug_fn(np.random.RandomState(seed))(img)
        ref = jsample(np.random.RandomState(seed))(img)
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
        assert np.abs(ours - img).max() > 1e-3


def test_occupancy_grid_points_are_the_references():
    from scenedino_tpu.core.point_sampling import kitti_occupancy_grid_points as jgrid
    from scenedino_tpu.core.point_sampling import regular_grid as jregular

    from scenedino_torch.core.point_sampling import kitti_occupancy_grid_points, regular_grid

    ours = kitti_occupancy_grid_points()
    assert ours.shape == (256, 64, 256, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jgrid())
    np.testing.assert_array_equal(regular_grid((0, 1), (2, -1), (5, 3), 3, 4, 5),
                                  jregular((0, 1), (2, -1), (5, 3), 3, 4, 5))


# -------------------------------------------------------------- the items
OFFSETS_CASES = {
    "stereo-fisheye-depth-segs-boxes-aug": dict(fisheye_offset=(2, 3), stereo_offset=(0, 1), return_depth=True,
                                                return_segmentation=True, return_3d_bboxes=True, color_aug=True),
    "window-3-dilation-2-no-fisheye": dict(frame_count=3, dilation=2, keyframe_offset=1, return_fisheye=False,
                                           return_depth=True, fisheye_offset=1),
    "rotation-single-offset": dict(fisheye_rotation=(2, -10), fisheye_offset=4, return_stereo=False,
                                   return_segmentation=True),
}


@pytest.mark.parametrize("case", list(OFFSETS_CASES))
def test_offsets_items_match_jax(kitti_root, case):
    ours, ref = _datasets(kitti_root, **OFFSETS_CASES[case])
    assert ours._datapoints == ref._datapoints and len(ours) == len(ref) > 0
    for index in range(len(ref)):
        a, b = _items(ours, ref, index, seed=100 + index)
        assert_items_equal(a, b)
    a = ours[0]
    fc = ours.frame_count
    V = 4 * fc if ours.return_fisheye else 2 * fc
    assert a["imgs"].shape == (V, 3, *TGT) and a["poses"].shape == (V, 4, 4) and a["projs"].shape == (V, 3, 3)
    assert -1.0 <= a["imgs"].min() and a["imgs"].max() <= 1.0
    if ours.return_depth:
        assert a["depths"].shape == (1, 1, *TGT) and (a["depths"] > 0).sum() > 10
    if ours.return_segmentation:
        assert a["segs"].shape == (1, *TGT) and a["segs"].dtype == np.int64 and a["segs"].max() >= 19
    if ours.return_3d_bboxes:
        assert {b["semanticId"] for b in a["3d_bboxes"][0]} >= {26}


def test_right_datapoint_swaps_the_cameras(kitti_root):
    ours, _ = _datasets(kitti_root, fisheye_offset=2)
    left, right = ours[0], ours[1]
    assert ours._datapoints[0][2] is False and ours._datapoints[1][2] is True
    np.testing.assert_array_equal(left["imgs"][:2], right["imgs"][2:4])
    np.testing.assert_array_equal(left["imgs"][4:6], right["imgs"][6:8])
    np.testing.assert_array_equal(left["poses"][2:4], right["poses"][:2])


@pytest.mark.parametrize("frame_count,ranges", [(6, None), (4, {"00": (1, 3), "02": (2, 5), "03": (-2, 2)})],
                         ids=["default-ranges", "flat-ranges"])
def test_overlap_items_match_jax(kitti_root, frame_count, ranges):
    kw = dict(frame_count=frame_count, frame_sampling_strategy="overlap", overlap_min_ratio=0.05,
              overlap_max_samples=64, overlap_ranges=ranges, return_depth=True, return_segmentation=True,
              return_3d_bboxes=True, color_aug=True)
    ours, ref = _datasets(kitti_root, **kw)
    assert ours._datapoints == ref._datapoints and len(ours) == 2 * (N_FRAMES - 1)
    for index in range(0, len(ref), 3):
        a, b = _items(ours, ref, index, seed=200 + index)
        assert_items_equal(a, b)
        assert a["imgs"].shape == (frame_count, 3, *TGT)
        assert int(a["ts"][0]) == ours._datapoints[index][1]


def test_overlap_quirks_are_kept(kitti_root):
    """Two behaviours of the JAX loader that the port keeps
    (ADVICE.md:3-5): an odd frame_count gives frame_count - 1 frames when
    every candidate is rejected (the sampler adds base/target pairs, and
    the budget waiver cannot fill one slot), and `overlap_ranges` is one flat
    mapping whatever the base camera: with only cameras 00 and 02 in it, an
    item whose coin picked base camera 01 still draws camera 00 frames."""
    kw = dict(frame_sampling_strategy="overlap", overlap_max_samples=32)
    ours, ref = _datasets(kitti_root, frame_count=5, overlap_min_ratio=2.0, **kw)
    for seed in range(3):
        a, b = _items(ours, ref, 2, seed=seed)
        assert a["imgs"].shape[0] == b["imgs"].shape[0] == 4
        assert_items_equal(a, b)
    kw["overlap_min_ratio"] = 0.0
    ours, ref = _datasets(kitti_root, frame_count=8, overlap_ranges={"00": (1, 4), "02": (1, 4)}, **kw)
    cams = []
    for seed in range(6):
        rng = np.random.RandomState(seed)
        samples = ours._overlap_samples(SEQ, 3, N_FRAMES, rng)
        assert samples == ref._overlap_samples(SEQ, 3, N_FRAMES, np.random.RandomState(seed))
        cams.append((samples[0][0], {c for c, _ in samples[2:]}))
    assert any(base == "01" and "00" in drawn for base, drawn in cams), cams


def test_thread_streams_differ_and_are_seeded(kitti_root):
    """Each loading thread draws from its own stream, seeded from (seed,
    thread id) as in the JAX loader."""
    import threading

    ours, _ = _datasets(kitti_root, fisheye_offset=(2, 3, 4, 5), seed=3)
    first = ours._rng.randint(1 << 30)
    other = []
    t = threading.Thread(target=lambda: other.append(ours._rng))
    t.start()
    t.join()
    assert other[0] is not ours._rng
    ident = threading.get_ident() % (2 ** 31)
    expect = np.random.RandomState(np.random.SeedSequence([3, ident]).generate_state(1)[0]).randint(1 << 30)
    assert first == expect


def test_preprocessed_items_read_the_cache(kitti_root, tmp_path):
    """is_preprocessed: the views come from data_<H>x<W>[_<r0>x<r1>] and are
    not resampled again; the two packages read the same cache the same."""
    root = tmp_path / "kitti"
    shutil.copytree(kitti_root, root)
    rng = np.random.default_rng(4)
    raw = root / "data_2d_raw" / SEQ
    for cam, folder in (("00", "data_32x64"), ("01", "data_32x64"), ("02", "data_32x64_0x-15"),
                        ("03", "data_32x64_0x-15")):
        (raw / f"image_{cam}" / folder).mkdir()
        for i in range(N_FRAMES):
            image_io.write_png(raw / f"image_{cam}" / folder / f"{i:010d}.png",
                               rng.integers(0, 256, (*TGT, 3), dtype=np.uint8), filter_type=4)
    ours, ref = _datasets(root, fisheye_offset=(2, 3), is_preprocessed=True, color_aug=True)
    for index in (0, 3, 6):
        assert_items_equal(*_items(ours, ref, index, seed=index))
    ds, _ = _datasets(root, fisheye_offset=2, is_preprocessed=True)
    seq, fid, _ = ds._datapoints[0]
    cached = image_io.read_rgb(raw / "image_02" / "data_32x64_0x-15" / f"{fid + 2:010d}.png")
    np.testing.assert_allclose(ds[0]["imgs"][4], cached.transpose(2, 0, 1) * 2 - 1, rtol=0, atol=1e-6)


def test_cache_misses_the_last_frame_on_both_sides(kitti_root, tmp_path):
    """The resize cache holds every frame but the last (its dataset's
    _full_split stops one short), and an item whose fisheye window clamps
    to the last frame asks for it: both packages raise FileNotFoundError."""
    from scenedino_tpu.cli.preprocess_kitti_360 import main as jmain

    root = tmp_path / "kitti"
    shutil.copytree(kitti_root, root)
    jmain(["resize", "-d", str(root), "-r", *map(str, TGT)])
    cache = root / "data_2d_raw" / SEQ / "image_02" / "data_32x64_0x-15"
    assert sorted(int(p.stem) for p in cache.glob("*.png")) == list(range(N_FRAMES - 1))
    kw = dict(split_path=str(root / "splits" / "train_files.txt"), fisheye_offset=10, is_preprocessed=True)
    ours, ref = _datasets(root, **kw)
    assert ours._datapoints[0][1] + 10 + 1 > N_FRAMES - 1  # the window clamps to the last frame
    for ds in (ours, ref):
        with pytest.raises(FileNotFoundError):
            ds[0]


# ---------------------------------------------------------------- factories
@pytest.mark.parametrize("kind", ["old_KITTI_360", "KITTI_360", "KITTI_360_v2"])
def test_factories_match_jax(kitti_root, kind):
    from scenedino_tpu.datasets import make_datasets as jmake_datasets
    from scenedino_tpu.datasets import make_test_dataset as jmake_test_dataset

    config = {"type": kind, "data_path": str(kitti_root), "pose_path": str(kitti_root / "data_poses"),
              "split_path": str(kitti_root / "splits"), "image_size": list(TGT), "data_fc": 2,
              "data_segmentation": True, "fisheye_rotation": [0, -15], "fisheye_offset": [2, 3], "color_aug": True}
    fields = ("frame_sampling_strategy", "fisheye_offset", "stereo_offset", "return_depth", "color_aug",
              "return_segmentation", "is_preprocessed", "frame_count", "target_image_size", "split_path")
    (train, test), (jtrain, jtest) = make_datasets(config), jmake_datasets(config)
    td, jtd = make_test_dataset(config), jmake_test_dataset(config)
    for ours, ref in ((train, jtrain), (test, jtest), (td, jtd)):
        assert isinstance(ours, K.KITTI360Dataset)
        assert {f: getattr(ours, f) for f in fields} == {f: getattr(ref, f) for f in fields}
        assert ours._datapoints == ref._datapoints
    assert train.split_path.endswith("train_files.txt") and test.split_path.endswith("test_files.txt")
    assert len(train) == 3 and len(test) == 2 and td.split_path == test.split_path
    assert test.fisheye_offset == (10,) and not test.color_aug and test.return_depth and not train.return_depth
    assert td.fisheye_offset == (2, 3) and td.return_depth
    assert train.frame_sampling_strategy == ("overlap" if kind == "KITTI_360_v2" else "offsets")
    # no split: the full split; a file: read as it is; the test instance then has none
    train, test = make_datasets({**config, "split_path": str(kitti_root / "splits" / "test_files.txt")})
    assert len(train) == 2 and test.split_path is None
    assert make_test_dataset({**config, "split_path": None}).split_path is None
    assert make_test_dataset({k: v for k, v in config.items() if k != "fisheye_offset"}).fisheye_offset == (1,)


def test_factory_refusals(tmp_path):
    # RealEstate10K builds (its parity: tests/test_torch_re10k.py); an empty metadata pickle has no windows
    from scenedino_torch.datasets.re10k import RealEstate10kDataset

    (tmp_path / "train.pickle").write_bytes(pickle.dumps({}))
    train, test = make_datasets({"type": "re10k", "data_path": str(tmp_path / "train.pickle")})
    assert isinstance(train, RealEstate10kDataset) and test is train and len(train) == 0
    with pytest.raises(ValueError, match="unknown"):
        make_datasets({"type": "nope"})


# ----------------------------------------------------------------- boxes
def test_bboxes_parse_and_filter_match_jax(kitti_root):
    from scenedino_tpu.datasets import annotations as jann

    from scenedino_torch.datasets import annotations as ann

    xml = kitti_root / "data_3d_bboxes" / "train_full" / f"{SEQ}.xml"
    ours, ref = ann.load_3d_bboxes(xml), jann.load_3d_bboxes(xml)
    assert sorted(ours) == sorted(ref) == [-1, 1, 3]
    for t in ref:
        for a, b in zip(ours[t], ref[t], strict=True):
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            for k in ("vertices", "faces"):
                np.testing.assert_array_equal(da.pop(k), db.pop(k))
            assert da == db
    car = ours[-1][0]
    assert car.name == "car" and car.semantic_id == 26 and car.instance_id == 7
    assert ours[1][0].name == "pole" and ours[3][0].name == "traffic sign" and ours[3][0].instance_id == -1
    K_ = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    for img_id, n in ((0, 1), (1, 2), (3, 1)):
        vis = ann.get_3d_bboxes(ours, img_id, np.eye(4), K_)
        jvis = jann.get_3d_bboxes(ref, img_id, np.eye(4), K_)
        assert len(vis) == len(jvis) == n
        assert [(v["semanticId"], v["instanceId"]) for v in vis] == [(v["semanticId"], v["instanceId"]) for v in jvis]
    assert ann.load_sequence_bboxes(kitti_root, [SEQ])[SEQ].keys() == ours.keys()


# ------------------------------------------------------- SSCBench fisheyes
def test_sscbench_fisheye_items_match_jax(kitti_root, tmp_path):
    from scenedino_tpu.datasets.sscbench import SSCBenchDataset as JSSCBenchDataset

    from scenedino_torch.datasets.sscbench import SSCBenchDataset

    gt = tmp_path / "voxel_gt" / SEQ
    gt.mkdir(parents=True)
    rng = np.random.default_rng(6)
    for i in (2, 9):
        np.save(gt / f"{i:06d}_1_1.npy", rng.integers(0, 20, size=(256, 256, 32), dtype=np.uint8))
    kw = dict(data_path=str(kitti_root), voxel_gt_path=str(tmp_path / "voxel_gt"), sequences=(SEQ,),
              target_image_size=TGT, load_fisheye=True)
    for offset in (3, 10):
        ours, ref = SSCBenchDataset(fisheye_offset=offset, **kw), JSSCBenchDataset(fisheye_offset=offset, **kw)
        assert len(ours) == len(ref) == 2
        for i in range(2):
            a, b = ours[i], ref[i]
            assert a["imgs"].shape == (3, 3, *TGT)
            assert_items_equal(a, b)
    # without fisheyes the front view alone, as before
    front = SSCBenchDataset(**{**kw, "load_fisheye": False})[0]
    assert front["imgs"].shape == (1, 3, *TGT)
    np.testing.assert_array_equal(front["imgs"][0], ours[0]["imgs"][0])
