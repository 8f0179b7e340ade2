"""The KITTI-360 multi-view loader on the host (the port's
`scenedino_tpu/datasets/kitti_360.py`; reference
`scenedino/datasets/old_kitti_360.py`, the `old_KITTI_360` type of every
shipped config, and `kitti_360_v2.py` for the overlap sampling).

An item is two timesteps of the stereo perspective pair (cameras 00/01)
and of the two fisheye cameras (02/03), the fisheyes resampled to pinhole
views through the MEI model: 8 views, with camera-to-world poses from the
sequence's pose file, normalized (NDC) intrinsics, and optionally the
velodyne depth, the semantic labels and the 3D boxes of its first frame.

No PIL and no OpenCV: PNGs are read by `datasets.image_io.read_rgb` /
`read_png` and resized by `resize_bilinear` / `resize_nearest`, which
reproduce `cv2.INTER_LINEAR` and `cv2.INTER_NEAREST`. The fisheye YAMLs are
read by `utils.config.loads`. Random draws (the fisheye and stereo offsets,
the colour jitter, the overlap samples) come from a `np.random.RandomState`
of the loading thread, seeded from (seed, thread id), as in the JAX loader.
"""
from __future__ import annotations

import dataclasses
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from scenedino_torch.datasets.image_io import read_png, read_rgb, resize_bilinear, resize_nearest
from scenedino_torch.utils.config import loads


def grid_sample_np(img: np.ndarray, xy: np.ndarray, align_corners=True) -> np.ndarray:
    """Bilinear sampling of (H, W, C) at NDC coordinates xy (..., 2), zero
    outside: the numpy twin of torch's grid_sample that the fisheye
    resampler uses (old_kitti_360.py:77-82)."""
    H, W, C = img.shape
    x, y = xy[..., 0], xy[..., 1]
    if align_corners:
        xp = (x + 1) * 0.5 * (W - 1)
        yp = (y + 1) * 0.5 * (H - 1)
    else:
        xp = (x + 1) * 0.5 * W - 0.5
        yp = (y + 1) * 0.5 * H - 0.5
    x0 = np.floor(xp).astype(np.int64)
    y0 = np.floor(yp).astype(np.int64)
    wx = (xp - x0)[..., None]
    wy = (yp - y0)[..., None]

    def at(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        return img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)] * valid[..., None]

    return (at(y0, x0) * (1 - wx) * (1 - wy) + at(y0, x0 + 1) * wx * (1 - wy)
            + at(y0 + 1, x0) * (1 - wx) * wy + at(y0 + 1, x0 + 1) * wx * wy)


def sample_color_aug_fn(rng: np.random.RandomState):
    """One colour jitter for every view of an item, drawn from `rng`: the
    numpy twin of torchvision's ColorJitter.get_params and its functional
    adjustments (old_kitti_360.py:945-953): brightness, contrast and
    saturation factors in [0.8, 1.2], a hue shift in [-0.1, 0.1], applied
    in a random order to float RGB in [0, 1] (H, W, 3)."""
    order = rng.permutation(4)
    b = rng.uniform(0.8, 1.2)
    c = rng.uniform(0.8, 1.2)
    s = rng.uniform(0.8, 1.2)
    h = rng.uniform(-0.1, 0.1)

    def gray(img):  # Rec. 601 luma, as torchvision's rgb_to_grayscale
        return img @ np.array([0.299, 0.587, 0.114], img.dtype)

    def adjust_hue(img, factor):
        r, g_, b_ = img[..., 0], img[..., 1], img[..., 2]
        maxc = img.max(-1)
        minc = img.min(-1)
        v = maxc
        d = maxc - minc
        sat = np.where(maxc > 0, d / np.maximum(maxc, 1e-12), 0.0)
        dn = np.maximum(d, 1e-12)
        rc, gc, bc = (maxc - r) / dn, (maxc - g_) / dn, (maxc - b_) / dn
        hue = np.where(maxc == r, bc - gc, np.where(maxc == g_, 2.0 + rc - bc, 4.0 + gc - rc))
        hue = (hue / 6.0) % 1.0
        hue = np.where(d == 0, 0.0, hue)
        hue = (hue + factor) % 1.0
        i = np.floor(hue * 6.0)
        f = hue * 6.0 - i
        p = v * (1.0 - sat)
        q = v * (1.0 - sat * f)
        t = v * (1.0 - sat * (1.0 - f))
        i = (i.astype(np.int64) % 6)[..., None]
        return np.select(
            [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
            [np.stack([v, t, p], -1), np.stack([q, v, p], -1), np.stack([p, v, t], -1),
             np.stack([p, q, v], -1), np.stack([t, p, v], -1), np.stack([v, p, q], -1)],
        )

    def fn(img):
        img = np.asarray(img, np.float32)
        for fid in order:
            if fid == 0:
                img = np.clip(img * b, 0.0, 1.0)
            elif fid == 1:
                img = np.clip(c * img + (1.0 - c) * gray(img).mean(), 0.0, 1.0)
            elif fid == 2:
                img = np.clip(s * img + (1.0 - s) * gray(img)[..., None], 0.0, 1.0)
            else:
                img = np.clip(adjust_hue(img, h), 0.0, 1.0)
        return img.astype(np.float32)

    return fn


class FisheyeToPinholeSampler:
    """The MEI model's warp from a pinhole view to the fisheye image,
    precomputed in float64 (old_kitti_360.py:24-82): `sample_pts` (H, W, 2)
    are the fisheye NDC coordinates of each pixel of the normalized pinhole
    `k_target` at `target_image_size`, after `rotation`."""

    def __init__(self, k_target, target_image_size, calib, rotation=None):
        H, W = target_image_size
        x = np.linspace(-1, 1, W, dtype=np.float64)[None, :].repeat(H, 0)
        y = np.linspace(-1, 1, H, dtype=np.float64)[:, None].repeat(W, 1)
        xyz = np.stack([x, y, np.ones_like(x)], -1).reshape(-1, 3)
        xyz = (np.linalg.inv(np.asarray(k_target, np.float64)) @ xyz.T).T
        if rotation is not None:
            xyz = (np.asarray(rotation, np.float64) @ xyz.T).T
        xyz = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
        xs, ys, zs = xyz[:, 0], xyz[:, 1], xyz[:, 2]

        xi = calib["mirror_parameters"]["xi"]
        xs = xs / (zs + xi)
        ys = ys / (zs + xi)
        k1 = calib["distortion_parameters"]["k1"]
        k2 = calib["distortion_parameters"]["k2"]
        r = xs * xs + ys * ys
        factor = 1 + k1 * r + k2 * r * r
        xs = xs * factor
        ys = ys * factor
        p = calib["projection_parameters"]
        xs = xs * p["gamma1"] + p["u0"]
        ys = ys * p["gamma2"] + p["v0"]
        self.sample_pts = np.stack([xs, ys], -1).reshape(H, W, 2).astype(np.float32)

    def resample(self, img: np.ndarray) -> np.ndarray:
        """A fisheye image (H_f, W_f, 3) as the pinhole view (H, W, 3)."""
        return grid_sample_np(img, self.sample_pts, align_corners=True)


def estimate_frustum_overlap(proj_src, pose_src, proj_tgt, pose_tgt, z_range=(3.0, 40.0), res=(8, 8, 16)):
    """The share of a (w x h x d) grid of points in the source frustum that
    projects into the target's (the reference's overlap heuristic,
    scenedino/common/geometry.py:161-208, estimate_frustum_overlap_2; the
    KITTI_360_v2 sampling's test). Poses are camera-to-world, projections
    normalized. Kept as the reference has it: the depth test is |z| > z_near,
    which also admits points behind the target camera."""
    w, h, d = res
    pw, ph = 2.0 / w, 2.0 / h
    x = np.linspace(-1 + 0.5 * pw, 1 - 0.5 * pw, w)
    y = np.linspace(-1 + 0.5 * ph, 1 - 0.5 * ph, h)
    z = np.linspace(z_range[0], z_range[1], d)
    X, Y = np.meshgrid(x, y)
    dirs = np.stack([X, Y, np.ones_like(X)], -1).reshape(-1, 3)
    dirs = dirs @ np.linalg.inv(np.asarray(proj_src, np.float64)).T
    pts = (dirs[None, :, :] * z[:, None, None]).reshape(-1, 3)
    src2tgt = np.linalg.inv(np.asarray(pose_tgt, np.float64)) @ np.asarray(pose_src, np.float64)
    pts = pts @ src2tgt[:3, :3].T + src2tgt[:3, 3]
    uvz = pts @ np.asarray(proj_tgt, np.float64).T
    zc = uvz[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = uvz[:, 0] / zc
        v = uvz[:, 1] / zc
    valid = (np.abs(u) < 1) & (np.abs(v) < 1) & (np.abs(zc) > z_range[0])
    return float(np.mean(valid))


def _read_kv(path) -> Dict[str, np.ndarray]:
    """"key: floats" lines; lines whose value is not numbers are skipped."""
    out = {}
    with open(path) as f:
        for line in f.readlines():
            key, value = line.split(":", 1)
            try:
                out[key] = np.array([float(v) for v in value.split()], np.float32)
            except ValueError:
                pass
    return out


def read_fisheye_calib(path) -> dict:
    """A fisheye camera's MEI calibration (image_02.yaml, image_03.yaml):
    the first line (`%YAML:1.0`) is skipped as the reference skips it, the
    rest read as YAML; the release writes it as OpenCV's FileStorage does,
    with a `---` line before the mapping, which starts the one document."""
    with open(path) as f:
        f.readline()
        text = f.read()
    lines = text.splitlines()
    first = next((i for i, line in enumerate(lines) if line.strip() and not line.lstrip().startswith("#")), None)
    if first is not None and lines[first].rstrip() == "---":
        del lines[first]
    return loads("\n".join(lines), str(path))


def load_calibs(data_path, fisheye_rotation=(0, -15), fisheye: bool = False) -> Dict:
    """Parse and normalize the KITTI-360 calibration under
    `<data_path>/calibration` (old_kitti_360.py:388-573): calib_cam_to_pose.txt,
    calib_cam_to_velo.txt, perspective.txt, and with `fisheye` the MEI
    models image_02.yaml and image_03.yaml. Returns the normalized
    perspective intrinsics ("K_perspective", also "K_fisheye" as in the
    reference), the camera-to-pose transforms of cameras 00-03
    ("T_cam_to_pose"; the fisheyes' with their rotation `fisheye_rotation`),
    the velodyne transforms, the rectified image size ("im_size", (H, W)),
    and with `fisheye` "fisheye": the two calibrations with their
    projection parameters normalized to NDC, and the rotations R_02, R_03.
    Without `fisheye` the YAMLs are not read (an SSCBench tree has none)."""
    from scipy.spatial.transform import Rotation

    calib = Path(data_path) / "calibration"
    cam_to_pose = _read_kv(calib / "calib_cam_to_pose.txt")
    with open(calib / "calib_cam_to_velo.txt") as f:
        cam_to_velo = np.array([float(v) for v in f.readline().split()], np.float32)
    intr = _read_kv(calib / "perspective.txt")

    im_size_rect = (int(intr["S_rect_00"][1]), int(intr["S_rect_00"][0]))
    P_rect_00 = intr["P_rect_00"].reshape(3, 4)
    R_rect_00 = np.eye(4, dtype=np.float32)
    R_rect_01 = np.eye(4, dtype=np.float32)
    R_rect_00[:3, :3] = intr["R_rect_00"].reshape(3, 3)
    R_rect_01[:3, :3] = intr["R_rect_01"].reshape(3, 3)

    rot = np.array(fisheye_rotation, np.float32).reshape(1, 2)
    R_02 = np.eye(4, dtype=np.float32)
    R_03 = np.eye(4, dtype=np.float32)
    R_02[:3, :3] = Rotation.from_euler("xy", rot[:, [1, 0]], degrees=True).as_matrix().astype(np.float32)
    R_03[:3, :3] = Rotation.from_euler("xy", rot[:, [1, 0]] * np.array([[1, -1]]),
                                       degrees=True).as_matrix().astype(np.float32)

    def T_of(key):
        T = np.eye(4, dtype=np.float32)
        T[:3, :] = cam_to_pose[key].reshape(3, 4)
        return T

    T_00, T_01, T_02, T_03 = T_of("image_00"), T_of("image_01"), T_of("image_02"), T_of("image_03")
    T_00_velo = np.eye(4, dtype=np.float32)
    T_00_velo[:3, :] = cam_to_velo.reshape(3, 4)

    T_rect_00_to_pose = T_00 @ np.linalg.inv(R_rect_00)
    T_rect_01_to_pose = T_01 @ np.linalg.inv(R_rect_01)
    T_velo_to_rect_00 = R_rect_00 @ np.linalg.inv(T_00_velo)
    T_velo_to_pose = T_rect_00_to_pose @ T_velo_to_rect_00
    T_velo_to_rect_01 = np.linalg.inv(T_rect_01_to_pose) @ T_velo_to_pose

    K = P_rect_00[:3, :3].copy()
    K[0, 0] = K[0, 0] / im_size_rect[1] * 2.0
    K[1, 1] = K[1, 1] / im_size_rect[0] * 2.0
    K[0, 2] = K[0, 2] / im_size_rect[1] * 2.0 - 1
    K[1, 2] = K[1, 2] / im_size_rect[0] * 2.0 - 1

    out = {
        "K_perspective": K,
        "K_fisheye": K,
        "T_cam_to_pose": {"00": T_rect_00_to_pose, "01": T_rect_01_to_pose, "02": T_02 @ R_02,
                          "03": T_03 @ R_03},
        "T_velo_to_cam": {"00": T_velo_to_rect_00, "01": T_velo_to_rect_01},
        "T_velo_to_pose": T_velo_to_pose,
        "im_size": im_size_rect,
    }
    if fisheye:
        fish02 = read_fisheye_calib(calib / "image_02.yaml")
        fish03 = read_fisheye_calib(calib / "image_03.yaml")
        im_size_fish = (fish02["image_height"], fish02["image_width"])
        for fd in (fish02, fish03):
            p = fd["projection_parameters"]
            p["gamma1"] = p["gamma1"] / im_size_fish[1] * 2.0
            p["gamma2"] = p["gamma2"] / im_size_fish[0] * 2.0
            p["u0"] = p["u0"] / im_size_fish[1] * 2.0 - 1.0
            p["v0"] = p["v0"] / im_size_fish[0] * 2.0 - 1.0
        out["fisheye"] = {"calib_02": fish02, "calib_03": fish03, "R_02": R_02[:3, :3], "R_03": R_03[:3, :3]}
    return out


def load_poses(pose_path, sequences):
    """Per sequence (image ids, poses (N, 4, 4) system -> world) from
    `<pose_path>/<sequence>/poses.txt` (old_kitti_360.py:590-611)."""
    ids, poses = {}, {}
    for seq in sequences:
        data = np.loadtxt(Path(pose_path) / seq / "poses.txt")
        ids[seq] = data[:, 0].astype(int)
        p = data[:, 1:].astype(np.float32).reshape(-1, 3, 4)
        p = np.concatenate([p, np.zeros_like(p[:, :1])], axis=1)
        p[:, 3, 3] = 1
        poses[seq] = p
    return ids, poses


@dataclasses.dataclass
class KITTI360Dataset:
    """The 8-view KITTI-360 item (old_kitti_360.py:86-1080).

    __getitem__ -> {"imgs" (V, 3, H, W) in [-1, 1], "projs" (V, 3, 3),
    "poses" (V, 4, 4) camera -> world, "ts" (V,), "index" (1,)}, and with
    the options "depths" (1, 1, H, W) velodyne depth of the first view
    (0 where no point), "segs" (1, H, W) the semantic ids of its frame (the
    PNG's ids, unmapped, as the JAX loader returns them), "3d_bboxes" [the
    frame's boxes]. Under "offsets" (the shipped layout) V is
    [perspective left x frame_count, right x frame_count, fisheye left x
    frame_count, right x frame_count], left and right swapped for an "r"
    datapoint; every view has the perspective intrinsics. Under "overlap"
    (KITTI_360_v2) it is frame_count frames of mixed cameras picked by
    their frustum overlap with the encoder's camera.

    Kept as the JAX loader has them: an odd frame_count under "overlap"
    gives frame_count - 1 frames (pairs are added whole); `overlap_ranges`
    is one mapping of camera -> offset range, whatever the base camera.
    """

    data_path: str
    pose_path: str
    split_path: Optional[str] = None
    target_image_size: Tuple[int, int] = (192, 640)
    return_stereo: bool = True
    return_depth: bool = False
    return_fisheye: bool = True
    return_segmentation: bool = False
    frame_count: int = 2
    keyframe_offset: int = 0
    dilation: int = 1
    fisheye_rotation: Tuple[int, int] = (0, -15)
    fisheye_offset: Sequence[int] = (10,)
    # the reference's class default, which its factory never overrides (the
    # kwarg is commented out there): every shipped run trains with 0
    stereo_offset: Sequence[int] = (0,)
    color_aug: bool = False
    return_3d_bboxes: bool = False
    # read the preprocess CLI's cache (data_<H>x<W>[_<r0>x<r1>] directories,
    # cli/preprocess_kitti_360.py) instead of resampling the raw frames
    is_preprocessed: bool = False
    # "offsets" (old_KITTI_360, KITTI_360) or "overlap" (KITTI_360_v2)
    frame_sampling_strategy: str = "offsets"
    overlap_min_ratio: float = 0.4
    overlap_max_samples: int = 128
    overlap_ranges: Optional[Dict] = None
    seed: int = 0

    def __post_init__(self):
        if isinstance(self.fisheye_rotation, (int, float)):
            self.fisheye_rotation = (0, self.fisheye_rotation)
        self.fisheye_rotation = tuple(self.fisheye_rotation)
        if isinstance(self.fisheye_offset, int):
            self.fisheye_offset = (self.fisheye_offset,)
        self.fisheye_offset = tuple(sorted(self.fisheye_offset))
        if isinstance(self.stereo_offset, int):
            self.stereo_offset = (self.stereo_offset,)
        self.stereo_offset = tuple(sorted(self.stereo_offset))
        self.random_fisheye_offset = len(self.fisheye_offset) > 1
        self.random_stereo_offset = len(self.stereo_offset) > 1

        # each loading thread draws from its own RandomState (np.random's is not
        # thread-safe), seeded from (seed, thread id) on first use
        self._rng_local = threading.local()
        self._sequences = sorted(p.name for p in (Path(self.data_path) / "data_2d_raw").iterdir() if p.is_dir())
        self._calibs = load_calibs(self.data_path, self.fisheye_rotation, fisheye=True)
        fish = self._calibs["fisheye"]
        self._resampler_02 = FisheyeToPinholeSampler(self._calibs["K_fisheye"], self.target_image_size,
                                                     fish["calib_02"], fish["R_02"])
        self._resampler_03 = FisheyeToPinholeSampler(self._calibs["K_fisheye"], self.target_image_size,
                                                     fish["calib_03"], fish["R_03"])
        self._img_ids, self._poses = load_poses(self.pose_path, self._sequences)
        self._left_offset = ((self.frame_count - 1) // 2 + self.keyframe_offset) * self.dilation
        if self.is_preprocessed:
            H, W = self.target_image_size
            r0, r1 = self.fisheye_rotation
            self._perspective_folder = f"data_{H}x{W}"
            self._fisheye_folder = f"data_{H}x{W}_{r0}x{r1}"
        else:
            self._perspective_folder = "data_rect"
            self._fisheye_folder = "data_rgb"
        self._datapoints = self._load_split(self.split_path) if self.split_path is not None else self._full_split()
        self.length = len(self._datapoints)
        self._3d_bboxes = None
        if self.return_3d_bboxes:
            from scenedino_torch.datasets.annotations import load_sequence_bboxes

            self._3d_bboxes = load_sequence_bboxes(self.data_path, self._sequences)

    @staticmethod
    def _load_split(split_path):
        """(sequence, index, is_right) of each "<sequence> <index> <l|r>" line."""
        with open(split_path) as f:
            lines = f.readlines()

        def parse(line):
            seq, id_, is_right = line.split(" ")
            return seq, int(id_), is_right.strip() == "r"

        return [parse(line) for line in lines if line.strip()]

    def _full_split(self):
        dps = []
        for seq in self._sequences:
            if self.frame_sampling_strategy == "overlap":
                # the overlap sampler clamps every id to the sequence: only the
                # encoder frame's +-1 neighbour needs a margin
                n = len(self._img_ids[seq]) - 1
            else:
                n = len(self._img_ids[seq]) - self.frame_count * self.dilation - max(self.fisheye_offset)
            for i in range(max(n, 0)):
                dps.append((seq, i, False))
                if self.return_stereo:
                    dps.append((seq, i, True))
        return dps

    def _overlap_samples(self, seq, id, seq_len, rng):
        """(camera, index) frames of the KITTI_360_v2 sampling
        (kitti_360_v2.py:42-141, 267-290): a coin picks the base camera
        (00/01); the encoder frame and its +-1 neighbour come first; then
        random (camera, offset) candidates from each camera's range, each
        kept with its +-1 neighbour as a pair when its frustum overlap with
        the encoder camera reaches overlap_min_ratio, until frame_count
        frames are collected (the test is waived when the draws left get
        few, as in the reference)."""
        T = self._calibs["T_cam_to_pose"]
        Kp = self._calibs["K_perspective"]
        Kf = self._calibs["K_fisheye"]
        poses = self._poses[seq]

        def clamp(i):
            return max(min(i, seq_len - 1), 0)

        base_cam = "00" if rng.rand() < 0.5 else "01"
        # the reference's ranges_00/_01 (kitti_360_v2.py:59-71)
        ranges = dict(self.overlap_ranges or {base_cam: (-10, 20), "02": (10, 50), "03": (10, 50)})
        enc_pose = poses[id] @ T[base_cam]
        samples = [(base_cam, id), (base_cam, clamp(id + (1 if rng.rand() > 0.5 else -1)))]
        cams = sorted(ranges)
        for i in range(self.overlap_max_samples):
            if len(samples) >= self.frame_count:
                break
            c = cams[rng.randint(len(cams))]
            lo, hi = ranges[c]
            base_id = clamp(id + int(rng.randint(lo, hi)))
            tgt_id = clamp(base_id + (1 if rng.rand() >= 0.5 else -1))
            K_c = Kp if c in ("00", "01") else Kf
            overlap = estimate_frustum_overlap(K_c, poses[base_id] @ T[c], Kp, enc_pose)
            budget_tight = (self.overlap_max_samples - i) * 2 <= self.frame_count - len(samples)
            if overlap < self.overlap_min_ratio and not budget_tight:
                continue
            samples += [(c, base_id), (c, tgt_id)]
        return [(c, clamp(i)) for c, i in samples[:self.frame_count]]

    def _frame_ids(self, id, seq_len, stereo_offset, fisheye_offset):
        """The perspective and fisheye timesteps (old_kitti_360.py:914-938),
        clamped to the sequence."""
        id_st = id + stereo_offset
        window = range(id_st - self._left_offset, id_st - self._left_offset + self.frame_count * self.dilation,
                       self.dilation)
        ids = [id] + [max(min(i, seq_len - 1), 0) for i in window if i != id_st]
        idf = id + fisheye_offset
        window = range(idf - self._left_offset, idf - self._left_offset + self.frame_count * self.dilation,
                       self.dilation)
        ids_fish = [max(min(idf, seq_len - 1), 0)] + [max(min(i, seq_len - 1), 0) for i in window if i != idf]
        return ids, ids_fish

    def _img_path(self, seq, cam, img_id):
        folder = self._perspective_folder if cam in ("00", "01") else self._fisheye_folder
        return Path(self.data_path) / "data_2d_raw" / seq / f"image_{cam}" / folder / f"{img_id:010d}.png"

    def _load_and_process(self, seq, cam, img_id, resampler=None, color_aug_fn=None):
        """One view as (3, H, W) in [-1, 1]: a fisheye resampled to the
        pinhole view (not when read from the cache, which holds it so), else
        resized as cv2.INTER_LINEAR; the colour jitter in [0, 1]."""
        img = read_rgb(self._img_path(seq, cam, img_id))
        if self.is_preprocessed:
            resampler = None
        if resampler is not None:
            img = resampler.resample(img)
        elif img.shape[:2] != tuple(self.target_image_size):
            img = resize_bilinear(img, self.target_image_size)
        if color_aug_fn is not None:
            img = color_aug_fn(img)
        img = img * 2.0 - 1.0
        return img.transpose(2, 0, 1).astype(np.float32)

    def load_depth(self, seq, img_id, is_right):
        """The velodyne scan of the frame as a sparse depth map (1, H, W) of
        the left (or right) rectified camera, the nearest point per pixel
        (old_kitti_360.py:820-877)."""
        cam = "01" if is_right else "00"
        points = np.fromfile(
            Path(self.data_path) / "data_3d_raw" / seq / "velodyne_points" / "data" / f"{img_id:010d}.bin",
            dtype=np.float32,
        ).reshape(-1, 4)
        points[:, 3] = 1.0
        cam_pts = (self._calibs["T_velo_to_cam"][cam] @ points.T).T
        K = self._calibs["K_perspective"]
        H, W = self.target_image_size
        z = cam_pts[:, 2]
        good = z > 1e-3
        x = cam_pts[:, 0] / np.maximum(z, 1e-3) * K[0, 0] + K[0, 2]
        y = cam_pts[:, 1] / np.maximum(z, 1e-3) * K[1, 1] + K[1, 2]
        xi = np.round((x * 0.5 + 0.5) * W - 0.5).astype(int)
        yi = np.round((y * 0.5 + 0.5) * H - 0.5).astype(int)
        good &= (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        depth = np.zeros((1, H, W), np.float32)
        order = np.argsort(-z[good])  # the nearest point is written last
        depth[0, yi[good][order], xi[good][order]] = z[good][order]
        return depth

    def load_segmentation(self, seq, img_id):
        """The frame's semantic ids (1, H, W) int64 from
        data_2d_semantics/train/<seq>/image_00/semantic/<id>.png, resized as
        cv2.INTER_NEAREST."""
        p = (Path(self.data_path) / "data_2d_semantics" / "train" / seq / "image_00" / "semantic"
             / f"{img_id:010d}.png")
        seg = read_png(p).astype(np.int64)
        return resize_nearest(seg.astype(np.int32), self.target_image_size).astype(np.int64)[None]

    def __len__(self):
        return self.length

    def get_points(self, pose: np.ndarray | None = None) -> np.ndarray:
        """The occupancy probe grid (old_kitti_360.py:236-273), (256, 64, 256,
        3) camera-frame points; `pose` is ignored, as in the reference."""
        from scenedino_torch.core.point_sampling import kitti_occupancy_grid_points

        return kitti_occupancy_grid_points()

    @property
    def _rng(self) -> np.random.RandomState:
        rng = getattr(self._rng_local, "rng", None)
        if rng is None:
            rng = np.random.RandomState(
                np.random.SeedSequence([self.seed, threading.get_ident() % (2**31)]).generate_state(1)[0])
            self._rng_local.rng = rng
        return rng

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        seq, id, is_right = self._datapoints[index]
        seq_len = len(self._img_ids[seq])
        if self.frame_sampling_strategy == "overlap":
            return self._getitem_overlap(index, seq, id, seq_len)

        fisheye_offset = (self.fisheye_offset[self._rng.randint(len(self.fisheye_offset))]
                          if self.random_fisheye_offset else self.fisheye_offset[-1])
        stereo_offset = (self.stereo_offset[self._rng.randint(len(self.stereo_offset))]
                         if self.random_stereo_offset else self.stereo_offset[-1])
        ids, ids_fish = self._frame_ids(id, seq_len, stereo_offset, fisheye_offset)
        img_ids = [int(self._img_ids[seq][i]) for i in ids]
        img_ids_fish = [int(self._img_ids[seq][i]) for i in ids_fish]
        if not self.return_fisheye:
            ids_fish, img_ids_fish = [], []

        aug = sample_color_aug_fn(self._rng) if self.color_aug else None
        imgs_p_left = [self._load_and_process(seq, "00", i, color_aug_fn=aug) for i in img_ids]
        imgs_p_right = [self._load_and_process(seq, "01", i, color_aug_fn=aug) for i in img_ids]
        imgs_f_left = [self._load_and_process(seq, "02", i, self._resampler_02, aug) for i in img_ids_fish]
        imgs_f_right = [self._load_and_process(seq, "03", i, self._resampler_03, aug) for i in img_ids_fish]

        T = self._calibs["T_cam_to_pose"]
        poses_p_left = [self._poses[seq][i] @ T["00"] for i in ids]
        poses_p_right = [self._poses[seq][i] @ T["01"] for i in ids]
        poses_f_left = [self._poses[seq][i] @ T["02"] for i in ids_fish]
        poses_f_right = [self._poses[seq][i] @ T["03"] for i in ids_fish]

        K = self._calibs["K_perspective"]
        if not is_right:
            imgs = imgs_p_left + imgs_p_right + imgs_f_left + imgs_f_right
            poses = poses_p_left + poses_p_right + poses_f_left + poses_f_right
        else:
            imgs = imgs_p_right + imgs_p_left + imgs_f_right + imgs_f_left
            poses = poses_p_right + poses_p_left + poses_f_right + poses_f_left
        projs = [K] * (2 * len(ids) + 2 * len(ids_fish))

        data = {
            "imgs": np.stack(imgs).astype(np.float32),
            "projs": np.stack(projs).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            "ts": np.array(ids + ids + ids_fish + ids_fish, np.int32),
            "index": np.array([index]),
        }
        if self.return_depth:
            data["depths"] = self.load_depth(seq, img_ids[0], is_right)[None]
        if self.return_segmentation:
            data["segs"] = self.load_segmentation(seq, img_ids[0])
        if self.return_3d_bboxes:
            from scenedino_torch.datasets.annotations import get_3d_bboxes

            data["3d_bboxes"] = [get_3d_bboxes(self._3d_bboxes[seq], img_ids[0], poses[0], projs[0])]
        return data

    def _getitem_overlap(self, index, seq, id, seq_len) -> Dict[str, np.ndarray]:
        """The KITTI_360_v2 item (kitti_360_v2.py:267-341): the
        `_overlap_samples` frames in order, each camera's intrinsics and
        pose, the fisheyes through the same resamplers; depth, labels and
        boxes of the encoder frame."""
        samples = self._overlap_samples(seq, id, seq_len, self._rng)
        resamplers = {"00": None, "01": None, "02": self._resampler_02, "03": self._resampler_03}
        aug = sample_color_aug_fn(self._rng) if self.color_aug else None
        T = self._calibs["T_cam_to_pose"]
        Kp, Kf = self._calibs["K_perspective"], self._calibs["K_fisheye"]

        imgs, poses, projs, ts = [], [], [], []
        for cam, i in samples:
            img_id = int(self._img_ids[seq][i])
            imgs.append(self._load_and_process(seq, cam, img_id, resamplers[cam], aug))
            poses.append(self._poses[seq][i] @ T[cam])
            projs.append(Kp if cam in ("00", "01") else Kf)
            ts.append(i)

        data = {
            "imgs": np.stack(imgs).astype(np.float32),
            "projs": np.stack(projs).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            "ts": np.array(ts, np.int32),
            "index": np.array([index]),
        }
        enc_cam, enc_i = samples[0]
        enc_img_id = int(self._img_ids[seq][enc_i])
        if self.return_depth:
            data["depths"] = self.load_depth(seq, enc_img_id, enc_cam == "01")[None]
        if self.return_segmentation:
            data["segs"] = self.load_segmentation(seq, enc_img_id)
        if self.return_3d_bboxes:
            from scenedino_torch.datasets.annotations import get_3d_bboxes

            data["3d_bboxes"] = [get_3d_bboxes(self._3d_bboxes[seq], enc_img_id, data["poses"][0],
                                               data["projs"][0])]
        return data
