"""SSCBench-KITTI-360 voxel evaluator (the port's
`scenedino_tpu/eval/sscbench.py`; reference `sscbench/evaluate_model_sscbench.py`,
`sscbench/point_utils.py` and `sscbench/label_maps.yaml`).

The grid: 256x256x32 voxel centres of 0.2 m over 51.2 x 51.2 x 6.4 m in
front of the camera, in the camera frame, with the release's calibration
(or a semantic-KITTI-style calib.txt) and its field-of-view mask.

The predictor (`make_grid_predictor`) queries the grid on the device in
blocks of 128x128x32 points in the coherent (z, x, y) order, takes the
alpha-weighted argmax of each point's class scores (alpha = 1 -
exp(-0.2 sigma)) and grows sigma by a 3^3 max pool; the grids come back
in (X, Y, Z) order. The accumulation is host numpy as in the reference:
visibility carving (`remove_invisible`), the additional-invalids rule,
occupancy and per-class numbers over the ranges 12.8 / 25.6 / 51.2 m,
and the direct and Hungarian mIoU tables (`SSCAccumulator`), with the
sigma-cutoff search and the precision/recall tradeoff beside them
(`SigmaDiagnostics`). `make_pipelined_grid_step` queries one frame's grid
and encodes the next in one step (one card); `make_sharded_frame_predictor`
predicts a group of frames over a list of devices, one frame each.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from scenedino_torch.eval.metrics import apply_assignment, pseudo_label_assignment
from scenedino_torch.parallel import mesh

SIGMA_CUTOFF = 0.2
VOXEL_SIZE = 0.2
SIZES = (12.8, 25.6, 51.2)
VOX_ORIGIN = np.array([0.0, -25.6, -2.0], np.float32)
SCENE_SIZE = (51.2, 51.2, 6.4)
IMG_W, IMG_H = 1408, 376

# SSCBench-KITTI-360 calibration (sscbench/point_utils.py:84-157)
CAM_K = np.array(
    [[552.554261, 0.0, 682.049453], [0.0, 552.554261, 238.769549], [0.0, 0.0, 1.0]],
    np.float64,
)
CAM2VELO = np.array(
    [
        [0.04307104361, -0.08829286498, 0.995162929, 0.8043914418],
        [-0.999004371, 0.007784614041, 0.04392796942, 0.2993489574],
        [-0.01162548558, -0.9960641394, -0.08786966659, -0.1770225824],
        [0.0, 0.0, 0.0, 1.0],
    ],
    np.float64,
)
VELO2CAM = np.linalg.inv(CAM2VELO)


@dataclasses.dataclass(frozen=True)
class SSCCalib:
    """Per-export calibration (defaults: the SSCBench-KITTI-360 release)."""

    cam_k: np.ndarray = dataclasses.field(default_factory=lambda: CAM_K)
    velo2cam: np.ndarray = dataclasses.field(default_factory=lambda: VELO2CAM)
    img_w: int = IMG_W
    img_h: int = IMG_H


def read_calib(calib_path: Optional[str] = None) -> SSCCalib:
    """Calibration from a semantic-KITTI-style calib.txt ("P2: <12 floats>"
    the 3x4 intrinsics, "Tr: <12 floats>" velodyne -> camera); no path gives
    the release's values, which the reference hard-codes
    (point_utils.py:84-136)."""
    if calib_path is None:
        return SSCCalib()
    vals = {}
    with open(calib_path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, _, rest = line.partition(":")
            try:
                vals[key.strip()] = np.array([float(x) for x in rest.split()])
            except ValueError:
                continue
    calib = SSCCalib()
    if "P2" in vals and vals["P2"].size == 12:
        calib = dataclasses.replace(calib, cam_k=vals["P2"].reshape(3, 4)[:3, :3])
    if "Tr" in vals and vals["Tr"].size == 12:
        v2c = np.eye(4)
        v2c[:3, :4] = vals["Tr"].reshape(3, 4)
        calib = dataclasses.replace(calib, velo2cam=v2c)
    return calib


# label_maps.yaml
SSCBENCH_TO_LABEL = {
    0: 0, 1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 7, 8: 8, 9: 8, 10: 12,
    11: 9, 12: 10, 13: 11, 14: 12, 15: 13, 16: 14, 17: 9, 18: 15, 19: 0, 255: 255,
}
CITYSCAPES_TO_LABEL = {
    0: 7, 1: 8, 2: 9, 3: 9, 4: 10, 5: 13, 6: 15, 7: 14, 8: 11, 9: 12, 10: 0,
    11: 6, 12: 0, 13: 1, 14: 4, 15: 5, 16: 5, 17: 3, 18: 2,
}
LABELS = {
    0: "unlabeled", 1: "car", 2: "bicycle", 3: "motorcycle", 4: "truck",
    5: "other-vehicle", 6: "person", 7: "road", 8: "sidewalk", 9: "building",
    10: "fence", 11: "vegetation", 12: "terrain", 13: "pole",
    14: "traffic-sign", 15: "other-object",
}
N_LABELS = 16  # with unlabeled


def convert_voxels(arr, map_dict) -> np.ndarray:
    """Label remap through a 256-entry table (evaluate_model_sscbench.py:856-858);
    ids the map does not name become 0."""
    lut = np.zeros(256, dtype=np.int64)
    for k, v in map_dict.items():
        lut[k] = v
    return lut[np.asarray(arr, np.int64)]


def generate_point_grid(voxel_size=VOXEL_SIZE, vox_origin=VOX_ORIGIN, scene_size=SCENE_SIZE,
                        calib: Optional[SSCCalib] = None):
    """Voxel-centre points in the camera frame and the field-of-view mask
    (sscbench/point_utils.py:17-82). Returns (pts (N, 3) float32,
    fov_mask (N,) bool), N = 256*256*32 at 0.2 m, voxels in (x, y, z)
    index order."""
    calib = calib or SSCCalib()
    vol_dim = np.ceil(np.array(scene_size) / voxel_size).astype(int)
    xv, yv, zv = np.meshgrid(range(vol_dim[0]), range(vol_dim[1]), range(vol_dim[2]), indexing="ij")
    coords = np.stack([xv.reshape(-1), yv.reshape(-1), zv.reshape(-1)], 1).astype(np.float32)
    velo_pts = vox_origin[None] + voxel_size * coords + voxel_size * 0.5

    v2c, cam_k = calib.velo2cam, calib.cam_k
    cam_pts = (v2c[:3, :3] @ velo_pts.T).T + v2c[:3, 3]
    pix_x = np.round(cam_pts[:, 0] * cam_k[0, 0] / cam_pts[:, 2] + cam_k[0, 2]).astype(np.int64)
    pix_y = np.round(cam_pts[:, 1] * cam_k[1, 1] / cam_pts[:, 2] + cam_k[1, 2]).astype(np.int64)
    pix_z = cam_pts[:, 2]
    fov_mask = (
        (pix_x >= 0) & (pix_x < calib.img_w) & (pix_y >= 0) & (pix_y < calib.img_h) & (pix_z > 0)
    )
    return cam_pts.astype(np.float32), fov_mask


def get_fov_mask(calib: Optional[SSCCalib] = None) -> np.ndarray:
    """The field-of-view mask as a (256, 256, 32) grid."""
    return generate_point_grid(calib=calib)[1].reshape(256, 256, 32)


def remove_invisible(volume) -> np.ndarray:
    """Visibility carving (gen_voxelgrid_npy.py:171-185): an occupied voxel
    whose six face neighbours are all occupied is dropped. volume (X, Y, Z)
    bool; the count is integer shifts of the zero-padded grid, exact."""
    v = np.asarray(volume, bool)
    p = np.pad(v, 1).astype(np.int8)
    X, Y, Z = v.shape
    n = (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1] + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
         + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])
    return v & ~(n >= 6)


def identify_additional_invalids(target) -> np.ndarray:
    """Voxels shadowed below the first occupied or invalid one along z, in
    the lowest 7 layers, where the GT is empty (evaluate_model_sscbench.py:814-827).
    target (256, 256, 32) labels."""
    t = np.concatenate([np.zeros([256, 256, 1]), target], axis=2)
    invalids = np.cumsum(np.logical_and(t != 255, t != 0), axis=2)[:, :, :32] == 0
    invalids[:, :, 7:] = 0
    invalids[target != 0] = 0
    return invalids


def grow_sigmas(sigmas: torch.Tensor) -> torch.Tensor:
    """3^3 max pool at stride 1 (evaluate_model_sscbench.py:755-756); the
    border takes the maximum over the voxels inside the grid."""
    return F.max_pool3d(sigmas[None, None], 3, stride=1, padding=1)[0, 0]


# (block (1, P, 3), qstate) -> (sigma (1, P), class scores (1, P, C))
QueryFn = Callable[[torch.Tensor, object], tuple]


def make_grid_predictor(query_fn: QueryFn, chunk_points: int = 128 * 128 * 32, grow: bool = True,
                        grid_dim=(256, 256, 32), voxel_size: float = VOXEL_SIZE, coherent: bool = True):
    """The dense-grid predictor (evaluate_model_sscbench.py:711-753):
    `predict(pts (N, 3), qstate) -> (sigmas grid_dim, segs grid_dim)` on the
    points' device. `query_fn` answers one block of `chunk_points` points
    (`net.forward(pts, predict_segmentation=True)`); each point's label is
    the argmax of its alpha-weighted scores, alpha = 1 - exp(-voxel_size
    sigma), the first class on a tie. N may exceed the grid (a padded tail,
    evaluated and dropped) and must be a whole number of blocks.

    coherent=True feeds the voxels in (z, x, y) order, as the reference does
    for its banded TPU gather, and transposes the grids back."""
    X, Y, Z = grid_dim
    base = X * Y * Z

    def predict(pts: torch.Tensor, qstate):
        N = pts.shape[0]
        if N < base or N % chunk_points:
            raise ValueError(f"{N} points: at least the grid's {base}, in whole blocks of {chunk_points}")
        if coherent:
            pts = torch.cat([pts[:base].reshape(X, Y, Z, 3).permute(2, 0, 1, 3).reshape(base, 3), pts[base:]])
        sigmas, segs = [], []
        for block in pts.reshape(-1, chunk_points, 3):
            sigma, seg = query_fn(block[None], qstate)
            sigma, seg = sigma[0], seg[0]
            alphas = 1.0 - torch.exp(-voxel_size * sigma)
            sigmas.append(sigma)
            segs.append(torch.argmax(alphas[:, None] * seg, -1))
        sigmas = torch.cat(sigmas)[:base]
        segs = torch.cat(segs)[:base]
        if coherent:
            sigmas = sigmas.reshape(Z, X, Y).permute(1, 2, 0).contiguous()
            segs = segs.reshape(Z, X, Y).permute(1, 2, 0).contiguous()
        else:
            sigmas, segs = sigmas.reshape(grid_dim), segs.reshape(grid_dim)
        if grow:
            sigmas = grow_sigmas(sigmas)
        return sigmas, segs

    return predict


def make_sharded_frame_predictor(make_frame_fns: Callable[[torch.device], tuple], devices):
    """Frame-parallel grid prediction over a list of devices (reference
    eval/sscbench.py:241-283): frame j of a group goes to device j, which
    encodes it and queries the whole voxel grid on its own, with no
    collective, so each frame's grids are the single-device predictor's
    bit for bit.

    make_frame_fns(device) -> (encode_fn, predict_fn) on that device
    (`encode_fn(imgs, projs, poses) -> qstate`, a `make_grid_predictor`),
    called once per distinct device. Returns
    `step(pts (N, 3), imgs, projs, poses) -> (sigmas (D, *grid), segs (D, *grid))`
    with every per-frame argument's leading axis holding D <= len(devices)
    frames, one each (a short last group needs no padding); the grids land
    on the first device."""
    devices = [torch.device(d) for d in devices]
    fns = {d: make_frame_fns(d) for d in mesh.distinct(devices)}
    placed: Dict = {}

    def step(pts: torch.Tensor, imgs: torch.Tensor, projs: torch.Tensor, poses: torch.Tensor):
        D = imgs.shape[0]
        if D > len(devices):
            raise ValueError(f"{D} frames for {len(devices)} devices")
        if placed.get("src") is not pts:  # the grid's points, once per distinct device
            placed.clear()
            placed.update({d: pts.to(d) for d in fns}, src=pts)

        def share(j: int, d: torch.device):
            encode_fn, predict_fn = fns[d]
            qstate = encode_fn(*(x[j:j + 1].to(d) for x in (imgs, projs, poses)))
            return [t.to(devices[0]) for t in predict_fn(placed[d], qstate)]

        sigmas, segs = zip(*mesh.run_shares(share, devices[:D]))
        return torch.stack(sigmas), torch.stack(segs)

    return step


def make_pipelined_grid_step(encode_fn, predict_fn):
    """The pipelined SSC / PLY frame stream on one card (reference
    eval/sscbench.py:286-312): one step queries the previous frame's scene
    state over the voxel grid, then encodes the next frame.

        step(qstate_prev, pts, imgs, projs, poses) -> (qstate_next, (sigmas, segs))

    encode_fn(imgs, projs, poses) -> qstate; predict_fn: a
    `make_grid_predictor`. Bootstrap qstate_prev by encoding frame 0, then
    feed frame N+1's inputs to get frame N's grids. The two halves run in
    turn, so the grids are the two-call sequence's bit for bit (the
    reference measured that XLA does not overlap them either)."""

    def step(qstate_prev, pts, imgs, projs, poses):
        sigmas, segs = predict_fn(pts, qstate_prev)
        return encode_fn(imgs, projs, poses), (sigmas, segs)

    return step


def compute_occupancy_numbers(y_pred, y_true, fov_mask):
    """Occupancy tp, fp, tn, fn over the valid in-view voxels (evaluate_model_sscbench.py:908-924)."""
    mask = (y_true != 255) & fov_mask
    occ_true = (y_true > 0)[mask]
    occ_pred = (y_pred > 0)[mask]
    tp = int(np.sum(occ_true & occ_pred))
    fp = int(np.sum(~occ_true & occ_pred))
    fn = int(np.sum(occ_true & ~occ_pred))
    tn = int(np.sum(~occ_true & ~occ_pred))
    return tp, fp, tn, fn


def compute_occupancy_numbers_segmentation(y_pred, y_true, fov_mask):
    """Per-class tp, fp, tn, fn (15,) and the 16x16 confusion (:862-886)."""
    mask = ((y_true != 255) & fov_mask).reshape(-1)
    yp = y_pred.reshape(-1)[mask]
    yt = y_true.reshape(-1)[mask]
    n = N_LABELS - 1
    tp, fp, fn, tn = np.zeros(n), np.zeros(n), np.zeros(n), np.zeros(n)
    for lab in range(1, N_LABELS):
        tp[lab - 1] = np.sum((yt == lab) & (yp == lab))
        fp[lab - 1] = np.sum((yt != lab) & (yp == lab))
        fn[lab - 1] = np.sum((yt == lab) & (yp != lab))
        tn[lab - 1] = np.sum((yt != lab) & (yp != lab))
    conf = np.bincount(N_LABELS * yt + yp, minlength=N_LABELS * N_LABELS).reshape(N_LABELS, N_LABELS)
    return tp, fp, tn, fn, conf


def compute_occupancy_recall_segmentation(y_pred, y_true, fov_mask):
    """Per GT class, how many of its voxels are predicted occupied at all
    (:889-906): (tp (15,), total (15,))."""
    mask = ((y_true != 255) & fov_mask).reshape(-1)
    yp = y_pred.reshape(-1)[mask]
    yt = y_true.reshape(-1)[mask]
    n = N_LABELS - 1
    tp, total = np.zeros(n), np.zeros(n)
    for lab in range(1, N_LABELS):
        tp[lab - 1] = np.sum((yt == lab) & (yp > 0))
        total[lab - 1] = np.sum(yt == lab)
    return tp, total


SEARCH_VALUES = (10e-1, 10e-2, 10e-3, 10e-4, 10e-5, 10e-6, 10e-7)  # :55
SIGMA_VALUES = (1, 0.5, 0.25, 0.1, 0.05, 0.025, 0.01, 0.005, 0.0025, 0.001)  # :63


@dataclasses.dataclass
class SigmaDiagnostics:
    """TEST_ALPHA_CUTOFFS: the per-class sigma-cutoff search and the
    CREATE_SIGMA_TRADEOFF precision/recall curve
    (evaluate_model_sscbench.py:302-304,473-492,616-640). Feed the raw
    (pre-cutoff) grids per frame. The search needs class i's numbers only
    after zeroing class i below a cutoff: they are counted for class i
    alone, the same counts the reference takes from all 15."""

    cutoff_results: Dict = dataclasses.field(
        default_factory=lambda: {i: {sv: np.zeros(4) for sv in SEARCH_VALUES} for i in range(1, 16)})
    trade_off_values: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((len(SIGMA_VALUES), 4)))

    def add_frame(self, sigmas, segs, voxel_gt, fov_mask, use_additional_invalids=True):
        segs = convert_voxels(segs, CITYSCAPES_TO_LABEL)
        target = convert_voxels(voxel_gt.astype(int), SSCBENCH_TO_LABEL)
        if use_additional_invalids:
            target = np.where(identify_additional_invalids(target), 255, target)

        mask = ((target != 255) & fov_mask).reshape(-1)
        yt, yp, sg = target.reshape(-1)[mask], segs.reshape(-1)[mask], sigmas.reshape(-1)[mask]
        for i in range(1, 16):
            true_i, pred_i = yt == i, yp == i
            for sv in SEARCH_VALUES:
                kept = pred_i & ~(sg < sv)
                tp = np.sum(true_i & kept)
                self.cutoff_results[i][sv] += np.array(
                    [tp, np.sum(kept) - tp, np.sum(~true_i & ~kept), np.sum(true_i) - tp], np.float64)
        for j, val in enumerate(SIGMA_VALUES):
            tmp = segs.copy()
            tmp[sigmas < val] = 0
            self.trade_off_values[j] += np.array(compute_occupancy_numbers(tmp, target, fov_mask))

    def best_cutoffs(self) -> Dict[int, float]:
        """The per-class sigma cutoff of the largest IoU (:616-625)."""
        out = {}
        for i in range(1, 16):
            ious = []
            for sv in SEARCH_VALUES:
                tp, fp, tn, fn = self.cutoff_results[i][sv]
                ious.append(tp / max(tp + fp + fn, 1e-9))
            out[i] = SEARCH_VALUES[int(np.argmax(ious))]
        return out

    def tradeoff_curve(self):
        """(sigma, precision, recall, iou) rows of the tradeoff plot (:627-640)."""
        rows = []
        for j, val in enumerate(SIGMA_VALUES):
            tp, fp, tn, fn = self.trade_off_values[j]
            rows.append((val, float(100 * tp / max(tp + fp, 1e-9)), float(100 * tp / max(tp + fn, 1e-9)),
                         float(100 * tp / max(tp + fp + fn, 1e-9))))
        return rows


@dataclasses.dataclass
class SSCAccumulator:
    """Running per-range numbers (evaluate_model_sscbench.py:284-299)."""

    results: Dict = dataclasses.field(default_factory=lambda: {
        size: {
            "tp": 0, "fp": 0, "tn": 0, "fn": 0,
            "tp_seg": np.zeros(15), "fp_seg": np.zeros(15), "tn_seg": np.zeros(15), "fn_seg": np.zeros(15),
            "tp_recall_seg": np.zeros(15), "sum_recall_seg": np.zeros(15),
            "confusion_seg": np.zeros((N_LABELS, N_LABELS)),
        }
        for size in SIZES
    })

    def add_frame(self, sigmas, segs, voxel_gt, fov_mask, use_additional_invalids=True):
        """sigmas, segs (256, 256, 32) numpy (segs in Cityscapes trainIds);
        voxel_gt (256, 256, 32) raw SSCBench labels."""
        segs = convert_voxels(segs, CITYSCAPES_TO_LABEL)
        target = convert_voxels(voxel_gt.astype(int), SSCBENCH_TO_LABEL)

        occupied = remove_invisible(sigmas > SIGMA_CUTOFF)
        occupied[segs == 0] = False
        segs = np.where(occupied, segs, 0)
        if use_additional_invalids:
            target = np.where(identify_additional_invalids(target), 255, target)

        for size in SIZES:
            nv = int(size // 0.2)
            sl = np.s_[:nv, 128 - nv // 2:128 + nv // 2, :]
            _segs, _target, _fov = segs[sl], target[sl], fov_mask[sl]
            tp, fp, tn, fn = compute_occupancy_numbers(_segs, _target, _fov)
            tps, fps, tns, fns, conf = compute_occupancy_numbers_segmentation(_segs, _target, _fov)
            tpr, sumr = compute_occupancy_recall_segmentation(_segs, _target, _fov)
            r = self.results[size]
            r["tp"] += tp
            r["fp"] += fp
            r["tn"] += tn
            r["fn"] += fn
            r["tp_seg"] += tps
            r["fp_seg"] += fps
            r["tn_seg"] += tns
            r["fn_seg"] += fns
            r["tp_recall_seg"] += tpr
            r["sum_recall_seg"] += sumr
            r["confusion_seg"] += conf

    def summarize(self) -> Dict:
        """The direct and Hungarian mIoU tables (evaluate_model_sscbench.py:536-609)."""
        out = {}
        for size in SIZES:
            r = self.results[size]
            occ_iou = r["tp"] / max(r["tp"] + r["fp"] + r["fn"], 1)
            direct_iou = r["tp_seg"] / np.maximum(r["tp_seg"] + r["fp_seg"] + r["fn_seg"], 1)
            conf = r["confusion_seg"][1:, 1:]  # unlabeled takes no part in the matching
            remapped = apply_assignment(conf, pseudo_label_assignment(conf))
            tp_h = np.diag(remapped).astype(np.float64)
            fp_h = remapped.sum(0) - tp_h
            fn_h = remapped.sum(1) - tp_h
            hung_iou = tp_h / np.maximum(tp_h + fp_h + fn_h, 1)
            out[size] = {
                "occ_iou": float(occ_iou),
                "occ_precision": float(r["tp"] / max(r["tp"] + r["fp"], 1)),
                "occ_recall": float(r["tp"] / max(r["tp"] + r["fn"], 1)),
                "direct_per_class_iou": direct_iou,
                "direct_miou": float(direct_iou.mean()),
                "hungarian_per_class_iou": hung_iou,
                "hungarian_miou": float(hung_iou.mean()),
                "occupancy_recall_seg": r["tp_recall_seg"] / np.maximum(r["sum_recall_seg"], 1),
            }
        return out
