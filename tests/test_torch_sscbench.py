"""The port's SSCBench evaluator (`eval/sscbench.py`, `cli/evaluate_sscbench.py`,
`utils/checkpoint.load_eval_state`) against the JAX package's on the CPU.

The host accumulation runs on seeded full-size (256, 256, 32) grids and is
held bit for bit: the label maps, `convert_voxels`, `remove_invisible`,
`identify_additional_invalids`, `grow_sigmas`, `SSCAccumulator.summarize`
and `SigmaDiagnostics` (its arrays exactly equal).

The grid predictor runs a tiny headed field (tests/test_torch_stage2.py's:
the ViT-S/8 cut to width 64, depth 3, an 8-d field feature expanded to 64,
a head of 5 clusters over 4 classes) drawn with numpy in the JAX layout and
loaded into the port, over a (16, 16, 8) grid of points in blocks of 512;
fp32, JAX at "highest" matmul precision. Port against JAX on the same path
(fast: the fp32 fold and K4's plain version; slow: the unfolded field):
sigma to atol 1e-4 + rtol 1e-4 (the same fp32 sums in other orders through
the ViT and the DPT), labels equal wherever the head's top two cluster
scores differ by more than 1e-4, a margin that at least 90% of the points
clear. The port's fast path against its slow path as the JAX package holds
its own (tests/test_fast_field.py:262-300): sigma to 2e-4, at least 95% of
the labels equal.

The pipelined paths, the PLY sequence and the demo (slice 19):
`make_pipelined_grid_step` against JAX's on a stub encode and query,
exactly; the SSCBench CLI's --pipelined against its sequential run on both
frames of the tree, the accumulated numbers exactly (a stand-in query:
the real one is the CLI test's above); `cli.generate_ply_sequence` fast
and --pipelined at 0.8 m, the same grids and bytes, and each file the
bytes of JAX's post-processing of those grids; the demo's functions
against JAX's (the strata from JAX's key; depth to rtol 1e-4 + atol 1e-4,
the 768-d features to 1e-4 of their largest magnitude, sigma to 1e-4,
labels as the grid predictor's) and its CLI's files.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.eval.sscbench as J
from scenedino_tpu.cli.evaluate_sscbench import make_query_fn as jmake_query_fn
from scenedino_tpu.models.field import SceneField as JSceneField
from scenedino_tpu.ops.fast_field import build_fast_state as jbuild_fast_state
from scenedino_torch.cli import evaluate_sscbench
from scenedino_torch.cli.evaluate import eval_model
from scenedino_torch.datasets.image_io import write_png
from scenedino_torch.eval import sscbench as S
from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig, _norm
from scenedino_torch.ops.fast_field import build_fast_state
from scenedino_torch.training import trainer
from scenedino_torch.training.downstream import DownstreamTrainConfig, init_downstream_state
from scenedino_torch.utils.checkpoint import load_eval_state, save_checkpoint, save_field_snapshot
from scenedino_torch.utils.config import save_run_config
from scenedino_torch.utils.convert import flatten_params, load_jax_head
from tests.test_torch_stage2 import HEAD, MODEL, setup  # noqa: F401  (the shared module fixture)
from tests.test_torch_training import _batch

GRID = (16, 16, 8)
CHUNK = 512
MARGIN = 1e-4
SEQ = "2013_05_28_drive_0009_sync"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def grids():
    """Seeded full-size grids: raw SSCBench GT (every id and 255), the
    predictor's Cityscapes labels, sigmas spanning the cutoffs, the view mask."""
    rng = np.random.default_rng(0)
    gt = rng.choice(np.array(list(range(20)) + [255], np.uint8), size=(256, 256, 32))
    gt[:, :, :4] = np.where(rng.random((256, 256, 4)) < 0.5, 0, gt[:, :, :4])  # empty columns near the ground
    segs = rng.integers(0, 19, size=(256, 256, 32))
    sigmas = np.exp(rng.normal(-2.0, 2.5, size=(256, 256, 32))).astype(np.float32)
    return gt, segs, sigmas, S.get_fov_mask()


def test_label_maps_and_calibration_match_jax(tmp_path):
    assert S.SSCBENCH_TO_LABEL == J.SSCBENCH_TO_LABEL and S.CITYSCAPES_TO_LABEL == J.CITYSCAPES_TO_LABEL
    assert S.LABELS == J.LABELS and S.N_LABELS == J.N_LABELS
    calib = tmp_path / "calib.txt"
    calib.write_text("P2: 550 0 600 0 0 550 200 0 0 0 1 0\nTr: " + " ".join(
        str(v) for v in np.hstack([np.eye(3)[[1, 2, 0]], [[0.3], [0.1], [-0.2]]]).reshape(-1)) + "\nname: x\n")
    for path in (None, str(calib)):
        ours, ref = S.read_calib(path), J.read_calib(path)
        np.testing.assert_array_equal(ours.cam_k, ref.cam_k)
        np.testing.assert_array_equal(ours.velo2cam, ref.velo2cam)
        np.testing.assert_array_equal(S.get_fov_mask(ours), J.get_fov_mask(ref))


def test_voxel_functions_match_jax_bit_for_bit(grids):
    gt, segs, sigmas, _ = grids
    for table, src in ((S.SSCBENCH_TO_LABEL, gt), (S.CITYSCAPES_TO_LABEL, segs)):
        ours = S.convert_voxels(src, table)
        np.testing.assert_array_equal(ours, J.convert_voxels(src, table))
        assert ours.dtype == np.int64
    target = S.convert_voxels(gt, S.SSCBENCH_TO_LABEL)
    np.testing.assert_array_equal(S.identify_additional_invalids(target), J.identify_additional_invalids(target))
    for density in (0.3, 0.7, 0.95):
        occ = np.random.default_rng(int(density * 10)).random((256, 256, 32)) < density
        np.testing.assert_array_equal(S.remove_invisible(occ), np.asarray(J.remove_invisible(occ)))
    grown = S.grow_sigmas(torch.from_numpy(sigmas)).numpy()
    np.testing.assert_array_equal(grown, np.asarray(J.grow_sigmas(jnp.asarray(sigmas))))


def _equal_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_tree(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_accumulators_match_jax(grids):
    """Two frames through SSCAccumulator; one through SigmaDiagnostics, whose
    105 full evaluations (the reference's, in JAX's copy) run on the view
    mask cut to the nearest 6.4 m to keep the test short."""
    gt, segs, sigmas, fov = grids
    near = fov.copy()
    near[32:] = False
    ours, ref = S.SSCAccumulator(), J.SSCAccumulator()
    dours, dref = S.SigmaDiagnostics(), J.SigmaDiagnostics()
    for shift in (0, 7):  # two frames
        s, g = np.roll(segs, shift, 0), np.roll(gt, shift, 1)
        ours.add_frame(sigmas, s, g, fov)
        ref.add_frame(sigmas, s, g, fov)
        if shift == 0:
            dours.add_frame(sigmas, s, g, near)
            dref.add_frame(sigmas, s, g, near)
    _equal_tree(ours.results, ref.results)
    _equal_tree(ours.summarize(), ref.summarize())
    _equal_tree(dours.cutoff_results, dref.cutoff_results)
    np.testing.assert_array_equal(dours.trade_off_values, dref.trade_off_values)
    assert dours.best_cutoffs() == dref.best_cutoffs()
    assert dours.tradeoff_curve() == dref.tradeoff_curve()


def test_alpha_weighted_argmax_takes_the_first_of_a_tie():
    """Equal weighted scores (a tie, or sigma 0) give the first class, as jnp.argmax."""
    sigma = torch.tensor([0.0, 1.0, 1.0])
    scores = torch.tensor([[0.0, 1.0, 1.0], [0.5, 0.5, 0.2], [0.1, 0.3, 0.3]])

    def query_fn(block, _):
        return sigma[None], scores[None]

    predict = S.make_grid_predictor(query_fn, chunk_points=3, grow=False, grid_dim=(3, 1, 1), coherent=False)
    _, segs = predict(torch.zeros(3, 3), None)
    jpredict = J.make_grid_predictor(lambda b, _: (jnp.asarray(sigma.numpy())[None], jnp.asarray(scores.numpy())[None]),
                                     chunk_points=3, grow=False, grid_dim=(3, 1, 1), coherent=False)
    jsegs = np.asarray(jpredict(jnp.zeros((3, 3)), None)[1])
    np.testing.assert_array_equal(segs.numpy().reshape(-1), jsegs.reshape(-1))
    assert segs.reshape(-1).tolist() == [0, 0, 1]


def _points():
    """(16, 16, 8) voxel centres in the camera frame, in (x, y, z) index order,
    8 to 40 m ahead, a few outside the view."""
    xs, ys, zs = np.linspace(-9, 9, GRID[0]), np.linspace(-2.5, 1.5, GRID[1]), np.linspace(8, 40, GRID[2])
    return np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)


@pytest.fixture(scope="module")
def headed(setup):  # noqa: F811
    """The tiny field with its head in both packages (JAX's as one model with
    `downstream`), one frame's inputs and both packages' encodings of it."""
    from scenedino_tpu.models.downstream import SemanticHead as JSemanticHead
    from scenedino_tpu.models.downstream import SemanticHeadConfig as JSemanticHeadConfig
    from scenedino_tpu.models.factory import make_model as j_make_model

    b = _batch(1)
    imgs, projs, poses = b["imgs"][:1, :1], b["projs"][:1, :1], np.eye(4, dtype=np.float32)[None, None]
    jfield = j_make_model(MODEL, downstream=JSemanticHead(cfg=JSemanticHeadConfig(**HEAD)))
    variables = {"params": {**setup["params"]["params"], "downstream": setup["hvars"]["params"]},
                 "state": {"downstream": setup["hvars"]["state"]}}
    jstate = jax.jit(lambda v, i, k, c: jfield.apply(v, i, k, c, ids_encoder=(0,), ids_render=(0,),  # once
                                                     method=JSceneField.encode))(
        variables, jnp.asarray(imgs), jnp.asarray(projs), jnp.asarray(poses))
    head = SemanticHead(SemanticHeadConfig(**HEAD))
    load_jax_head(head, setup["hvars"])
    head.eval()
    with torch.no_grad():
        state = setup["model"].encode(torch.from_numpy(imgs), torch.from_numpy(projs), torch.from_numpy(poses),
                                      ids_encoder=(0,), ids_render=(0,))
    return dict(jfield=jfield, variables=variables, jstate=jstate, field=setup["model"], head=head, state=state)


@pytest.fixture(scope="module")
def predictions(headed):
    """Both packages' grid predictions (fast and slow) of one frame on the same weights."""
    pts = _points()
    jfield, variables, jstate = headed["jfield"], headed["variables"], headed["jstate"]
    out = {}
    for fast in (True, False):
        qstate = {"vars": variables,
                  "state": jbuild_fast_state(variables, jstate, jfield.cfg, compute_dtype=jnp.float32) if fast
                  else jstate}
        predict = J.make_grid_predictor(jmake_query_fn(jfield, "stego_kmeans", fast, segments=8),
                                        chunk_points=CHUNK, grid_dim=GRID, coherent=fast)
        out[("jax", fast)] = tuple(np.asarray(x) for x in predict(jnp.asarray(pts), qstate))

    field, head, state = headed["field"], headed["head"], headed["state"]
    with torch.no_grad():
        for fast in (True, False):
            qstate = build_fast_state(field, state, compute_dtype=torch.float32) if fast else state
            predict = S.make_grid_predictor(evaluate_sscbench.make_query_fn(field, head, "stego_kmeans", fast),
                                            chunk_points=CHUNK, grid_dim=GRID, coherent=fast)
            out[("port", fast)] = tuple(x.numpy() for x in predict(torch.from_numpy(pts), qstate))
        # the head's cluster-score margin of every point, from the unfolded field's features
        dino768 = field.query_segmentation(state, torch.from_numpy(pts)[None], head)[0][0]
        ip = _norm(head.stego_head(_norm(dino768))) @ _norm(head.stego_cluster_head.cluster_centers).T
        top2 = torch.topk(ip, 2, -1).values
    out["margin"] = (top2[:, 0] - top2[:, 1]).numpy().reshape(GRID)
    return out


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "slow"])
def test_grid_predictor_matches_jax(predictions, fast):
    (sig, seg), (jsig, jseg) = predictions[("port", fast)], predictions[("jax", fast)]
    assert sig.shape == seg.shape == GRID
    np.testing.assert_allclose(sig, jsig, rtol=1e-4, atol=1e-4)
    clear = predictions["margin"] > MARGIN
    assert clear.mean() >= 0.9, clear.mean()
    np.testing.assert_array_equal(seg[clear], jseg[clear])
    assert len(np.unique(seg)) > 1  # the labels compare something


def test_grid_predictor_fast_matches_slow(predictions):
    (sf, lf), (ss, ls) = predictions[("port", True)], predictions[("port", False)]
    np.testing.assert_allclose(sf, ss, atol=2e-4)
    assert (lf == ls).mean() > 0.95


# ---------------------------------------------------------------- checkpoints and the CLI


@pytest.fixture(scope="module")
def runs(tmp_path_factory, setup):  # noqa: F811
    """A stage-2 run directory of the port (its checkpoint, field snapshot and
    training_config.yaml, written by the port's own functions), a stage-1
    run directory, and a JAX variables tree as a flat .npz, all of the
    tiny field on setup's weights."""
    root = tmp_path_factory.mktemp("runs")
    field = setup["model"]
    head = SemanticHead(SemanticHeadConfig(**HEAD))
    load_jax_head(head, setup["hvars"])
    s2 = root / "semantic"
    s2.mkdir()
    save_field_snapshot(str(s2 / "field_params.pt"), field)
    save_checkpoint(str(s2 / "training_checkpoint_3.pt"), head, init_downstream_state(head, DownstreamTrainConfig()))
    save_run_config(str(s2), {"seed": 0, "model": MODEL, "downstream": HEAD,
                              "dataset": {"type": "synthetic", "image_size": [32, 64]}})
    s1 = root / "stage1"
    s1.mkdir()
    tcfg = trainer.configs_from_dict({"model": MODEL})[1]
    save_checkpoint(str(s1 / "training_checkpoint_5.pt"), field, trainer.init_train_state(field, tcfg))
    flat = {f"params/{k}": v for k, v in flatten_params(setup["params"]["params"]).items()}
    flat.update({f"params/downstream/{k}": v for k, v in flatten_params(setup["hvars"]["params"]).items()})
    flat.update({f"state/downstream/{k}": v for k, v in flatten_params(setup["hvars"]["state"]).items()})
    np.savez(root / "jax_variables.npz", **flat)
    return {"stage2": s2, "stage1": s1, "npz": root / "jax_variables.npz", "field": field, "head": head}


def _same(sd, module):
    ref = module.state_dict()
    assert sd.keys() == ref.keys()
    for k in ref:
        assert torch.equal(sd[k].cpu(), ref[k].cpu()), k


@pytest.mark.parametrize("layout", ["stage2-dir", "stage2-file", "stage1-dir", "stage1-file", "snapshot", "npz"])
def test_load_eval_state_reads_each_layout(runs, layout):
    path = {"stage2-dir": runs["stage2"], "stage2-file": runs["stage2"] / "training_checkpoint_3.pt",
            "stage1-dir": runs["stage1"], "stage1-file": runs["stage1"] / "training_checkpoint_5.pt",
            "snapshot": runs["stage2"] / "field_params.pt", "npz": runs["npz"]}[layout]
    field_sd, head_sd = load_eval_state(str(path))
    _same(field_sd, runs["field"])
    if layout in ("stage2-dir", "stage2-file", "npz"):
        _same(head_sd, runs["head"])
    else:
        assert head_sd is None


def test_load_eval_state_refuses_the_rest(runs, tmp_path):
    lone = tmp_path / "lone"
    lone.mkdir()
    torch.save(torch.load(runs["stage2"] / "training_checkpoint_3.pt", weights_only=True),
               lone / "training_checkpoint_3.pt")
    with pytest.raises(FileNotFoundError, match="field snapshot"):
        load_eval_state(str(lone))
    torch.save({"weights": torch.zeros(3)}, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="unrecognized"):
        load_eval_state(str(tmp_path / "other.pt"))
    with pytest.raises(ValueError, match="no training_checkpoint"):
        load_eval_state(str(tmp_path))


@pytest.fixture(scope="module")
def ssc_tree(tmp_path_factory):
    """A seeded SSCBench-KITTI-360 tree of 2 frames: 24x48 front images with
    a P_rect_00 of the release's proportions, calibration, poses, voxel GT."""
    rng = np.random.RandomState(2)
    root = tmp_path_factory.mktemp("ssc")
    calib = root / "calibration"
    calib.mkdir()
    rows = {"calib_cam_to_pose.txt": [(f"image_0{i}", np.eye(4)[:3]) for i in range(4)],
            "perspective.txt": [("P_rect_00", [[18.8, 0, 23.2, 0], [0, 18.8, 8.1, 0], [0, 0, 1, 0]]),
                                ("R_rect_00", np.eye(3)), ("R_rect_01", np.eye(3)), ("S_rect_00", [48, 24])]}
    for name, kv in rows.items():
        (calib / name).write_text("".join(k + ": " + " ".join(str(float(x)) for x in np.ravel(v)) + "\n"
                                          for k, v in kv))
    (calib / "calib_cam_to_velo.txt").write_text(" ".join(str(float(x)) for x in np.eye(4)[:3].ravel()) + "\n")
    img_dir = root / "data_2d_raw" / SEQ / "image_00" / "data_rect"
    img_dir.mkdir(parents=True)
    (root / "data_poses" / SEQ).mkdir(parents=True)
    (root / "voxel_gt" / SEQ).mkdir(parents=True)
    poses = []
    labels = np.array(list(range(20)) + [255], np.uint8)
    for i in range(2):
        write_png(img_dir / f"{i:010d}.png", (rng.rand(24, 48, 3) * 255).astype(np.uint8))
        poses.append([i] + list(np.hstack([np.eye(3), [[0.5 * i], [0], [0]]]).ravel()))
        np.save(root / "voxel_gt" / SEQ / f"{i:06d}_1_1.npy", rng.choice(labels, size=(256, 256, 32)))
    np.savetxt(root / "data_poses" / SEQ / "poses.txt", np.asarray(poses))
    return root


def test_cli_evaluates_a_stage2_run_on_the_cpu(runs, ssc_tree, capsys, caplog):
    """One frame on the fast path, then one on the slow path with the cutoff
    search: a finite table in [0, 1] with the reference's keys, each frame's
    host ms logged."""
    args = ["--data", str(ssc_tree), "--voxel-gt", str(ssc_tree / "voxel_gt"), "--ckpt", str(runs["stage2"]),
            "--config", str(runs["stage2"]), "--device", "cpu", "--max-frames", "1"]
    caplog.set_level("INFO", logger="evaluation")
    table, acc = evaluate_sscbench.main(args)
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(table))
    assert sorted(table) == ["12.8", "25.6", "51.2", "sec_per_frame"]
    for size in ("12.8", "25.6", "51.2"):
        assert sorted(table[size]) == ["direct_miou", "hungarian_miou", "occ_iou"]
        assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in table[size].values())
    assert table["sec_per_frame"] > 0
    frames = [r for r in caplog.records if hasattr(r, "query_ms")]
    assert [r.frame for r in frames] == [0]

    assert acc.summarize()[51.2]["occ_iou"] == table["51.2"]["occ_iou"]
    slow = evaluate_sscbench.main(args + ["--slow", "--test-alpha-cutoffs"])[0]
    assert list(slow["best_alpha_cutoffs"]) == [str(i) for i in range(1, 16)]
    assert len(slow["sigma_tradeoff"]) == len(S.SIGMA_VALUES)


def test_accumulated_counts_cover_the_valid_voxels(grids):
    """tp + fp + tn + fn of each range is the count of in-view voxels whose
    GT is not 255 after the additional invalids."""
    gt, segs, sigmas, fov = grids
    acc = S.SSCAccumulator()
    acc.add_frame(sigmas, segs, gt, fov)
    target = S.convert_voxels(gt, S.SSCBENCH_TO_LABEL)
    target = np.where(S.identify_additional_invalids(target), 255, target)
    for size in S.SIZES:
        nv = int(size // 0.2)
        sl = np.s_[:nv, 128 - nv // 2:128 + nv // 2, :]
        r = acc.results[size]
        assert r["tp"] + r["fp"] + r["tn"] + r["fn"] == int(((target[sl] != 255) & fov[sl]).sum()) > 0


@pytest.mark.parametrize("flags,item", [(["--mode", "s4c"], "item 9")])
def test_cli_refuses_what_is_not_ported(flags, item):
    """What the CLI once refused (`--mode s4c`, ROADMAP queue 1 `item`) now
    runs: it builds the S4C field and reads its checkpoint, so a missing
    one raises FileNotFoundError naming it (tests/test_torch_s4c.py
    evaluates with one)."""
    with pytest.raises(FileNotFoundError, match="no S4C checkpoint at 'x'"):
        evaluate_sscbench.main(["--data", "x", "--voxel-gt", "x", "--ckpt", "x", "--device", "cpu"] + flags)


def test_cli_without_a_device_refuses_the_cpu(runs, ssc_tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_sscbench.main(["--data", str(ssc_tree), "--voxel-gt", str(ssc_tree / "voxel_gt"),
                                "--ckpt", str(runs["stage2"]), "--config", str(runs["stage2"])])


def test_eval_model_loads_the_run_strictly(runs):
    field, head = eval_model({"model": MODEL, "downstream": HEAD}, str(runs["stage2"]), "cpu")
    _same(field.state_dict(), runs["field"])
    _same(head.state_dict(), runs["head"])
    assert not field.training and not any(p.requires_grad for p in field.parameters())
    wrong = dataclasses.asdict(SemanticHeadConfig(**HEAD))
    wrong["code_dim"] = 4
    with pytest.raises(RuntimeError, match="size mismatch"):
        eval_model({"model": MODEL, "downstream": wrong}, str(runs["stage2"]), "cpu")
    assert os.path.exists(runs["stage2"] / "training_config.yaml")


# ---------------------------------------------------------------- the pipelined paths, the PLY sequence, the demo


def test_pipelined_grid_step_matches_jax():
    """make_pipelined_grid_step against JAX's on the same stub encode and
    query (tests/test_eval.py's): the grids are the previous state's, the
    next state the fed frame's encode."""
    X, Y, Z = 8, 8, 4
    pts = np.random.default_rng(1).uniform(-5, 5, (X * Y * Z, 3)).astype(np.float32)
    kw = dict(chunk_points=X * Y * Z // 4, grid_dim=(X, Y, Z))

    def query(block, h, lib):
        sigma = lib.where(block[0, :, 2] > h, 50.0, 0.0)
        scores = lib.stack([block[0, :, 0], block[0, :, 1], -block[0, :, 0]], -1)
        return sigma[None], scores[None]

    step = S.make_pipelined_grid_step(lambda imgs, projs, poses: float(imgs),
                                      S.make_grid_predictor(lambda b, h: query(b, h, torch), **kw))
    jstep = J.make_pipelined_grid_step(lambda v, imgs, projs, poses: imgs,
                                       J.make_grid_predictor(lambda b, q: query(b, q, jnp), jit=False, **kw))
    nxt, (sig, seg) = step(4.0, torch.from_numpy(pts), 1.5, None, None)
    jnxt, (jsig, jseg) = jstep({}, 4.0, jnp.asarray(pts), 1.5, None, None)
    assert nxt == jnxt == 1.5
    np.testing.assert_array_equal(sig.numpy(), np.asarray(jsig))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    assert 0 < (sig.numpy() > 0).mean() < 1 and len(np.unique(seg.numpy())) == 3


def test_cli_pipelined_equals_the_sequential_path(runs, ssc_tree, caplog, monkeypatch):
    """cli.evaluate_sscbench on both frames of the tree, sequential and
    --pipelined (the bootstrap encode, frame i's grids from the step fed
    frame i + 1, the last step re-fed): the same accumulated numbers and
    table. The per-block query is a cheap stand-in that depends on the
    frame's encoding (its folded grid's mean) and the points, so a frame
    taken out of turn changes the numbers; the real query through K4's
    plain version and the head is test_cli_evaluates_a_stage2_run_on_the_cpu's
    and, pipelined, test_ply_sequence_fast_and_pipelined_write_the_same_files's."""

    means = []

    def stand_in(field, head, prediction_mode, fast):
        def query_fn(block, qstate):
            m = qstate.folded_grid.float().mean()
            means.append(m.item())
            x, z = block[0, :, 0], block[0, :, 2]
            sigma = torch.nn.functional.softplus(40.0 * torch.sin(3.0 * x + 100.0 * m) - 0.1 * z)
            label = (torch.floor(7.0 * z + 1e3 * m) % S.N_LABELS).long()
            return sigma[None], (label[:, None] == torch.arange(19)).float()[None]

        return query_fn

    monkeypatch.setattr(evaluate_sscbench, "make_query_fn", stand_in)
    args = _ssc_args(runs, ssc_tree) + ["--voxel-gt", str(ssc_tree / "voxel_gt")]
    caplog.set_level("INFO", logger="evaluation")
    table, acc = evaluate_sscbench.main(args)
    ptable, pacc = evaluate_sscbench.main(args + ["--pipelined"])
    _equal_tree(pacc.results, acc.results)
    assert {k: v for k, v in ptable.items() if k != "sec_per_frame"} == {
        k: v for k, v in table.items() if k != "sec_per_frame"}
    assert ptable["sec_per_frame"] > 0 and acc.results[51.2]["tp"] > 0
    assert [r.frame for r in caplog.records if hasattr(r, "step_ms")] == [0, 1]
    assert len(set(means)) == 2  # the two frames' queries differ


def _ssc_args(runs, ssc_tree):
    return ["--data", str(ssc_tree), "--ckpt", str(runs["stage2"]), "--config", str(runs["stage2"]),
            "--device", "cpu"]


def _jax_ply_files(root, grids, frame_ids, vs, sizes, sigma_cutoff=0.25):
    """The JAX CLI's post-processing (scenedino_tpu/cli/generate_ply_sequence.py:189-217)
    of the given (sigmas, segs) grids, through the JAX package's own functions."""
    from scenedino_tpu.datasets.labels import TRAIN_CLASS_COLORS
    from scenedino_tpu.eval.voxel_io import save_as_voxel_ply

    _, fov_mask = J.generate_point_grid(voxel_size=vs)
    grid_dim = tuple(int(np.ceil(s / vs)) for s in J.SCENE_SIZE)
    out = {}
    for i, (sigmas, segs) in zip(frame_ids, grids):
        occupied = np.asarray(J.remove_invisible((sigmas > sigma_cutoff) & fov_mask.reshape(grid_dim)))
        colors = TRAIN_CLASS_COLORS[np.clip(segs, 0, 19)]
        for size in sizes:
            nv = int(size / vs)
            y0 = grid_dim[1] // 2 - nv // 2
            sl = np.s_[:nv, y0:y0 + nv, :]
            path = root / f"{int(size)}_{i}.ply"
            save_as_voxel_ply(str(path), occupied[sl], origin=(J.VOX_ORIGIN[0], J.VOX_ORIGIN[1] + y0 * vs,
                                                               J.VOX_ORIGIN[2]), voxel_size=vs, colors=colors[sl])
            out[os.path.join(str(int(size)), f"{int(i):06d}.ply")] = path.read_bytes()
    return out


def test_ply_sequence_fast_and_pipelined_write_the_same_files(runs, ssc_tree, tmp_path, monkeypatch):
    """cli.generate_ply_sequence on both frames at 0.8 m (a 64x64x8 grid of
    32,768 centres, padded with the first to one block; the block cut from
    524,288 centres to 65,536 for the CPU), fast and --pipelined, through
    K4's plain version and the head: the same grids and the same bytes, and
    each file the bytes that the JAX CLI's cut, carving, colours, crop and
    crop origin make of those grids."""
    from scenedino_torch.cli import generate_ply_sequence

    monkeypatch.setattr(generate_ply_sequence, "CHUNK", 65536)

    grids = []
    make = S.make_grid_predictor

    def recording(*a, **kw):
        predict = make(*a, **kw)

        def wrapped(pts, qstate):
            out = predict(pts, qstate)
            grids.append(tuple(x.numpy() for x in out))
            return out

        return wrapped

    monkeypatch.setattr(S, "make_grid_predictor", recording)
    sizes = ["12.8", "25.6", "51.2"]
    runs_out = {}
    for mode in ("fast", "pipelined"):
        out = tmp_path / mode
        res = generate_ply_sequence.main(_ssc_args(runs, ssc_tree) + ["--out", str(out), "--voxel-size", "0.8",
                                                                       "--sizes", *sizes]
                                         + (["--pipelined"] if mode == "pipelined" else []))
        assert len(res["frame_ms"]) == 2 and len(res["paths"]) == 6 and res["sec_per_frame"] > 0
        runs_out[mode] = {os.path.relpath(p, out): open(p, "rb").read() for p in res["paths"]}
    assert len(grids) == 4 and all(g[0].shape == (64, 64, 8) for g in grids)
    for a, b in zip(grids[:2], grids[2:]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert runs_out["fast"] == runs_out["pipelined"]
    ref = _jax_ply_files(tmp_path, grids[:2], [0, 1], 0.8, [float(x) for x in sizes])
    assert sorted(ref) == sorted(runs_out["fast"])
    for name, data in runs_out["fast"].items():
        assert data == ref[name], name
    assert all(len(d) > 400 for d in ref.values())  # every crop holds voxels


class _Jitted:
    """A flax module whose `apply` runs under jax.jit (the demo's JAX
    functions call it eagerly, which compiles op by op on the CPU)."""

    def __init__(self, module):
        self.downstream = module.downstream
        self._apply = jax.jit(module.apply, static_argnames=("only_density", "method", "mode"))

    def apply(self, *args, **kwargs):
        return self._apply(*args, **kwargs)


def test_demo_functions_match_jax(headed, tmp_path, monkeypatch):
    """inference_rendered_2d (the strata of JAX's key) and inference_3d on a
    coarse grid: depth to rtol 1e-4 + atol 1e-4, the 768-d features to 1e-4 of
    their largest magnitude, sigma as the grid predictor's (1e-4), labels
    where the head's top two cluster scores differ by more than 1e-4; the
    grid axes and the image reader (PNG, INTER_LINEAR) as JAX's."""
    import scenedino_tpu.cli.demo as jdemo
    from scenedino_torch.cli import demo

    import scenedino_tpu.renderer.nerf as jnerf

    monkeypatch.setattr(jnerf, "render_rays_chunked", jax.jit(jnerf.render_rays_chunked,
                                                              static_argnames=("field_fn", "cfg", "chunk")))
    jfield, variables, jstate = _Jitted(headed["jfield"]), headed["variables"], headed["jstate"]
    field, head, state = headed["field"], headed["head"], headed["state"]
    size = MODEL["encoder"]["image_size"]
    jd, jf = jdemo.inference_rendered_2d(jfield, variables, jstate, image_size=size, seed=0)
    u = torch.from_numpy(np.array(jax.random.uniform(jax.random.split(jax.random.PRNGKey(0), 5)[0],
                                                     (size[0] * size[1], 32))))
    d, f = demo.inference_rendered_2d(field, state, size, u=u)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f.numpy(), jf, atol=1e-4 * float(np.abs(jf).max()), rtol=0)

    grid = dict(x_range=(-6, 6), y_range=(-2, 2), z_range=(4, 28), resolution=1.0)
    jxyz, jdino, jsigma, jseg = jdemo.inference_3d(jfield, variables, jstate, **grid)
    xyz, dino, sigma, seg = demo.inference_3d(field, head, state, **grid)
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_allclose(sigma, jsigma, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dino, jdino, atol=1e-4 * float(np.abs(jdino).max()), rtol=0)
    with torch.no_grad():
        ip = _norm(head.stego_head(_norm(torch.from_numpy(dino)))) @ _norm(head.stego_cluster_head.cluster_centers).T
    top2 = torch.topk(ip, 2, -1).values
    clear = (top2[:, 0] - top2[:, 1]).numpy() > MARGIN
    assert clear.mean() >= 0.9 and len(np.unique(seg)) > 1
    np.testing.assert_array_equal(seg[clear], np.asarray(jseg)[clear])
    _, _, sigma_free, seg_free = demo.inference_3d(field, None, state, **grid)
    assert seg_free is None and np.array_equal(sigma_free, sigma)
    for res in (0.2, 0.25):
        for a, b in zip(demo.grid_axes(resolution=res), jdemo.grid_axes(resolution=res)):
            np.testing.assert_array_equal(a, b)
    assert [len(a) for a in demo.grid_axes()] == [101, 51, 101]
    img = (np.random.default_rng(5).random((20, 30, 3)) * 255).astype(np.uint8)
    write_png(tmp_path / "img.png", img)
    np.testing.assert_allclose(demo.load_image(tmp_path / "img.png", (12, 40)),
                               jdemo.load_image(str(tmp_path / "img.png"), (12, 40)), atol=1e-6, rtol=0)
    for a, b in zip(demo.default_camera(), jdemo.default_camera()):
        np.testing.assert_array_equal(a, b)


def test_demo_cli_writes_every_file(runs, tmp_path, capsys):
    from scenedino_torch.cli import demo
    from scenedino_torch.datasets.image_io import read_png

    write_png(tmp_path / "in.png", (np.random.default_rng(6).random((40, 80, 3)) * 255).astype(np.uint8))
    out = tmp_path / "out"
    ms = demo.main(["--image", str(tmp_path / "in.png"), "--config", str(runs["stage2"]), "--ckpt",
                    str(runs["stage2"]), "--out", str(out), "--device", "cpu"])
    assert all(ms[k] > 0 for k in ("encode_ms", "render_2d_ms", "pca_ms", "grid_3d_ms"))
    assert "depth range" in capsys.readouterr().out
    depth, dino, sigma = (np.load(out / f) for f in ("depth.npy", "dino_features.npy", "grid_sigma.npy"))
    assert depth.shape == (32, 64) and dino.shape == (32, 64, 64) and dino.dtype == np.float16
    assert sigma.shape == (101 * 51 * 101,)
    assert all(np.isfinite(a).all() for a in (depth, dino, sigma)) and ((depth >= 3) & (depth <= 80)).all()
    for name in ("input_image.png", "feat_pca_00_02.png", "feat_pca_03_05.png", "feat_pca_06_08.png"):
        assert read_png(out / name).shape == (32, 64, 3), name
    occupied = int((sigma > 0.2).sum())
    if occupied:
        header = (out / "grid_points.ply").read_bytes().split(b"end_header\n")[0].decode()
        assert f"element vertex {occupied}" in header
    assert occupied or not (out / "grid_points.ply").exists()


def test_eval_model_without_a_checkpoint_is_seeded():
    """No checkpoint (the demo's default): the config's model and head with
    their seeded weights, frozen; the same weights twice."""
    a_field, a_head = eval_model({"model": MODEL, "downstream": HEAD}, None, "cpu")
    b_field, b_head = eval_model({"model": MODEL, "downstream": HEAD}, None, "cpu")
    _same(a_field.state_dict(), b_field)
    _same(a_head.state_dict(), b_head)
    assert not a_head.training and not any(p.requires_grad for p in a_head.parameters())
