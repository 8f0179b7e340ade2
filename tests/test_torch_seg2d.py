"""The port's 2D segmentation evaluator (`eval/seg2d.py`, `eval/crf.py`,
`cli/evaluate.py`) against the JAX package's on the CPU.

The field and head are tests/test_torch_stage2.py's (the ViT-S/8 cut to
width 64, depth 3; an 8-d field feature expanded to 64; 5 clusters over 4
classes), drawn with numpy in the JAX layout and loaded into the port; the
frames are 32x64, 8 samples a ray. Frame i's strata are rebuilt from the
JAX evaluator's key `PRNGKey(i)` as both of its renders split it
(`split(key, 5)[0]`, one chunk). fp32, JAX at "highest" matmul precision.

Tolerances: depth to rtol 1e-4 + atol 1e-4 (fp32 sums in other orders
through the ViT, the DPT and the render); each mode's labels equal
wherever the mode's top two scores (cluster cosines or probe logits,
from the port's features) differ by more than 1e-4, a margin at least 90%
of the pixels clear; the accumulated confusions differ by at most two
counts per pixel below the margin. The window CRF: probabilities to 1e-4
(10 mean-field iterations of fp32 sums over ~450 taps, each tap a fused
multiply-add in the port: the differences measured reach 2.4e-5), its
labels equal where the top two probabilities differ by more than 1e-4.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedino_tpu.eval.crf import dense_crf as jdense_crf
from scenedino_tpu.eval.crf import refine_segmentation as jrefine_segmentation
from scenedino_tpu.eval.seg2d import Seg2DEvaluator as JSeg2DEvaluator
from scenedino_torch.cli import evaluate
from scenedino_torch.datasets.image_io import write_png
from scenedino_torch.eval.crf import dense_crf, refine_segmentation
from scenedino_torch.eval.seg2d import Seg2DEvaluator
from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig, _norm
from scenedino_torch.utils.config import save_run_config
from scenedino_torch.utils.convert import load_jax_head
from tests.test_torch_sscbench import runs  # noqa: F401  (the shared module fixture)
from tests.test_torch_stage2 import HEAD, MODEL, setup  # noqa: F401
from tests.test_torch_training import _batch

H, W, K = 32, 64, 8
MARGIN = 1e-4
MODES = ("stego_kmeans", "stego_linear", "direct_kmeans", "direct_linear")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("kw", [{}, {"radius": 3, "dilation": 2, "n_iter": 4}], ids=["shipped", "small-window"])
def test_dense_crf_matches_jax(kw):
    rng = np.random.default_rng(0)
    img = rng.random((24, 40, 3), dtype=np.float32)
    img[:, 20:] *= 0.3  # an edge for the bilateral kernel
    logits = rng.normal(size=(24, 40, 5)).astype(np.float32) * 2
    ours = dense_crf(torch.from_numpy(img), torch.from_numpy(logits), **kw).numpy()
    ref = np.asarray(jdense_crf(jnp.asarray(img), jnp.asarray(logits), **kw))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    top2 = np.sort(ref, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > MARGIN
    np.testing.assert_array_equal(ours.argmax(-1)[clear], ref.argmax(-1)[clear])
    chw = torch.from_numpy(img * 2 - 1).permute(2, 0, 1)  # the package's (3, H, W) in [-1, 1]
    lab = refine_segmentation(chw, torch.from_numpy(logits), **kw).numpy()
    jlab = np.asarray(jrefine_segmentation(jnp.asarray(chw.numpy()), jnp.asarray(logits), **kw))
    np.testing.assert_array_equal(lab[clear], jlab[clear])


def _draws(i):
    """Frame i's strata as the JAX evaluator draws them from PRNGKey(i)."""
    k_coarse = jax.random.split(jax.random.PRNGKey(i), 5)[0]
    return torch.from_numpy(np.array(jax.random.uniform(k_coarse, (H * W, K), jnp.float32)))


def _scores(head, feats, mode):
    """The scores whose argmax is the mode's label (before the pseudo assignment)."""
    x = _norm(feats)
    if mode.startswith("stego"):
        x = head.stego_head(x)
    if mode.endswith("kmeans"):
        cluster = head.stego_cluster_head if mode.startswith("stego") else head.direct_cluster_head
        return _norm(x) @ _norm(cluster.cluster_centers).T
    return (head.stego_linear_head if mode.startswith("stego") else head.direct_linear_head).linear(x)


def _frames():
    b0, b1 = _batch(0), _batch(1)
    rng = np.random.default_rng(5)
    return [{"imgs": b["imgs"][0, :1], "projs": b["projs"][0, :1], "poses": np.eye(4, dtype=np.float32)[None],
             "segs": rng.integers(-1, 4, size=(1, H, W))} for b in (b0, b1)]


@pytest.fixture(scope="module")
def evaluators(setup):  # noqa: F811
    """Both packages' evaluators on the same weights, fast and generic."""
    field = setup["model"]
    head = SemanticHead(SemanticHeadConfig(**HEAD))
    load_jax_head(head, setup["hvars"])
    head.eval()
    out = {}
    for fast in (True, False):
        out[("jax", fast)] = JSeg2DEvaluator(field=setup["jfield"], head=setup["jhead"], field_params=setup["params"],
                                             head_variables=setup["hvars"], image_size=(H, W), n_coarse=K,
                                             n_classes=5, use_fast_render=fast)
        out[("port", fast)] = Seg2DEvaluator(field=field, head=head, image_size=(H, W), n_coarse=K, n_classes=5,
                                             use_fast_render=fast)
    return out


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "generic"])
def test_seg2d_evaluator_matches_jax(evaluators, fast):
    ours, ref = evaluators[("port", fast)], evaluators[("jax", fast)]
    assert ours.uses_fast_render() == fast
    frames = _frames()
    below = 0
    for i, f in enumerate(frames):
        batch = [torch.from_numpy(f[k])[None] for k in ("imgs", "projs", "poses")]
        with torch.no_grad():
            rendered = ours.render(*batch, _draws(i))
            preds = ours.labels(rendered)
            feats = ours.field.expand_dim(rendered[1])
        jpreds = ref._predict(ref.field_params, ref.head_variables, *(jnp.asarray(b.numpy()) for b in batch),
                              jax.random.PRNGKey(i))
        np.testing.assert_allclose(preds["depth"].numpy(), np.asarray(jpreds["depth"]), rtol=1e-4, atol=1e-4)
        for mode in MODES:
            top2 = torch.topk(_scores(ours.head, feats, mode), 2, -1).values
            clear = ((top2[..., 0] - top2[..., 1]) > MARGIN).numpy()
            assert clear.mean() >= 0.9, (mode, clear.mean())
            below += int((~clear).sum())
            np.testing.assert_array_equal(preds[mode].numpy()[clear], np.asarray(jpreds[mode])[clear])
    res = ours.run(frames, draws=_draws)
    jres = ref.run(frames)
    assert res["n_frames"] == jres["n_frames"] == 2
    for mode in MODES:
        diff = np.abs(res[mode]["confusion_matrix"] - np.asarray(jres[mode]["confusion_matrix"])).sum()
        assert diff <= 2 * below, (mode, diff, below)
        for k in ("miou", "weighted_miou", "acc"):
            assert np.isfinite(res[mode][k]) and 0.0 <= res[mode][k] <= 1.0


def test_seg2d_evaluator_crf_rows(evaluators):
    """apply_crf adds "<mode>_crf" rows: the window CRF (held against JAX
    above) over the one-hot labels, with the rendered colours clamped to
    [0, 1] as appearance, as the JAX evaluator wires it."""
    ours = evaluators[("port", True)]
    modes = ("stego_kmeans", "direct_linear")
    crf = Seg2DEvaluator(field=ours.field, head=ours.head, image_size=(H, W), n_coarse=K, n_classes=5, modes=modes,
                         apply_crf=True)
    assert crf.result_modes == modes + ("stego_kmeans_crf", "direct_linear_crf")
    f = _frames()[0]
    batch = [torch.from_numpy(f[k])[None] for k in ("imgs", "projs", "poses")]
    with torch.no_grad():
        rendered = crf.render(*batch, _draws(0))
        preds = crf.labels(rendered)
        plain = ours.labels(rendered)
    for mode in modes:
        assert torch.equal(preds[mode], plain[mode])
        probs = dense_crf(torch.clamp(rendered[2], 0, 1), torch.eye(5)[preds[mode]])
        assert torch.equal(preds[mode + "_crf"], torch.argmax(probs, -1))
    assert Seg2DEvaluator(field=ours.field, head=ours.head, crf_method="exact").crf_method == "exact"
    with pytest.raises(ValueError, match="crf_method"):
        Seg2DEvaluator(field=ours.field, head=ours.head, crf_method="lattice")


def test_fast_render_condition(evaluators):
    """The folded render needs one frame and the field's own z range."""
    ours = evaluators[("port", True)]
    assert ours.uses_fast_render(1) and not ours.uses_fast_render(2)
    other = Seg2DEvaluator(field=ours.field, head=ours.head, image_size=(H, W), z_far=60.0)
    assert not other.uses_fast_render(1)


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    """A Cityscapes tree of 2 frames at 64x128 whose labels map to the head's 4 classes."""
    rng = np.random.RandomState(3)
    root = tmp_path_factory.mktemp("cityscapes")
    (root / "leftImg8bit" / "val" / "ulm").mkdir(parents=True)
    (root / "gtFine" / "val" / "ulm").mkdir(parents=True)
    for i in range(2):
        write_png(root / "leftImg8bit" / "val" / "ulm" / f"ulm_{i:06d}_leftImg8bit.png",
                  (rng.rand(64, 128, 3) * 255).astype(np.uint8))
        write_png(root / "gtFine" / "val" / "ulm" / f"ulm_{i:06d}_gtFine_labelIds.png",
                  rng.choice(np.array([0, 7, 8, 11, 12], np.uint8), (64, 128)))  # ignore, trainIds 0-3
    return root


@pytest.mark.parametrize("crf", [False, True], ids=["plain", "apply_crf"])
def test_cli_evaluates_a_stage2_run_on_the_cpu(runs, cityscapes, tmp_path, capsys, crf):  # noqa: F811
    conf = {"seed": 0, "model": MODEL, "downstream": {**HEAD, "apply_crf": crf},
            "dataset": {"type": "Cityscapes_seg", "data_path": str(cityscapes), "image_size": [H, W]}}
    save_run_config(str(tmp_path), conf)
    out = evaluate.main(["--config", str(tmp_path), "--ckpt", str(runs["stage2"]), "--device", "cpu",
                         "--max-frames", "1" if crf else "2"])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(out))
    modes = list(MODES) + ([m + "_crf" for m in MODES] if crf else [])
    assert list(out) == modes + ["n_frames"] and out["n_frames"] == (1 if crf else 2)
    for mode in modes:
        assert sorted(out[mode]) == ["acc", "miou", "weighted_miou"]
        assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in out[mode].values())


def test_cli_refuses_a_run_without_a_head_and_the_cpu_by_default(runs, cityscapes, tmp_path):  # noqa: F811
    conf = {"model": MODEL, "dataset": {"type": "Cityscapes_seg", "data_path": str(cityscapes), "image_size": [H, W]}}
    save_run_config(str(tmp_path), conf)
    with pytest.raises(ValueError, match="no semantic head"):
        evaluate.main(["--config", str(tmp_path), "--ckpt", str(runs["stage1"]), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.main(["--config", str(tmp_path), "--ckpt", str(runs["stage2"])])
