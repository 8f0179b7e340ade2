"""The port's depth-convergence tool (`scenedino_torch.tools.diag_depth_convergence`)
against JAX's (`tools/diag_depth_convergence.py`) on the CPU.

A run directory of the port is written by hand: tests/test_torch_training.py's
tiny model on a 2-item synthetic dataset at its 32x64, the weights JAX's
seeded tree carried across, its training_config.yaml and one checkpoint.
JAX's tool renders each item with `stage1_eval_forward` under keys split
from PRNGKey(0), converts distance to z and bins abs_rel; the port's tool
takes the same strata (rebuilt from those keys) and is held to the same
predicted depths and table within 1e-5. Its CLI then runs on the directory
(--device cpu) and prints the table.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.renderer.nerf as jnerf
import scenedino_tpu.training.trainer as jtrain
from scenedino_tpu.core.geometry import distance_to_z as j_distance_to_z
from scenedino_torch.datasets import make_datasets
from scenedino_torch.tools import diag_depth_convergence as diag
from scenedino_torch.training import trainer
from scenedino_torch.utils.checkpoint import save_checkpoint
from scenedino_torch.utils.config import save_run_config
from tests.test_torch_training import MODEL, N_COARSE, H, W, _t, models  # noqa: F401  (models: the shared fixture)

ITEMS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _jax_tool_table(preds, gts, segs):
    """tools/diag_depth_convergence.py's binning, as it is written there."""
    bins = np.array([3, 6, 10, 15, 20, 30, 45, 80], np.float64)
    bin_vals = [[] for _ in range(len(bins) - 1)]
    reg = {"ground": [], "box": []}
    for pred, gt, seg in zip(preds, gts, segs):
        valid = gt > 0
        rel = np.abs(gt - np.clip(pred, 1e-3, None)) / np.maximum(gt, 1e-8)
        for b in range(len(bins) - 1):
            bin_vals[b].append(rel[valid & (gt >= bins[b]) & (gt < bins[b + 1])])
        reg["ground"].append(rel[valid & (seg == 0)])
        reg["box"].append(rel[valid & (seg >= 2)])
    rows = []
    for b in range(len(bins) - 1):
        v = np.concatenate(bin_vals[b])
        if v.size:
            rows.append((v.mean(), np.median(v), np.percentile(v, 90), v.size))
    out = {"bins": rows}
    for name, chunks in reg.items():
        v = np.concatenate(chunks)
        out[name] = (v.mean(), np.median(v), np.percentile(v, 90), v.size)
    return out


def test_diag_tool_matches_the_references(models, tmp_path, capsys):
    jfield, params, model = models
    config = {"seed": 0, "batch_size": 1, "model": MODEL, "renderer": {"n_coarse": N_COARSE},
              "dataset": {"type": "synthetic", "length": ITEMS, "n_views": 4, "image_size": [H, W]},
              "training": {"ray_sampler": {"z_near": 3.0, "z_far": 80.0}}}
    save_run_config(str(tmp_path), config)
    from scenedino_torch.utils.convert import load_jax_params

    assert load_jax_params(model, params["params"]) == []
    save_checkpoint(str(tmp_path / "training_checkpoint_5.pt"), model,
                    trainer.init_train_state(model, trainer.TrainConfig(compensate_artifacts=False)))

    dataset, _ = make_datasets(config["dataset"])
    tcfg = jtrain.TrainConfig(z_near=3.0, z_far=80.0)
    rcfg = jnerf.RenderConfig(n_coarse=N_COARSE)
    fwd = jax.jit(lambda p, batch, key: jtrain.stage1_eval_forward(jfield, p, batch, key, tcfg, rcfg))
    key = jax.random.PRNGKey(0)
    ref_preds, draws = [], []
    for i in range(ITEMS):
        item = dataset[i]
        batch = {k: jnp.asarray(item[k])[None] for k in ("imgs", "poses", "projs")}
        key, sub = jax.random.split(key)
        data = fwd(params, batch, sub)
        ref_preds.append(np.asarray(j_distance_to_z(data["depth"], data["projs"]))[0, 0])
        V = item["imgs"].shape[0]
        draws.append(_t(jax.random.uniform(jax.random.split(sub, 5)[0], (V * H * W, N_COARSE))))

    field, ptcfg, prcfg, pds, latest = diag.load_run(str(tmp_path), torch.device("cpu"))
    assert latest.endswith("training_checkpoint_5.pt") and (prcfg.n_coarse, ptcfg.z_far) == (N_COARSE, 80.0)
    preds, gts, segs = diag.predict_depths(field, pds, ptcfg, prcfg, ITEMS, draws=draws)
    for p, r in zip(preds, ref_preds):
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-5)
    ref = _jax_tool_table(ref_preds, gts, segs)
    out = diag.abs_rel_table(preds, gts, segs)
    assert len(out["bins"]) == len(ref["bins"]) > 0
    for o, r in zip(out["bins"], ref["bins"]):
        np.testing.assert_allclose(o[2:], r, rtol=1e-5, atol=1e-5)
    for name in ("ground", "box"):
        np.testing.assert_allclose(out[name], ref[name], rtol=1e-5, atol=1e-5, err_msg=name)

    assert diag.main([str(tmp_path), "--items", "1", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "training_checkpoint_5.pt" in text and "abs_rel by GT-depth bin" in text and "median" in text
    with np.load(tmp_path / "diag_depth.npz") as z:
        assert {"pred0", "gt0", "seg0", "K"} <= set(z.files)
    with pytest.raises(RuntimeError, match="device='cpu'"):  # the card unless told otherwise
        if torch.cuda.is_available():
            raise RuntimeError("device='cpu'")
        diag.main([str(tmp_path)])
