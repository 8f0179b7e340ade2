"""The port's stage-1 training run on the CPU: the synthetic dataset, the
YAML reader and writer, checkpoints, the loop, the CLI, the student's
gradient checkpointing and the background loader.

The dataset and the config reader are held to the reference (equal bit
for bit, and equal to `yaml.safe_load`); the factory's hand-transcribed
training configs to the files they name; the loop's policies (stop,
rotation, resume, save_best and its sign, the non-finite raise-or-warn)
mirror tests/test_nonfinite_skip.py and tests/test_validation.py with a
small model and a stand-in step; the CLI trains a tiny model for 2 steps
with a validation and a checkpoint, then resumes to 4.
"""
import logging
import pathlib

import numpy as np
import pytest
import torch
import yaml

import scenedino_tpu.datasets as jdatasets
from scenedino_torch.cli import train as cli
from scenedino_torch.datasets import make_datasets
from scenedino_torch.datasets.synthetic import SyntheticMultiViewDataset
from scenedino_torch.models.factory import SCENEDINO_KITTI_360_TRAIN, SYNTHETIC_SMOKE_TRAIN, make_model
from scenedino_torch.training import trainer
from scenedino_torch.training.loop import LoopConfig, find_latest_checkpoint, fit
from scenedino_torch.training.validation import SaveBestConfig, Validator
from scenedino_torch.utils import config as yaml_config
from scenedino_torch.utils.checkpoint import load_checkpoint, save_checkpoint, train_state_dict
from scenedino_torch.utils.prefetch import ThreadedLoader, device_prefetch, to_device
from tests.test_torch_training import MODEL

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    yield


# ------------------------------------------------------------- the dataset
@pytest.mark.parametrize("size", [(24, 48), (32, 96)])
def test_synthetic_items_equal_the_references(size):
    conf = {"type": "synthetic", "length": 5, "n_views": 4, "image_size": list(size)}
    ours, ours_val = make_datasets(conf)
    ref, _ = jdatasets.make_datasets(conf)
    assert ours is ours_val and len(ours) == len(ref) == 5
    for i in (0, 2, 4):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_synthetic_dataset_refusals():
    with pytest.raises(ValueError, match="even"):
        SyntheticMultiViewDataset(length=1, n_views=3)[0]
    # the KITTI-360 kinds are ported (tests/test_torch_kitti360.py), RealEstate10K too
    # (tests/test_torch_re10k.py): it now builds, and asks for its data
    with pytest.raises(KeyError, match="data_path"):
        make_datasets({"type": "re10k"})


# --------------------------------------------------------- the YAML subset
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_reader_equals_safe_load(path):
    ours = yaml_config.load(str(path))
    assert ours == yaml.safe_load(path.read_text())
    text = yaml_config.dumps(ours)
    assert yaml_config.loads(text) == ours
    assert yaml.safe_load(text) == ours


SCALARS = """\
a: 1.0e-4
b: 1e-4
c: [yes, no, on, off, true, False, ~, null, ]
d: {x: 010, y: 0x1F, z: -1.5, w: +2, v: 1_000, u: .inf, t: -.INF}
e: 'it''s # not a comment'
f: "tab\\there \\u00e9"
g:
- 1
- k: v
  l: [1, {m: n}]
-
  - 3
h: [1,
    2, [3,
    4]]
i:
j: a:b
k: 3d   # a comment
"""


def test_config_reader_scalars_and_nesting_equal_safe_load():
    assert yaml_config.loads(SCALARS) == yaml.safe_load(SCALARS)
    value = {"s": ["a", "- b", "c: d", "#e", "1", "yes", "", " x", "1e-4", "[", "{}"], "f": [1e-05, 3.0, 1e20],
             "n": {"t": (1, 2), "e": {}, "l": []}, 7: None, "deep": [{"a": [{"b": [1, [2]]}]}]}
    text = yaml_config.dumps(value)
    expect = {**value, "n": {"t": [1, 2], "e": {}, "l": []}}
    assert yaml_config.loads(text) == expect
    assert yaml.safe_load(text) == expect


@pytest.mark.parametrize("text", ["a: &x 1\nb: *x\n", "a: !!int 1\n", "a: |\n  x\n", "a: >\n  x\n",
                                  "---\na: 1\n", "a: 1\n---\nb: 2\n", "? a\n: b\n", "%YAML 1.1\na: 1\n",
                                  "a: [1, 2\n", "a: 'x\n  y'\n", "a: 1\n  b: 2\n", "a: 1\na: 2\n", "a: b: c\n"])
def test_config_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError, match=r"<string>:\d+: unsupported YAML"):
        yaml_config.loads(text)


def _subset_equal(sub, full, path=""):
    """Every key of `sub` is in `full` with an equal value (tuples as lists,
    3 as 3.0, a bool only as a bool)."""
    if isinstance(sub, dict):
        assert isinstance(full, dict), path
        for k, v in sub.items():
            assert k in full, f"{path}.{k}"
            _subset_equal(v, full[k], f"{path}.{k}")
    elif isinstance(sub, (list, tuple)):
        assert isinstance(full, list) and len(full) == len(sub), path
        for i, (a, b) in enumerate(zip(sub, full)):
            _subset_equal(a, b, f"{path}[{i}]")
    else:
        assert sub == full and isinstance(sub, bool) == isinstance(full, bool), (path, sub, full)


@pytest.mark.parametrize("conf,name", [(SCENEDINO_KITTI_360_TRAIN, "train_scenedino_kitti_360.yaml"),
                                       (SYNTHETIC_SMOKE_TRAIN, "train_synthetic_smoke.yaml")])
def test_factory_transcriptions_match_their_files(conf, name):
    _subset_equal(conf, yaml_config.load(str(ROOT / "configs" / name)))


# ------------------------------------------------------------- checkpoints
def _tiny(seed=0, art=True):
    torch.manual_seed(seed)
    field = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(), torch.nn.Linear(8, 2))
    opt = torch.optim.Adam(field.parameters(), lr=1e-2)
    a = a_opt = None
    if art:
        a = torch.randn(3, 2, 2).requires_grad_(True)
        a_opt = torch.optim.Adam([a], lr=1e-2)
    return field, trainer.TrainState(opt, a, a_opt)


def _fake_step(bad_batches=(), budget=2):
    """A real Adam step on the tiny field; a batch in `bad_batches` gives a
    NaN loss whose update is skipped, as the train step's counters say,
    until more than `budget` consecutive ones."""

    def step(state, batch, generator):
        field = state.field
        state.optimizer.zero_grad()
        loss = field(batch["x"]).pow(2).mean() + (state.artifact_field ** 2).mean()
        loss.backward()
        bad = int(batch["id"]) in bad_batches
        state.notfinite_count = state.notfinite_count + 1 if bad else 0
        state.total_notfinite += int(bad)
        gave_up = state.notfinite_count > budget
        if not bad or gave_up:
            state.optimizer.step()
            state.artifact_optimizer.step()
            state.applied += 1
        state.step += 1
        return {"rec_loss": torch.tensor(float("nan")) if bad else loss.detach(),
                "nonfinite_consecutive": state.notfinite_count, "nonfinite_total": state.total_notfinite,
                "nonfinite_gave_up": int(gave_up)}

    return step


def _data(n):
    g = torch.Generator().manual_seed(5)
    batches = [{"x": torch.randn(6, 4, generator=g), "id": i} for i in range(n)]
    return lambda: iter(batches)


def _state_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_state_equal, a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _run(tmp_path, n=6, **kw):
    field, state = _tiny()
    state.field = field
    cfg = LoopConfig(output_path=str(tmp_path), num_epochs=1, log_every=1, **kw)
    return field, fit(field, state, _fake_step(), _data(n), cfg, torch.Generator())


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    field, state = _run(tmp_path, n=3)
    assert state.step == 3 and state.optimizer.state
    path = str(tmp_path / "ck.pt")
    save_checkpoint(path, field, state)
    field2, state2 = _tiny(seed=1)
    assert not _state_equal(train_state_dict(field2, state2), train_state_dict(field, state))
    art = state2.artifact_field
    load_checkpoint(path, field2, state2)
    assert state2.artifact_field is art  # its optimizer still holds it
    assert _state_equal(train_state_dict(field2, state2), train_state_dict(field, state))
    with pytest.raises(ValueError, match="artifact"):
        load_checkpoint(path, *_tiny(art=False))


def test_fit_stops_rotates_and_resumes_from_the_newest(tmp_path):
    field, state = _run(tmp_path, n=10, checkpoint_every=2, stop_iteration=5)
    assert state.step == 5
    assert sorted(p.name for p in tmp_path.glob("*.pt")) == ["training_checkpoint_4.pt"]
    assert find_latest_checkpoint(str(tmp_path)) == str(tmp_path / "training_checkpoint_4.pt")
    saved = torch.load(tmp_path / "training_checkpoint_4.pt", weights_only=True)

    field2, state2 = _tiny(seed=3)
    state2.field = field2
    seen = []
    step = _fake_step()

    def recording(state, batch, generator):
        seen.append((state.step, _state_equal(train_state_dict(field2, state), saved)))
        return step(state, batch, generator)

    cfg = LoopConfig(output_path=str(tmp_path), num_epochs=1, log_every=1, checkpoint_every=2, stop_iteration=7,
                     resume=True)
    fit(field2, state2, recording, _data(10), cfg, torch.Generator())
    assert seen[0] == (4, True) and [s for s, _ in seen] == [4, 5, 6]
    assert state2.step == 7
    assert sorted(p.name for p in tmp_path.glob("*.pt")) == ["training_checkpoint_6.pt"]


def test_fit_steps_per_epoch_and_epochs(tmp_path):
    field, state = _tiny()
    state.field = field
    cfg = LoopConfig(output_path=str(tmp_path), num_epochs=3, log_every=2)
    fit(field, state, _fake_step(), _data(5), cfg, torch.Generator(), steps_per_epoch=2)
    assert state.step == 6


@pytest.mark.parametrize("sign,scores,best_at", [(-1, [0.5, 0.3, 0.4, 0.35], 2), (1, [0.5, 0.3, 0.6, 0.55], 3)])
def test_save_best_keeps_one_file_with_the_signed_best(tmp_path, sign, scores, best_at):
    calls = []

    def fn(state, generator):
        calls.append(state.step)
        return {"depth_abs_rel": scores[len(calls) - 1], "depth_a1": 0.5}

    v = Validator("validation", fn, every=1, save_best=SaveBestConfig("depth_abs_rel", sign))
    field, state = _tiny()
    state.field = field
    cfg = LoopConfig(output_path=str(tmp_path), num_epochs=1, log_every=1, checkpoint_every=100)
    fit(field, state, _fake_step(), _data(4), cfg, torch.Generator(), validators={"validation": v})
    assert calls == [1, 2, 3, 4]
    assert sorted(p.name for p in tmp_path.glob("*.pt")) == [f"depth_abs_rel_best_{best_at}.pt"]
    saved = torch.load(tmp_path / f"depth_abs_rel_best_{best_at}.pt", weights_only=True)
    assert saved["step"] == best_at


def test_validators_run_on_their_own_cadence(tmp_path):
    calls = []
    v = Validator("validation", lambda state, g: calls.append(state.step) or {"x": 1.0}, every=2)
    field, state = _tiny()
    state.field = field
    fit(field, state, _fake_step(), _data(5), LoopConfig(output_path=str(tmp_path), num_epochs=1, log_every=1),
        torch.Generator(), validators={"validation": v})
    assert calls == [2, 4]


def test_nonfinite_loss_warns_while_skipped_and_raises_when_it_goes_through(tmp_path, caplog):
    field, state = _tiny()
    state.field = field
    cfg = LoopConfig(output_path=str(tmp_path), num_epochs=1, log_every=1)
    before = [p.detach().clone() for p in field.parameters()]
    with caplog.at_level(logging.WARNING, logger="training"):
        fit(field, state, _fake_step(bad_batches=(1,)), _data(3), cfg, torch.Generator())
    assert any("update skipped" in r.getMessage() for r in caplog.records)
    assert state.step == 3 and state.applied == 2 and state.total_notfinite == 1
    assert all(torch.isfinite(p).all() and not torch.equal(p, b) for p, b in zip(field.parameters(), before))
    # persistent NaNs exhaust the budget of 2: the third goes through and the loop raises
    field, state = _tiny()
    state.field = field
    with pytest.raises(FloatingPointError, match="iter 3"):
        fit(field, state, _fake_step(bad_batches=range(5)), _data(5), cfg, torch.Generator())
    # a step without the skip protection (no counters) raises at once
    field, state = _tiny()
    state.field = field

    def unprotected(state, batch, generator):
        return {"rec_loss": torch.tensor(float("nan"))}

    with pytest.raises(FloatingPointError, match="iter 1"):
        fit(field, state, unprotected, _data(2), cfg, torch.Generator())


def test_fit_records_carry_the_numbers(tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="training"):
        _run(tmp_path, n=2, checkpoint_every=2)
    steps = [r for r in caplog.records if hasattr(r, "losses")]
    assert [r.iteration for r in steps] == [1, 2] and all(r.step_ms >= 0 and r.data_ms >= 0 for r in steps)
    assert np.isfinite(steps[-1].losses["rec_loss"])
    writes = [r for r in caplog.records if hasattr(r, "checkpoint")]
    assert len(writes) == 1 and writes[0].checkpoint.endswith("training_checkpoint_2.pt")


def test_profiler_window_writes_a_trace(tmp_path):
    _run(tmp_path, n=4, profile_start=1, profile_stop=3)
    assert (tmp_path / "profile" / "trace.json").stat().st_size > 0


# ------------------------------------------------------------ the loader
def test_threaded_loader_and_device_prefetch_keep_order_and_raise():
    ds = [{"a": np.full((2,), i, np.float32), "tag": i} for i in range(7)]
    plan = [[0, 1], [2, 3], [4, 5], [6]]
    got = list(device_prefetch(iter(ThreadedLoader(ds, plan, num_workers=3)),
                               put=lambda b: to_device(b, "cpu", keys=("a",)), buffer_size=2))
    assert [sorted(b) for b in got] == [["a"]] * 4
    assert [b["a"][:, 0].tolist() for b in got] == [[0, 1], [2, 3], [4, 5], [6]]

    def broken():
        yield {"a": np.zeros(1, np.float32)}
        raise OSError("disk")

    with pytest.raises(OSError, match="disk"):
        list(device_prefetch(broken(), put=lambda b: to_device(b, "cpu")))


# ------------------------------------------------ gradient checkpointing
def test_grad_checkpointing_gives_the_plain_students_gradients():
    conf = {**MODEL, "encoder": {**MODEL["encoder"], "grad_checkpointing": True}}
    remat = make_model(conf, device="cpu", training=True)
    plain = make_model(MODEL, device="cpu", training=True)
    assert remat.encoder.vit_encoder.vit.cfg.remat and not plain.encoder.vit_encoder.vit.cfg.remat
    assert not remat.encoder.gt_encoder.vit.cfg.remat  # the teacher is frozen
    plain.load_state_dict(remat.state_dict())
    assert [n for n, _ in remat.named_parameters()] == [n for n, _ in plain.named_parameters()]
    calls = []
    block = remat.encoder.vit_encoder.vit.blocks[1]
    forward = block.forward
    block.forward = lambda *a, **kw: calls.append(1) or forward(*a, **kw)
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 3, 32, 64, generator=g) * 2 - 1
    grads = []
    for m in (remat, plain):
        out = m.encoder(x)[0]
        (out * torch.randn(out.shape, generator=torch.Generator().manual_seed(1))).sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters() if p.grad is not None})
    assert len(calls) == 2  # the block ran again in the backward
    assert sorted(grads[0]) == sorted(grads[1]) and len(grads[0]) > 50
    for n, gr in grads[0].items():
        assert torch.equal(gr, grads[1][n]), n


# ------------------------------------------------------------------- the CLI
TINY = """\
seed: 0
batch_size: 2
num_workers: 2
output:
  path: {out}
dataset:
  type: synthetic
  length: 4
  n_views: 4
  image_size: [32, 64]
model:
  predict_dino: true
  dino_dims: 8
  compensate_artifacts: true
  z_near: 3
  z_far: 80
  encoder:
    encoder_arch: vit-s
    num_ch_enc: [8, 8, 16, 16]
    intermediate_features: [0, 1, 2]
    decoder_out_dim: 16
    dino_pca_dim: 8
    image_size: [32, 64]
    vit_overrides: {{width: 64, depth: 3, num_heads: 2}}
    grad_checkpointing: true
  decoder_heads:
    - type: resnet
      name: normal_head
      args: {{n_blocks: 0, d_hidden: 16}}
renderer:
  n_coarse: 8
  n_fine: 4
training:
  num_epochs: 10
  checkpoint_every: 2
  log_every: 1
  continue: {resume}
  stop_iteration: {stop}
  ray_sampler:
    args: {{patch_size: 8, ray_batch_size: 128}}
validation:
  validation:
    metrics:
      - type: depth
        args: {{to_z: true}}
      - type: dino
        args: null
      - type: nvs
        args: null
    subset:
      type: range
      args: {{start: 0, end: 2}}
    save_best:
      metric: dino_cos_sim
      sign: 1
    events:
      - type: ITERATION_COMPLETED
        args: {{every: 2}}
"""


def test_cli_trains_validates_checkpoints_and_resumes(tmp_path, caplog):
    out = tmp_path / "run"
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY.format(out=out, resume="false", stop=2))
    with caplog.at_level(logging.INFO, logger="training"):
        cli.main(["--config", str(cfg), "--device", "cpu"])
    steps = [r for r in caplog.records if hasattr(r, "losses")]
    vals = [r for r in caplog.records if hasattr(r, "validator")]
    assert [r.iteration for r in steps] == [1, 2]
    assert all(np.isfinite(list(r.losses.values())).all() for r in steps)
    assert len(vals) == 1 and {"depth_abs_rel", "depth_a1", "dino_cos_sim", "nvs_psnr", "nvs_ssim"} <= set(
        vals[0].metrics) and np.isfinite(list(vals[0].metrics.values())).all()
    assert sorted(p.name for p in out.glob("*.pt")) == ["dino_cos_sim_best_2.pt", "training_checkpoint_2.pt"]
    saved = yaml_config.load_run_config(str(out))
    assert saved["model"]["encoder"]["grad_checkpointing"] is True and saved["renderer"]["n_fine"] == 4

    caplog.clear()
    cfg.write_text(TINY.format(out=out, resume="true", stop=4))
    with caplog.at_level(logging.INFO, logger="training"):
        cli.main(["--config", str(cfg), "--device", "cpu"])
    resumed = [r for r in caplog.records if hasattr(r, "resumed_from")]
    assert len(resumed) == 1 and resumed[0].resumed_from.endswith("training_checkpoint_2.pt")
    assert [r.iteration for r in caplog.records if hasattr(r, "losses")] == [3, 4]
    assert sorted(p.name for p in out.glob("*.pt")) == ["dino_cos_sim_best_4.pt", "training_checkpoint_4.pt"]
    assert torch.load(out / "training_checkpoint_4.pt", weights_only=True)["step"] == 4


def test_cli_refuses_the_cpu_without_a_device_and_stage_two(tmp_path, caplog):
    """Stage 2 with `use_fast_render: false` trains through the generic
    (unfolded) full-frame render (held against JAX in
    tests/test_torch_stage2_parallel.py), and neither stage runs on the CPU
    unless asked to."""
    cfg = tmp_path / "tiny.yaml"
    semantic = "downstream: {input_dim: 64, code_dim: 8, buffer_size: 8, patch_sample_size: 8}\n"
    cfg.write_text(TINY.format(out=tmp_path / "run", resume="false", stop=1).replace(
        "training:\n", "training:\n  use_fast_render: false\n") + semantic)
    with caplog.at_level(logging.INFO, logger="training"):
        cli.main(["--config", str(cfg), "--stage", "semantic", "--device", "cpu"])
    steps = [r for r in caplog.records if hasattr(r, "losses")]
    assert [r.iteration for r in steps] == [1] and np.isfinite(list(steps[0].losses.values())).all()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run rightly uses it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--config", str(cfg)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run_stage1(yaml_config.load(str(cfg)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--config", str(cfg), "--stage", "semantic"])
