"""The port's device-parallel serving and evaluation paths (`parallel/mesh.py`,
`parallel/render_sharding.py`, `ops.fast_field.render_novel_view_fused_sharded`,
`eval.sscbench.make_sharded_frame_predictor`, `Seg2DEvaluator.run_sharded`
and both evaluation CLIs' `--data-parallel`) against the JAX package's on
the CPU, in one process.

The port's "mesh" is a list of devices; here the CPU named n times, as the
JAX package's tests run its meshes over the conftest's 8 host devices.
Every path deals contiguous shares of one global computation to the
devices, so against the port's single-device path it is held bit for bit
(`torch.equal`; the ray render, whose field runs its products at each
share's row count, to JAX's own 1e-5), and against JAX's mesh path at the tolerance of the
single-device parity test it mirrors: the fused render and the ray render
at tests/test_torch_fast_field.py's fp32 bounds (rtol 1e-4, atol 1e-4 or
1e-5 x the largest magnitude), the stand-in frame predictor exactly, the
2D evaluator's confusions within two counts per pixel whose top two scores
lie within 1e-4 (tests/test_torch_seg2d.py's margin). The draws are JAX's,
rebuilt from its keys as those tests rebuild them.
"""
import json
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.eval.sscbench as J
from scenedino_tpu.eval.seg2d import Seg2DEvaluator as JSeg2DEvaluator
from scenedino_tpu.models.field import FieldConfig as JFieldConfig
from scenedino_tpu.ops import fast_field as jff
from scenedino_tpu.parallel.mesh import make_mesh as jmake_mesh
from scenedino_tpu.parallel.render_sharding import render_rays_sharded as jrender_rays_sharded
from scenedino_tpu.renderer.nerf import RenderConfig as JRenderConfig
from scenedino_torch.cli import evaluate, evaluate_sscbench
from scenedino_torch.eval import sscbench as S
from scenedino_torch.eval.seg2d import Seg2DEvaluator
from scenedino_torch.kernels import build, point_render
from scenedino_torch.models.field import FieldConfig
from scenedino_torch.ops import fast_field as ff
from scenedino_torch.parallel import mesh
from scenedino_torch.parallel.render_sharding import make_sharded_renderer, render_rays_sharded
from scenedino_torch.renderer.nerf import RenderConfig, render_rays
from scenedino_torch.utils.config import save_run_config
from tests.test_torch_fast_field import K_NDC, _assert_fp32_close, _draws, _novel_pose, _random_state, _to_port
from tests.test_torch_seg2d import MARGIN, MODES, _scores, cityscapes  # noqa: F401  (a module fixture)
from tests.test_torch_seg2d import _draws as _frame_draws
from tests.test_torch_sscbench import _equal_tree, _ssc_args, runs, ssc_tree  # noqa: F401  (module fixtures)
from tests.test_torch_stage2 import HEAD, MODEL, setup  # noqa: F401  (the shared module fixture)
from tests.test_torch_training import _batch

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def test_mesh_lists_shares_and_runs_them_in_order():
    assert mesh.make_mesh(device="cpu") == [CPU]
    module = torch.nn.Linear(2, 2)
    assert mesh.replicate(module, [CPU, CPU]) == {CPU: module}  # no copy on its own device
    assert mesh.run_shares(lambda i, d: (i, d), ["cpu"] * 3) == [(0, CPU), (1, CPU), (2, CPU)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()


def test_run_shares_runs_a_thread_a_device_and_loses_no_launch():
    """Three distinct devices (indexed CPUs) of two shares each: a thread a
    device, its shares in turn, the results in share order, the launch
    counter exact under a short switch interval, a share's error raised."""
    devices = [torch.device("cpu", i % 3) for i in range(6)]
    counter = types.SimpleNamespace(launches=0)

    def share(i, d):
        for _ in range(20000):
            build.count_launch(counter)
        return i, d, threading.get_ident()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = mesh.run_shares(share, devices)
    finally:
        sys.setswitchinterval(interval)
    assert counter.launches == 6 * 20000
    assert [o[:2] for o in out] == list(zip(range(6), devices))
    threads = {d: {o[2] for o in out if o[1] == d} for d in devices}
    assert all(len(t) == 1 for t in threads.values()) and len(set.union(*threads.values())) == 3
    with pytest.raises(ZeroDivisionError):
        mesh.run_shares(lambda i, d: 1 // (i - 4), devices)


# ----------------------------------------------------------- the fused render
H, W, K = 16, 32, 8


@pytest.fixture(scope="module")
def fused():
    """A random fp32 folded state in both packages, a novel camera and JAX's strata."""
    jfs = _random_state(np.random.default_rng(4), H, W)
    key = jax.random.PRNGKey(7)
    return dict(jfs=jfs, fs=_to_port(jfs), pose=_novel_pose(), key=key, u=torch.from_numpy(_draws(key, H * W, K)))


@pytest.mark.parametrize("n, statistic", [(2, "expectation"), (4, "median")])
def test_sharded_fused_render_is_the_single_device_render_and_jaxs(fused, n, statistic):
    """Rows in strips of 2 (8 strips) over n devices: bit for bit the port's
    one-device render, and JAX's sharded render on a mesh of n."""
    cfg, jcfg = FieldConfig(dino_dims=8), JFieldConfig(dino_dims=8)
    pose, kn = torch.from_numpy(fused["pose"]), torch.from_numpy(K_NDC)
    kw = dict(n_coarse=K, depth_statistic=statistic)
    before = point_render.launches
    out = ff.render_novel_view_fused_sharded(fused["fs"], cfg, pose, kn, H, W, [CPU] * n, u=fused["u"],
                                             rows_per_seg=2, **kw)
    one = ff.render_novel_view_fused(fused["fs"], cfg, pose, kn, H, W, u=fused["u"], **kw)
    assert point_render.launches == before  # the CPU takes K2's plain version
    threaded = ff.render_novel_view_fused_sharded(fused["fs"], cfg, pose, kn, H, W,
                                                  [torch.device("cpu", i % 2) for i in range(n)], u=fused["u"],
                                                  rows_per_seg=2, **kw)  # two distinct devices: a thread each
    for a, b, c in zip(out, one, threaded):
        assert torch.equal(a, b) and torch.equal(c, b)
    ref = jax.jit(lambda fs: jff.render_novel_view_fused_sharded(
        fs, jcfg, jnp.asarray(fused["pose"]), jnp.asarray(K_NDC), H, W, fused["key"], jmake_mesh(n), band=8,
        rows_per_seg=2, **kw))(fused["jfs"])
    for a, b in zip(out, ref):
        _assert_fp32_close(a, b)


def test_sharded_fused_render_refuses_what_jax_refuses(fused):
    """Segments that do not divide over the devices (8 over 3) and an int8 grid."""
    cfg, pose, kn = FieldConfig(dino_dims=8), torch.from_numpy(fused["pose"]), torch.from_numpy(K_NDC)
    with pytest.raises(AssertionError, match="not divisible over 3 devices"):
        jff.render_novel_view_fused_sharded(fused["jfs"], JFieldConfig(dino_dims=8), jnp.asarray(fused["pose"]),
                                            jnp.asarray(K_NDC), H, W, fused["key"], jmake_mesh(3), n_coarse=K,
                                            rows_per_seg=2)
    with pytest.raises(AssertionError, match="not divisible over 3 devices"):
        ff.render_novel_view_fused_sharded(fused["fs"], cfg, pose, kn, H, W, [CPU] * 3, u=fused["u"], n_coarse=K,
                                           rows_per_seg=2)
    grid, scale = ff.quantize_folded(fused["fs"].folded_grid)
    int8 = fused["fs"]._replace(folded_grid=grid, grid_scale=scale)
    with pytest.raises(NotImplementedError, match=ff.INT8_REFUSAL.replace("(", r"\(").replace(")", r"\)")):
        ff.render_novel_view_fused_sharded(int8, cfg, pose, kn, H, W, [CPU] * 2, u=fused["u"], n_coarse=K)


# -------------------------------------------------------------- the ray render
def _stand_in_fields(seed=0):
    """One analytic field in both packages: density, colour and an 8-d feature from xyz."""
    a = np.random.default_rng(seed).normal(size=(3, 12)).astype(np.float32) * 0.5
    a[2, 0] -= 0.1  # thinner with depth

    def jfield(xyz, only_density=False):
        h = xyz @ jnp.asarray(a)
        inv = jnp.zeros((*xyz.shape[:2], 1), bool)
        return jax.nn.sigmoid(h[..., 1:4]), inv, jax.nn.softplus(h[..., 0] + 1.0), jnp.tanh(h[..., 4:])

    def tfield(xyz, only_density=False):
        h = xyz @ torch.from_numpy(a)
        inv = torch.zeros(*xyz.shape[:2], 1, dtype=torch.bool)
        return torch.sigmoid(h[..., 1:4]), inv, torch.nn.functional.softplus(h[..., 0] + 1.0), torch.tanh(h[..., 4:])

    return jfield, tfield


def test_render_rays_sharded_is_render_rays_and_jaxs():
    """2 items x 60 rays over 4 devices (15 rays a share), then 3: the port's
    render_rays on the same strata to 1e-5 (the bound of JAX's own test,
    tests/test_prefetch.py:107-114: a share's products run at its row count,
    whose CPU kernels may round otherwise), the samples bit for bit, and
    JAX's ray-sharded render."""
    jfield, tfield = _stand_in_fields()
    rng = np.random.default_rng(5)
    B, R, n_coarse = 2, 60, 8
    dirs = rng.normal(size=(B, R, 3)) * [0.3, 0.2, 0.0] + [0, 0, 1]
    rays = np.concatenate([rng.normal(size=(B, R, 3)) * 0.2, dirs, np.full((B, R, 1), 3.0),
                           np.full((B, R, 1), 80.0)], -1).astype(np.float32)
    key = jax.random.PRNGKey(6)
    u = torch.from_numpy(np.array(jax.random.uniform(jax.random.split(key, 5)[0], (B * R, n_coarse))))
    kw = dict(want_weights=True, want_z_samps=True)
    rcfg = RenderConfig(n_coarse=n_coarse)
    out = render_rays_sharded(lambda d: tfield, torch.from_numpy(rays), u, rcfg, [CPU] * 4, **kw)
    one = render_rays(tfield, torch.from_numpy(rays), u, rcfg, **kw)
    assert sorted(out) == sorted(one) == ["coarse"] and sorted(out["coarse"]) == sorted(one["coarse"])
    again = make_sharded_renderer(lambda d: tfield, rcfg, [CPU] * 3, **kw)(torch.from_numpy(rays), u)
    for k, v in one["coarse"].items():  # a share's products run at its own row count: JAX's own bound
        torch.testing.assert_close(out["coarse"][k], v, atol=1e-5, rtol=0, msg=k)
        torch.testing.assert_close(again["coarse"][k], v, atol=1e-5, rtol=0, msg=k)
    assert torch.equal(out["coarse"]["z_samps"], one["coarse"]["z_samps"])
    ref = jrender_rays_sharded(jfield, jnp.asarray(rays), key, JRenderConfig(n_coarse=n_coarse), jmake_mesh(4), **kw)
    assert sorted(ref["coarse"]) == sorted(out["coarse"])
    for k, v in ref["coarse"].items():
        _assert_fp32_close(out["coarse"][k].float(), np.asarray(v, np.float32))


# ------------------------------------------------------ the SSC frame predictor
def test_sharded_frame_predictor_is_the_sequential_one_and_jaxs():
    """3 frames over 2 devices (JAX pads the second group with the third
    frame; the port's is short), a stand-in encode and query whose grids
    depend on the frame: each frame's grids equal the port's sequential
    predictor's and JAX's."""
    X, Y, Z = 16, 16, 8
    base = X * Y * Z
    pts = np.random.RandomState(0).uniform(-5, 5, (base, 3)).astype(np.float32)
    kw = dict(chunk_points=base // 4, grow=True, grid_dim=(X, Y, Z), coherent=True)
    frames = np.array([[-2, 1], [0.5, 4], [3, 7]], np.float32)

    def jencode(variables, imgs, projs, poses):
        return {"h": imgs[0, 0], "cls": imgs[0, 1].astype(jnp.int32)}

    def jquery(block, q):
        sigma = jnp.where(block[0, :, 2] > q["h"], 50.0, 0.0)
        return sigma[None], jax.nn.one_hot(jnp.zeros((block.shape[1],), jnp.int32) + q["cls"], 19)[None]

    def encode(imgs, projs, poses):
        return {"h": imgs[0, 0], "cls": imgs[0, 1].long()}

    def query(block, q):
        sigma = torch.where(block[0, :, 2] > q["h"], 50.0, 0.0)
        return sigma[None], torch.nn.functional.one_hot(q["cls"].expand(block.shape[1]), 19).float()[None]

    jstep = J.make_sharded_frame_predictor(jencode, J.make_grid_predictor(jquery, jit=False, **kw), jmake_mesh(2))
    predict = S.make_grid_predictor(query, **kw)
    step = S.make_sharded_frame_predictor(lambda d: (encode, predict), [CPU] * 2)
    tpts = torch.from_numpy(pts)
    for group in ([0, 1], [2]):
        sub = torch.from_numpy(frames[group])
        sigmas, segs = step(tpts, sub, sub, sub)
        assert sigmas.shape == (len(group), X, Y, Z) and segs.shape == (len(group), X, Y, Z)
        padded = frames[group + [group[-1]] * (2 - len(group))]
        jsig, jseg = jstep({}, jnp.asarray(pts), jnp.asarray(padded), jnp.zeros((2, 1)), jnp.zeros((2, 1)))
        for j, f in enumerate(group):
            one = predict(tpts, encode(sub[j:j + 1], None, None))
            assert torch.equal(sigmas[j], one[0]) and torch.equal(segs[j], one[1])
            np.testing.assert_array_equal(sigmas[j].numpy(), np.asarray(jsig[j]))
            np.testing.assert_array_equal(segs[j].numpy(), np.asarray(jseg[j]))
    with pytest.raises(ValueError, match="3 frames for 2 devices"):
        step(tpts, *(torch.from_numpy(frames),) * 3)


# ------------------------------------------------------------ the 2D evaluator
def _five_frames():
    rng = np.random.default_rng(5)
    batches = [_batch(s) for s in (0, 1, 2)]
    return [{"imgs": b["imgs"][j, :1], "projs": b["projs"][j, :1], "poses": np.eye(4, dtype=np.float32)[None],
             "segs": rng.integers(-1, 4, size=(1, 32, 64))} for b in batches for j in range(2)][:5]


def test_run_sharded_is_run_exactly_and_matches_jaxs(setup):  # noqa: F811
    """5 frames over 4 devices (a short second group): every confusion and
    metric of run() exactly; against JAX's run_sharded on a mesh of 4, the
    confusions within two counts per pixel near a tie."""
    from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig
    from scenedino_torch.utils.convert import load_jax_head

    head = SemanticHead(SemanticHeadConfig(**HEAD))
    load_jax_head(head, setup["hvars"])
    ours = Seg2DEvaluator(field=setup["model"], head=head.eval(), image_size=(32, 64), n_coarse=8, n_classes=5)
    frames = _five_frames()
    res = ours.run_sharded(frames, [CPU] * 4, draws=_frame_draws)
    seq = ours.run(frames, draws=_frame_draws)
    assert res["n_frames"] == seq["n_frames"] == 5
    for mode in MODES:
        _equal_tree(res[mode], seq[mode])
    below = 0
    for i, f in enumerate(frames):
        with torch.no_grad():
            feats = ours.field.expand_dim(ours.render(*(torch.from_numpy(f[k])[None] for k in ("imgs", "projs",
                                                                                           "poses")),
                                                      _frame_draws(i))[1])
        for mode in MODES:
            top2 = torch.topk(_scores(head, feats, mode), 2, -1).values
            below += int(((top2[..., 0] - top2[..., 1]) <= MARGIN).sum())
    ref = JSeg2DEvaluator(field=setup["jfield"], head=setup["jhead"], field_params=setup["params"],
                          head_variables=setup["hvars"], image_size=(32, 64), n_coarse=8, n_classes=5)
    jres = ref.run_sharded(frames, mesh=jmake_mesh(4))
    assert jres["n_frames"] == 5
    for mode in MODES:
        diff = np.abs(res[mode]["confusion_matrix"] - np.asarray(jres[mode]["confusion_matrix"])).sum()
        assert diff <= 2 * below, (mode, diff, below)


# ----------------------------------------------------------------- the CLIs
def test_sscbench_cli_data_parallel_equals_the_sequential_run(runs, ssc_tree, monkeypatch):  # noqa: F811
    """cli.evaluate_sscbench over both frames of the tree, in turn and
    --data-parallel on 2 and on 3 devices (a short group): the same
    accumulated numbers and table. The query is the --pipelined test's
    stand-in (it depends on the frame's encoding), so a frame out of turn
    changes the numbers."""

    def stand_in(field, head, prediction_mode, fast):
        def query_fn(block, qstate):
            m = qstate.folded_grid.float().mean()
            x, z = block[0, :, 0], block[0, :, 2]
            sigma = torch.nn.functional.softplus(40.0 * torch.sin(3.0 * x + 100.0 * m) - 0.1 * z)
            label = (torch.floor(7.0 * z + 1e3 * m) % S.N_LABELS).long()
            return sigma[None], (label[:, None] == torch.arange(19)).float()[None]

        return query_fn

    monkeypatch.setattr(evaluate_sscbench, "make_query_fn", stand_in)
    args = _ssc_args(runs, ssc_tree) + ["--voxel-gt", str(ssc_tree / "voxel_gt")]
    table, acc = evaluate_sscbench.main(args)
    assert acc.results[51.2]["tp"] > 0
    for n in (2, 3):
        monkeypatch.setattr(evaluate_sscbench, "make_mesh", lambda device, n=n: [device] * n)
        ptable, pacc = evaluate_sscbench.main(args + ["--data-parallel", "--pipelined"])
        _equal_tree(pacc.results, acc.results)
        assert {k: v for k, v in ptable.items() if k != "sec_per_frame"} == {
            k: v for k, v in table.items() if k != "sec_per_frame"}


def test_2d_cli_data_parallel_equals_the_sequential_run(runs, cityscapes, tmp_path, capsys, monkeypatch):  # noqa: F811
    conf = {"seed": 0, "model": MODEL, "downstream": HEAD,
            "dataset": {"type": "Cityscapes_seg", "data_path": str(cityscapes), "image_size": [32, 64]}}
    save_run_config(str(tmp_path), conf)
    args = ["--config", str(tmp_path), "--ckpt", str(runs["stage2"]), "--device", "cpu"]
    out = evaluate.main(args)
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(out))
    monkeypatch.setattr(evaluate, "make_mesh", lambda device: [device] * 2)
    assert evaluate.main(args + ["--data-parallel"]) == out
