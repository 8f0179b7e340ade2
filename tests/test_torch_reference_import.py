"""The port's import of the reference's torch checkpoints
(`utils/convert.py`, `utils/checkpoint.py`) against the JAX package's
converter (`scenedino_tpu/utils/checkpoint.py:159-528`) on the CPU.

The state dicts are drawn with numpy in the reference's BTSWrapper names
(tests/test_checkpoint_schema.py's `reference_state_dict`: the tiny
shipped architecture, ViT width 32, depth 3, patch 8), then varied: DINOv2's
LayerScale under `.gamma` or `.weight` with registers under `reg_token` or
`register_tokens`, the ViT wrapped as `encoder.model`, the orthogonal dim
reduction, the learned empty feature, ResnetFC blocks with a shortcut, MLP
probes. Each converts through both packages; the port's tensors must be
`from_jax_params` of JAX's result bit for bit, with the same names (the
head's pseudo assignments as int64), and strict mode must name the same
unconsumed keys. The self-supervised backbones' surgery is held the same
way for every kind. A field built from a converted checkpoint then runs
against the JAX SceneField on the same weights: the encode's grid, and a
voxel query's sigma and 768-d features within atol 1e-4 / rtol 1e-4 (fp32,
JAX at "highest" precision: the same sums in another order), the labels
equal where the head's top two cluster scores differ by more than 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedino_tpu.models.downstream import SemanticHead as JSemanticHead
from scenedino_tpu.models.downstream import SemanticHeadConfig as JSemanticHeadConfig
from scenedino_tpu.models.factory import make_model as j_make_model
from scenedino_tpu.models.field import SceneField as JSceneField
from scenedino_tpu.models.vit import VIT_PRESETS as JVIT_PRESETS
from scenedino_tpu.models.vit import VisionTransformer as JVisionTransformer
from scenedino_tpu.utils import checkpoint as CK
from scenedino_torch.cli import train as train_cli
from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig, _norm
from scenedino_torch.models.factory import make_model
from scenedino_torch.models.vit import make_vit
from scenedino_torch.utils import convert as C
from scenedino_torch.utils.checkpoint import load_eval_state
from tests.test_checkpoint_schema import (CODE_DIM, D_VIT, DEPTH, GT_CLS, IMG, N_CLS, PCA, reference_state_dict,
                                          tiny_model_conf)

NET = "renderer.net"
ENC = f"{NET}.encoder"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _variant(name, with_downstream=True):
    """reference_state_dict, varied as `name` says."""
    sd = reference_state_dict(with_downstream=with_downstream)
    rng = np.random.RandomState(7)

    def draw(*shape):
        return rng.randn(*shape).astype(np.float32)

    if name.startswith("layerscale"):  # DINOv2: LayerScale, registers (both ViTs)
        _, ls_key, reg_key = name.split("-")
        for vit in (f"{ENC}.encoder.vit", f"{ENC}.gt_encoder.vit"):
            for i in range(DEPTH):
                for ls in ("ls1", "ls2"):
                    sd[f"{vit}.blocks.{i}.{ls}.{ls_key}"] = draw(D_VIT)
            sd[f"{vit}.{reg_key}"] = draw(1, 4, D_VIT)
    elif name == "model-wrapping":  # the ViTs wrapped without the FX graph module
        sd = {k.replace(".encoder.vit.", ".encoder.model.").replace(".gt_encoder.vit.", ".gt_encoder.model."): v
              for k, v in sd.items()}
    elif name == "orthogonal":
        for k in [k for k in sd if ".dim_reduction." in k]:
            del sd[k]
        sd[f"{ENC}.dim_reduction.weights"] = draw(D_VIT, PCA)
        sd[f"{ENC}.dim_reduction.bias"] = draw(D_VIT)
    elif name == "learn-empty":
        sd[f"{NET}.empty_feature"] = draw(8)
    elif name == "resnet-blocks":
        h = f"{NET}.heads.normal_head"
        for i in range(2):
            for fc in ("fc_0", "fc_1"):
                sd[f"{h}.blocks.{i}.{fc}.weight"] = draw(24, 24)
                sd[f"{h}.blocks.{i}.{fc}.bias"] = draw(24)
        sd[f"{h}.blocks.1.shortcut.weight"] = draw(24, 24)
    elif name == "mlp-probes":
        for probe, d_in in (("direct_linear_head", D_VIT), ("stego_linear_head", CODE_DIM)):
            p = f"{NET}.downstream_head.{probe}"
            del sd[f"{p}.linear.weight"], sd[f"{p}.linear.bias"]
            sd.update({f"{p}.linear1.weight": draw(d_in, d_in), f"{p}.linear1.bias": draw(d_in),
                       f"{p}.linear2.weight": draw(GT_CLS, d_in), f"{p}.linear2.bias": draw(GT_CLS)})
    # buffers that carry no weight, as real checkpoints hold them
    sd[f"{NET}.downstream_head.direct_cluster_head.centroids_initialized"] = np.ones((), np.float32)
    sd[f"{ENC}.decoder.bn.num_batches_tracked"] = np.zeros((), np.float32)
    return sd


def _jax_reference(sd):
    """(field state_dict, head state_dict or None, artifact) of JAX's strict converter, in the port's names."""
    conv = CK.convert_scenedino_checkpoint(sd, strict=True)
    params = dict(conv["params"])
    down = params.pop("downstream", None)
    field = C.from_jax_params(params)[0]
    head = None if down is None else C.head_state_from_jax({"params": down, "state": conv["state"]["downstream"]})
    return field, head, conv.get("artifact_field")


def _same(got, want):
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


VARIANTS = ["v1", "layerscale-gamma-reg_token", "layerscale-weight-register_tokens", "model-wrapping",
            "orthogonal", "learn-empty", "resnet-blocks", "mlp-probes"]


@pytest.mark.parametrize("variant,with_downstream", [(v, True) for v in VARIANTS]
                         + [(v, False) for v in VARIANTS if v != "mlp-probes"])  # the probes are the head's
def test_reference_import_matches_jax_bit_for_bit(variant, with_downstream):
    sd = _variant(variant, with_downstream)
    field, head, artifact = _jax_reference(sd)
    for source in (sd, {k: torch.from_numpy(v) for k, v in sd.items()}):  # numpy arrays or torch tensors
        out = C.convert_scenedino_checkpoint(source)
        _same(out.field, field)
        if with_downstream:
            _same(out.head, head)
            assert out.head["stego_cluster_head.pseudo_assignment"].dtype == torch.int64
        else:
            assert out.head is None
        np.testing.assert_array_equal(out.artifact_field.numpy(), artifact)
    # the inverse mapping writes the same names back (the ignorable buffers aside)
    back = C.to_reference_layout(out.field, out.head, out.artifact_field)
    kept = {k for k in sd if not k.endswith(("centroids_initialized", "num_batches_tracked"))
            and ".code_xyz." not in k}
    if variant == "layerscale-weight-register_tokens":  # written back under the timm names
        kept = {k.replace(".weight", ".gamma") if ".ls" in k else k.replace("register_tokens", "reg_token")
                for k in kept}
    if variant == "model-wrapping":
        kept = {k.replace(".model.", ".vit.") for k in kept}
    assert set(back) == kept


def test_strict_mode_flags_the_same_unconsumed_keys():
    sd = _variant("v1")
    sd[f"{NET}.heads.normal_head.blocks.0.fc_0.weight_oops"] = np.zeros((2, 2), np.float32)
    sd[f"{ENC}.decoder.extra_conv.weight"] = np.zeros((2, 2, 3, 3), np.float32)
    sd["artifact_field_extra"] = np.zeros(2, np.float32)  # outside renderer.net: not the converter's
    with pytest.raises(ValueError, match="unconsumed") as jerr:
        CK.convert_scenedino_checkpoint(sd, strict=True)
    with pytest.raises(ValueError, match="unconsumed") as err:
        C.convert_scenedino_checkpoint(sd)
    assert str(err.value) == str(jerr.value)
    assert "extra_conv" in str(err.value) and "artifact_field_extra" not in str(err.value)


@pytest.mark.parametrize("keys", [(), ("ls1.gamma",), ("ls1.weight",), ("reg_token",), ("register_tokens",),
                                  ("ls1.gamma", "register_tokens")])
def test_infer_vit_meta_matches_jax(keys):
    rng = np.random.RandomState(1)
    sd = {k.replace(f"{ENC}.encoder.vit", "m"): v for k, v in reference_state_dict(False).items()
          if k.startswith(f"{ENC}.encoder.vit.")}
    for key in keys:
        if key.startswith("ls1"):
            sd[f"m.blocks.0.{key}"] = rng.randn(D_VIT)
        else:
            sd[f"m.{key}"] = rng.randn(1, 4, D_VIT)
    got = C.infer_vit_meta({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, "m")
    assert got == CK.infer_vit_meta(sd, "m")
    assert got == (DEPTH, 4 if any("reg" in k for k in keys) else 0, any("ls1" in k for k in keys))


def _ssl_raw(kind, rng, dim=8):
    """A published checkpoint of `kind` in its own schema, at width `dim`
    and the preset's depth."""
    cfg = JVIT_PRESETS[kind]
    n = 6  # patch tokens of the stored position embedding
    timm = {"patch_embed.proj.weight": rng.rand(dim, 3, 2, 2), "patch_embed.proj.bias": rng.rand(dim),
            "pos_embed": rng.rand(1, n + cfg.class_token, dim), "norm.weight": rng.rand(dim),
            "norm.bias": rng.rand(dim)}
    if cfg.class_token:
        timm["cls_token"] = rng.rand(1, 1, dim)
    for i in range(cfg.depth):
        for name, shape in (("norm1", (dim,)), ("norm2", (dim,)), ("attn.qkv", (3 * dim, dim)),
                            ("attn.proj", (dim, dim)), ("mlp.fc1", (4 * dim, dim)), ("mlp.fc2", (dim, 4 * dim))):
            timm[f"blocks.{i}.{name}.weight"] = rng.rand(*shape)
            timm[f"blocks.{i}.{name}.bias"] = rng.rand(shape[0])
    extras = {"head.weight": rng.rand(3, dim), "fc_norm.weight": rng.rand(dim)}
    if kind == "mae_base":
        raw = timm
    elif kind == "synclr_base":
        raw = {**{f"module.visual.{k}": v for k, v in timm.items()}, "module.other.weight": rng.rand(2)}
    elif kind == "mocov3_base":
        raw = {**{f"module.momentum_encoder.{k}": v for k, v in {**timm, **extras}.items()},
               **{f"module.base_encoder.{k}": v for k, v in timm.items()}}
    elif kind in ("msn_base", "self_patch_small", "i_jepa_huge"):
        raw = {f"module.{k}": v for k, v in {**timm, **extras, "fc.weight": rng.rand(2, dim)}.items()}
    else:  # vmae_large: split position embeddings, a tubelet of 2 frames, separate q, k and v
        raw = {k: v for k, v in timm.items() if not k.startswith(("pos_embed", "patch_embed.proj.weight"))
               and ".attn.qkv." not in k}
        raw.update({"pos_embed_spatial": rng.rand(1, n, dim), "pos_embed_temporal": rng.rand(1, 4, dim),
                    "pos_embed_class": rng.rand(1, 1, dim), "patch_embed.proj.weight": rng.rand(dim, 3, 2, 2, 2)})
        for i in range(cfg.depth):
            for name in "qkv":
                raw[f"blocks.{i}.attn.{name}.weight"] = rng.rand(dim, dim)
                raw[f"blocks.{i}.attn.{name}.bias"] = rng.rand(dim)
    return {k: np.asarray(v, np.float32) for k, v in raw.items()}


SSL_KINDS = ["mae_base", "synclr_base", "mocov3_base", "msn_base", "self_patch_small", "i_jepa_huge", "vmae_large"]


@pytest.mark.parametrize("kind", SSL_KINDS)
def test_ssl_backbone_import_matches_jax(kind):
    raw = _ssl_raw(kind, np.random.RandomState(SSL_KINDS.index(kind)))
    adapted = C.adapt_ssl_state_dict(kind, {k: torch.from_numpy(v) for k, v in raw.items()})
    jadapted = CK.adapt_ssl_state_dict(kind, raw)
    assert adapted.keys() == jadapted.keys()
    for k, v in jadapted.items():
        np.testing.assert_array_equal(adapted[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    _same(C.convert_ssl_vit(kind, raw), C.from_jax_params(CK.convert_ssl_vit(kind, raw))[0])


def test_ssl_backbone_runs_as_the_reference():
    """A converted MAE backbone (cut to width 16, depth 2, 2 heads) in the
    port's VisionTransformer against JAX's on the converted tree."""
    kind, overrides = "mae_base", {"width": 16, "depth": 2, "num_heads": 2, "pos_embed_size": (32, 48)}
    rng = np.random.RandomState(9)
    raw = {"patch_embed.proj.weight": rng.randn(16, 3, 16, 16) / 28, "patch_embed.proj.bias": 0.1 * rng.randn(16),
           "cls_token": rng.randn(1, 1, 16), "pos_embed": 0.1 * rng.randn(1, 7, 16),
           "norm.weight": 1 + 0.1 * rng.randn(16), "norm.bias": 0.1 * rng.randn(16)}
    for i in range(12):
        for name, shape in (("norm1", (16,)), ("norm2", (16,)), ("attn.qkv", (48, 16)), ("attn.proj", (16, 16)),
                            ("mlp.fc1", (64, 16)), ("mlp.fc2", (16, 64))):
            w = rng.randn(*shape)
            raw[f"blocks.{i}.{name}.weight"] = 1 + 0.1 * w if len(shape) == 1 else w / np.sqrt(shape[1])
            raw[f"blocks.{i}.{name}.bias"] = 0.1 * rng.randn(shape[0])
    raw = {k: np.asarray(v, np.float32) for k, v in raw.items()}
    # the preset's 12 blocks convert; the cut model keeps the first 2
    state = {k: v for k, v in C.convert_ssl_vit(kind, raw).items()
             if not (k.startswith("blocks.") and int(k.split(".")[1]) >= 2)}
    model = make_vit(kind, intermediate_layers=(0, 1), overrides=overrides)
    model.load_state_dict(state)
    jtree = {k: v for k, v in CK.convert_ssl_vit(kind, raw).items()
             if not (k.startswith("blocks_") and int(k.split("_")[1]) >= 2)}
    jcfg = dataclasses.replace(JVIT_PRESETS[kind], **overrides, intermediate_layers=(0, 1))
    x = np.random.default_rng(4).uniform(size=(2, 3, 32, 48)).astype(np.float32)
    ref = JVisionTransformer(cfg=jcfg, want_key_features=False).apply({"params": jtree}, jnp.asarray(x))
    out = model(torch.from_numpy(x))
    for name in ref:
        np.testing.assert_allclose(out[name].detach().numpy(), np.asarray(ref[name]), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


# ---------------------------------------------------------------- the field and the files


def _head_cfg():
    return dict(n_classes=N_CLS, gt_classes=GT_CLS, input_dim=D_VIT, code_dim=CODE_DIM)


@pytest.fixture(scope="module")
def converted():
    """The reference state dict with weights of a usable scale (matrices and
    kernels ~ N(0, 1/fan_in), norm weights ~ 1, the rest ~ N(0, 0.1^2)),
    and JAX's conversion of it."""
    sd = {}
    for k, v in _variant("v1").items():
        if k.endswith("pseudo_assignment") or k == "artifact_field":
            sd[k] = v
        elif k.endswith("weight") and v.ndim >= 2:
            sd[k] = v / np.sqrt(np.prod(v.shape[1:]))
        elif ".norm" in k and k.endswith("weight"):
            sd[k] = 1.0 + 0.1 * v
        else:
            sd[k] = 0.1 * v
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    return sd, CK.convert_scenedino_checkpoint(sd, strict=True)


def _write(path, sd, wrap=True):
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    torch.save({"model": tensors} if wrap else tensors, path)
    return str(path)


@pytest.mark.parametrize("wrap", [True, False], ids=["model", "bare"])
def test_load_eval_state_reads_a_reference_checkpoint(converted, tmp_path, wrap):
    sd, _ = converted
    path = _write(tmp_path / "checkpoint.pt", sd, wrap)
    field_sd, head_sd = load_eval_state(path)
    field, head, _ = _jax_reference(sd)
    _same(field_sd, field)
    _same(head_sd, head)
    ref = C.reference_checkpoint_of(torch.load(path, weights_only=True))
    _same(ref.field, field)
    np.testing.assert_array_equal(ref.artifact_field.numpy(), sd["artifact_field"])
    # the field and head the evaluations build take it strictly
    model = make_model(tiny_model_conf(), device="cpu", training=True)
    model.load_state_dict(field_sd)
    SemanticHead(SemanticHeadConfig(**_head_cfg())).load_state_dict(head_sd)


def test_reference_checkpoints_that_do_not_fit_raise(converted, tmp_path):
    sd, _ = converted
    extra = {**sd, f"{ENC}.decoder.extra_conv.weight": np.zeros((2, 2, 3, 3), np.float32)}
    with pytest.raises(ValueError, match="unconsumed.*extra_conv"):
        load_eval_state(_write(tmp_path / "extra.pt", extra))
    other = _write(tmp_path / "other.pt", {"weights": np.zeros(3, np.float32)})
    assert C.reference_checkpoint_of(torch.load(other, weights_only=True)) is None
    with pytest.raises(ValueError, match="unrecognized checkpoint layout"):
        load_eval_state(other)
    # a checkpoint of another architecture converts, and the model refuses it
    field_sd, _ = load_eval_state(_write(tmp_path / "ok.pt", sd))
    conf = tiny_model_conf()
    conf["encoder"] = {**conf["encoder"], "vit_overrides": {**conf["encoder"]["vit_overrides"], "depth": DEPTH + 1}}
    with pytest.raises(RuntimeError, match="Missing key"):
        make_model(conf, device="cpu", training=True).load_state_dict(field_sd)


def test_train_cli_resumes_stage_2_from_a_reference_checkpoint(converted, tmp_path):
    sd, _ = converted
    path = _write(tmp_path / "checkpoint.pt", sd)
    model = make_model(tiny_model_conf(), device="cpu", training=True)
    assert train_cli.load_field(model, path) == path
    _same(model.state_dict(), _jax_reference(sd)[0])


def test_field_from_a_reference_checkpoint_matches_the_jax_field(converted, tmp_path):
    """Encode and a voxel query with the head, both packages on the converted weights."""
    sd, conv = converted
    jhead = JSemanticHead(cfg=JSemanticHeadConfig(**_head_cfg()))
    jfield = j_make_model(tiny_model_conf(), downstream=jhead)
    variables = {"params": conv["params"], "state": conv["state"]}
    field_sd, head_sd = load_eval_state(_write(tmp_path / "checkpoint.pt", sd))
    model = make_model(tiny_model_conf(), device="cpu", training=True).eval()
    model.load_state_dict(field_sd)
    head = SemanticHead(SemanticHeadConfig(**_head_cfg())).eval()
    head.load_state_dict(head_sd)

    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, size=(1, 1, 3, *IMG)).astype(np.float32)
    ks = np.array([[[[1.2, 0, 0], [0, 2.4, 0], [0, 0, 1]]]], np.float32)
    poses = np.eye(4, dtype=np.float32)[None, None]
    pts = np.stack(np.meshgrid(np.linspace(-6, 6, 8), np.linspace(-2, 2, 4), np.linspace(4, 40, 8),
                               indexing="ij"), -1).reshape(1, -1, 3).astype(np.float32)

    def jquery(v, i, k, c, x):  # compiled once: op by op the encode takes most of the test
        state = jfield.apply(v, i, k, c, ids_encoder=(0,), method=JSceneField.encode)
        return state, jfield.apply(v, state, x, mode="stego_kmeans", method=JSceneField.query_segmentation)

    jstate, (jdino, jsigma, jseg) = jax.jit(jquery)(variables, *(jnp.asarray(a) for a in (imgs, ks, poses, pts)))
    with torch.no_grad():
        state = model.encode(*(torch.from_numpy(a) for a in (imgs, ks, poses)), ids_encoder=(0,))
        dino, sigma, seg = model.query_segmentation(state, torch.from_numpy(pts), head)
        scores = _norm(head.stego_head(_norm(dino))) @ _norm(head.stego_cluster_head.cluster_centers).T
    np.testing.assert_allclose(state.feat_grid.numpy(), np.asarray(jstate.feat_grid), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(dino.numpy(), np.asarray(jdino), atol=1e-4, rtol=1e-4)
    top2 = torch.topk(scores, 2, -1).values
    clear = ((top2[..., 0] - top2[..., 1]) > 1e-4).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(seg.numpy()[clear], np.asarray(jseg)[clear])
