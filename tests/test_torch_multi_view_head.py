"""The multi-view heads, their tokens and IBRNet with NeuRay
(`scenedino_torch/models/multi_view_head.py`) against the JAX package's on
the CPU, on the same numpy-drawn weights carried across by
`utils.convert.from_jax_params` (strict).

Every head type with each embedding encoder, token and attention kind,
in both mask modes ("additive": the float 0/1 mask added to the logits;
"fill": -1e9), on (6, 4, 3, 20) features with seeded invalid views (one
point with all views invalid), and the NeuRay token on rays of 4 points;
IBRNetWithNeuRay on (3, 4, 5) samples x views. All JAX references run in
one jitted call. The view dropout in training mode: the keep mask is the
one flax draws (caught from `jax.random.bernoulli`), given to the port as
`keep`; kept views carry the negative "invalid" values 1 - 1 / (1 - p).
fp32, JAX at "highest" matmul precision; outputs atol 1e-5, rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedino_tpu.models import multi_view_head as J
from scenedino_torch.models import multi_view_head as M
from scenedino_torch.models.backbone_util import make_backbone
from scenedino_torch.models.heads import MULTI_VIEW_HEADS, make_head
from scenedino_torch.utils.convert import from_jax_params
from tests.test_torch_stage1_branches import _draw_tree

D_IN, D_OUT = 20, 7
SHAPE = (6, 4, 3)  # points, points, views
K, RBS = 4, 16  # NeuRay token: points a ray, bottleneck width
RESNET = {"n_blocks": 2, "d_hidden": 16}

HEADS = {
    "mvh-ff-fixed-torch": ("MultiViewHead", {"embedding_encoder": {"type": "ff", "d_out": 16},
                                             "attn_layers": {"n_layers": 2, "n_heads": 4}}),
    "mvh-pwf-data-ibr": ("MultiViewHead", {"embedding_encoder": {"type": "pwf", "d_out": 8},
                                           "attn_layers": {"n_layers": 2, "n_heads": 2, "IBRAttn": True},
                                           "independent_token": {"type": "DataViewIndependentToken"}}),
    "mvh-hpwf": ("MultiViewHead", {"embedding_encoder": {"type": "hpwf", "d_out": 8},
                                   "attn_layers": {"n_layers": 1, "n_heads": 2}}),
    "mvh-ffh-neuray": ("MultiViewHead", {"embedding_encoder": {"type": "ffh", "d_out": 8},
                                         "attn_layers": {"n_layers": 1, "n_heads": 2},
                                         "independent_token": {"type": "NeuRayIndependentToken",
                                                               "args": {"n_points_per_ray": K, "in_feat_ch": 6,
                                                                        "rbs": RBS}}}),
    "mvh-none": ("MultiViewHead", {"attn_layers": {"n_layers": 1, "n_heads": 4}}),
    "simple": ("SimpleMultiViewHead", {"mlp": {"args": {**RESNET, "beta": 2.0}}}),
    "mvh2-token-attn-mlp2": ("MultiViewHead2", {"mlp": {"args": RESNET}, "mlp2": {"d_in": 8, "args": RESNET},
                                                "attn_layers": {"n_layers": 1, "n_heads": 2},
                                                "independent_token": {"type": "FixedViewIndependentToken"}}),
    "mvh2-ibr-blend": ("MultiViewHead2", {"mlp": {"args": RESNET},
                                          "attn_layers": {"n_layers": 1, "n_heads": 2, "IBRAttn": True}}),
    "mvh2-data-readout": ("MultiViewHead2", {"mlp": {"args": RESNET}, "attn_layers": {"n_layers": 1, "n_heads": 4},
                                             "independent_token": {"type": "DataViewIndependentToken"}}),
    "mvh2-mlp2-blend": ("MultiViewHead2", {"mlp": {"args": RESNET}, "mlp2": {"d_in": 6, "args": RESNET}}),
    "mvh3": ("MultiViewHead3", {"mlp": {"args": RESNET}, "mlp2": {"d_in": 6, "args": RESNET}}),
}
MASKED = ("MultiViewHead", "MultiViewHead2")  # the heads with a mask_mode
CASES = [(name, mode) for name, (kind, _) in HEADS.items()
         for mode in (("additive", "fill") if kind in MASKED else ("additive",))]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*SHAPE, D_IN)).astype(np.float32)
    inv = rng.random(SHAPE) < 0.35
    inv[0, 0] = True  # a point no view sees
    inv[1, 0] = False
    extra = {"bottleneck_feats": rng.normal(size=(*SHAPE, RBS)).astype(np.float32),
             "ray_diff": rng.normal(size=(*SHAPE, 4)).astype(np.float32)}
    return x, inv, extra


def _case(name, x, inv, extra):
    """A case's (features, invalid, token inputs): the NeuRay token takes
    flat (N, V, C) points, N a whole number of rays."""
    if "neuray" not in name:
        return x, inv, {}
    V = SHAPE[-1]
    return x.reshape(-1, V, x.shape[-1]), inv.reshape(-1, V), {k: v.reshape(-1, V, v.shape[-1])
                                                                 for k, v in extra.items()}


@pytest.fixture(scope="module")
def references():
    """Every (head, mask mode)'s JAX module, weights and output, and
    IBRNetWithNeuRay's, from one jitted call."""
    x, inv, extra = _inputs()

    def jcase(name):
        cx, cinv, ckw = _case(name, x, inv, extra)
        return jnp.asarray(cx), jnp.asarray(cinv), {k: jnp.asarray(v) for k, v in ckw.items()}

    mods, params = {}, {}
    for i, (name, mode) in enumerate(CASES):
        kind, conf = HEADS[name]
        mod = J.make_multi_view_head(kind, conf, D_IN, D_OUT)
        if kind in MASKED:
            mod = mod.clone(mask_mode=mode)
        jx, jinv, kw = jcase(name)
        shapes = jax.eval_shape(lambda m=mod, a=(jx, jinv, kw): m.init(jax.random.PRNGKey(0), a[0],
                                                                       invalid_features=a[1], **a[2]))
        mods[name, mode], params[name, mode] = mod, _draw_tree(shapes, 10 + i)
    ibr = J.IBRNetWithNeuRay(neuray_in_dim=5, in_feat_ch=8, att_feat=6, rbs=RBS)
    rng = np.random.default_rng(3)
    ibr_in = [rng.normal(size=(3, 4, 5, c)).astype(np.float32) for c in (RBS, 5, 4)]
    mask = (rng.random((3, 4, 5, 1)) > 0.3).astype(np.float32)
    mask[0, 0] = 0.0
    ibr_in.append(mask)
    ibr_params = _draw_tree(jax.eval_shape(lambda: ibr.init(jax.random.PRNGKey(0), *map(jnp.asarray, ibr_in))), 40)

    @jax.jit
    def run(ps, ibr_p):
        heads = {}
        for c in CASES:
            jx, jinv, kw = jcase(c[0])
            heads[c] = mods[c].apply(ps[c], jx, invalid_features=jinv, **kw)
        return heads, ibr.apply(ibr_p, *map(jnp.asarray, ibr_in))

    outs, ibr_out = run(params, ibr_params)
    return dict(x=x, inv=inv, extra=extra, mods=mods, params=params, outs=outs, ibr=(ibr_in, ibr_params, ibr_out))


def _port_head(name, mode, params):
    kind, conf = HEADS[name]
    head = make_head({"type": kind, "args": conf}, D_IN, D_OUT)
    head.mask_mode = mode
    state, skipped = from_jax_params(params["params"])
    assert skipped == []
    head.load_state_dict(state, strict=True)
    return head


@pytest.mark.parametrize("name,mode", CASES, ids=[f"{n}-{m}" for n, m in CASES])
def test_head_matches_jax(references, name, mode):
    x, inv, kw = _case(name, references["x"], references["inv"], references["extra"])
    head = _port_head(name, mode, references["params"][name, mode])
    with torch.no_grad():
        out = head(_t(x), invalid_features=torch.from_numpy(inv), **{k: _t(v) for k, v in kw.items()}).numpy()
    ref = np.asarray(references["outs"][name, mode])
    assert out.shape == ref.shape == (*x.shape[:-2], 1, D_OUT)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_additive_and_fill_masks_differ(references):
    """The reference's float mask is a +1 bias, not a mask: the two modes
    give different outputs on the same weights."""
    x, inv = references["x"], references["inv"]
    head = _port_head("mvh-ff-fixed-torch", "additive", references["params"]["mvh-ff-fixed-torch", "additive"])
    with torch.no_grad():
        additive = head(_t(x), invalid_features=torch.from_numpy(inv))
        head.mask_mode = "fill"
        fill = head(_t(x), invalid_features=torch.from_numpy(inv))
    assert float((additive - fill).abs().max()) > 1e-3


def test_ibrnet_with_neuray_matches_jax(references):
    ibr_in, params, ref = references["ibr"]
    model = make_backbone({"type": "ibrnet", "neuray_in_dim": 5, "in_feat_ch": 8, "att_feat": 6, "rbs": RBS})
    model.load_state_dict(from_jax_params(params["params"])[0], strict=True)
    with torch.no_grad():
        out = model(*map(_t, ibr_in)).numpy()
    assert out.shape == (3, 4, 6)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)


DROPOUT = {"mvh-hpwf": False, "simple": True}  # the case: do_mvh (view 0 never dropped)


@pytest.fixture(scope="module")
def dropout_refs(references):
    """Training mode at rate 0.4 for the DROPOUT cases, in one jitted call:
    each output and the Bernoulli keep mask flax drew for it (caught from
    `jax.random.bernoulli` while the call is traced)."""
    x, inv = jnp.asarray(references["x"]), jnp.asarray(references["inv"])
    mods = {}
    for name, do_mvh in DROPOUT.items():
        kind, conf = HEADS[name]
        mods[name] = J.make_multi_view_head(kind, {**conf, "dropout_views_rate": 0.4,
                                                   "dropout_multiviewhead": do_mvh}, D_IN, D_OUT)
    caught = []
    bernoulli = jax.random.bernoulli

    def catch(*a, **k):
        caught.append(bernoulli(*a, **k))
        return caught[-1]

    def run(ps):
        caught.clear()
        outs = {n: m.apply(ps[n], x, invalid_features=inv, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(7)}) for n, m in mods.items()}
        return outs, list(caught)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "bernoulli", catch)
    try:
        outs, keeps = jax.jit(run)({n: references["params"][n, "additive"] for n in DROPOUT})
    finally:
        mp.undo()
    return {n: (np.asarray(outs[n]), np.array(k)) for n, k in zip(DROPOUT, keeps)}


@pytest.mark.parametrize("name", list(DROPOUT))
def test_view_dropout_matches_jax(references, dropout_refs, name):
    """Training mode at rate 0.4: flax's own Bernoulli draw as the port's
    `keep`; deterministic calls ignore it."""
    x, inv = references["x"], references["inv"]
    do_mvh = DROPOUT[name]
    kind, conf = HEADS[name]
    conf = {**conf, "dropout_views_rate": 0.4, "dropout_multiviewhead": do_mvh}
    ref, keep = dropout_refs[name]
    assert keep.shape == SHAPE
    head = make_head({"type": kind, "args": conf}, D_IN, D_OUT)
    head.load_state_dict(from_jax_params(references["params"][name, "additive"]["params"])[0], strict=True)
    with torch.no_grad():
        out = head(_t(x), invalid_features=torch.from_numpy(inv), deterministic=False,
                   keep=torch.from_numpy(keep)).numpy()
        still = head(_t(x), invalid_features=torch.from_numpy(inv), keep=torch.from_numpy(keep)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(still, np.asarray(references["outs"][name, "additive"]), atol=1e-5, rtol=1e-5)
    dropped = M._dropout_views(torch.from_numpy(inv), 0.4, do_mvh, False, keep=torch.from_numpy(keep))
    kept = (~torch.from_numpy(inv)) & torch.from_numpy(keep)
    if do_mvh:
        kept[..., 0] = False
    assert torch.allclose(dropped[kept], torch.tensor(1.0 - 1.0 / 0.6))
    g = torch.Generator().manual_seed(0)
    drawn = M._dropout_views(torch.from_numpy(inv), 0.4, do_mvh, False, generator=g)
    assert drawn.shape == SHAPE and (drawn < 0).any()


def test_factories_build_every_type():
    for kind in MULTI_VIEW_HEADS:
        assert isinstance(make_head({"type": kind, "args": {}}, D_IN, D_OUT), getattr(M, kind))
    with pytest.raises(ValueError, match="NeuRayIndependentToken needs"):
        head = make_head({"type": "MultiViewHead", "args": dict(HEADS["mvh-ffh-neuray"][1])}, D_IN, D_OUT)
        head(torch.zeros(8, 3, D_IN), invalid_features=torch.zeros(8, 3, dtype=torch.bool))
