"""Stage 2: distill the frozen feature field into unsupervised semantics
(counterpart of `scenedino_tpu/training/downstream.py:37-407`).

One step renders the encode view of every frame through the folded field
(`render_encode_view_batched`, the K6 kernel) in fp32, expands the 64-d
features to the teacher's 768, samples 3D surface crops around rendered
depths (depth-quantile strata, a random pixel each, 4x oversampled sphere
samples, the densest `n_samples` of them), and trains the STEGO head, the
two cosine-k-means heads and the two linear probes
(`models.downstream.SemanticHead`) with Adam: the STEGO head at lr, the
other heads at lr x head_lr_factor (the reference's two optax Adams, here
two groups of one torch Adam; torch's and optax's Adam updates agree),
with the reference's non-finite step skip. The field and its encoder are
frozen: they run without a graph.

Every random draw of a step is an explicit input (`Stage2Draws`);
`draw_stage2` draws them from a `torch.Generator` with the reference's
distributions. Not ported: the generic (unfolded) full-frame render, taken
by the reference only for a field the fold does not cover or with
`use_fast_render` off; it raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from scenedino_torch.core.ray_sampler import build_frame_rays
from scenedino_torch.losses.stego import StegoLossConfig, stego_loss
from scenedino_torch.models.downstream import HeadDraws, RingBufferState, SemanticHead, SemanticHeadConfig, top_k
from scenedino_torch.models.field import SceneField
from scenedino_torch.ops.fast_field import build_fast_state, can_fold, render_encode_view_batched
from scenedino_torch.ops.kmeans import KMeansPPDraws, draw_kmeans_pp, gumbel, kmeans_plus_plus_init
from scenedino_torch.renderer.nerf import RenderConfig


@dataclasses.dataclass(frozen=True)
class DownstreamTrainConfig:
    lr: float = 1e-3
    head_lr_factor: float = 10.0
    z_near: float = 3.0
    z_far: float = 80.0
    render_height: int = 192
    render_width: int = 640
    n_crops: int = 5
    n_samples: int = 576
    oversampling: int = 4
    sample_radius: float = 0.5
    sigma_threshold: float = 0.5
    side_view_prob: float = 0.5
    mode: str = "3d"
    use_fast_render: bool = True
    # after this many consecutive non-finite steps the update goes through
    # (optax.apply_if_finite); 0 disables the skip
    skip_nonfinite_steps: int = 10


@dataclasses.dataclass
class Stage2Draws:
    """Every random draw of one stage-2 forward.

    side_coin: encode a side view (a fisheye id, training only); side_id
    its view in [min(4, V - 1), V); u (B, H*W, n_coarse) the render's
    strata; in 3d mode pix_gumbel (B, n_crops, H*W) the Gumbel noise of each
    crop's pixel pick, sphere_dirs (B, n_crops, NS, 3) standard normals,
    sphere_u (B, n_crops, NS, 1) the radii's uniforms, tie (B, n_crops, NS)
    the tie-breaks among dense samples (NS = oversampling x n_samples);
    head: the head's draws (kNN pick, random rows, dropout masks).
    """

    side_coin: bool
    side_id: int
    u: torch.Tensor
    pix_gumbel: Optional[torch.Tensor]
    sphere_dirs: Optional[torch.Tensor]
    sphere_u: Optional[torch.Tensor]
    tie: Optional[torch.Tensor]
    head: HeadDraws


def draw_stage2(generator: torch.Generator, cfg: DownstreamTrainConfig, head_cfg: SemanticHeadConfig,
                rcfg: RenderConfig, B: int, V: int, training: bool = True) -> Stage2Draws:
    """A forward's draws from `generator`, on its device."""
    dev = generator.device
    coin, side = torch.rand(2, generator=generator, device=dev).tolist()
    lo = min(4, V - 1)
    R = cfg.render_height * cfg.render_width
    u = torch.rand(B, R, rcfg.n_coarse, generator=generator, device=dev)
    crops = None
    n_crops = 5 * B
    if cfg.mode == "3d":
        NS = cfg.oversampling * cfg.n_samples
        shape = (B, cfg.n_crops, NS)
        crops = (gumbel((B, cfg.n_crops, R), generator, dev), torch.randn(*shape, 3, generator=generator, device=dev),
                 torch.rand(*shape, 1, generator=generator, device=dev), torch.rand(shape, generator=generator, device=dev))
        n_crops = B * cfg.n_crops
    head = HeadDraws.draw(n_crops, head_cfg, generator, dev, deterministic=not training)
    return Stage2Draws(coin < cfg.side_view_prob, lo + min(int(side * (V - lo)), V - lo - 1), u,
                       *(crops or (None,) * 4), head)


def _fast_render_applies(field: SceneField, cfg: DownstreamTrainConfig, rcfg: RenderConfig) -> bool:
    """The reference's guard of the folded full-frame render
    (training/downstream.py:196-212)."""
    return (cfg.use_fast_render and can_fold(field) and rcfg.n_fine == 0 and rcfg.n_fine_depth == 0
            and rcfg.noise_std == 0.0 and not rcfg.white_bkgd and rcfg.render_mode == "volumetric"
            and (cfg.z_near, cfg.z_far) == (field.cfg.z_near, field.cfg.z_far))


@torch.no_grad()
def render_frames(field: SceneField, batch: Dict[str, torch.Tensor], u: torch.Tensor, enc_id: int,
                  cfg: DownstreamTrainConfig, rcfg: RenderConfig):
    """The frozen full-frame render of view `enc_id` of every frame: pose
    rebase, encode, the fp32 fold, the encode-view render (K6), the 64 ->
    768 expansion. Returns (rendered {"depth" (B, H, W), "dino_features"
    (B, 1, H, W, 1, 768), "rgb" (B, H*W, 3)}, the scene state, the rebased
    poses and the intrinsics of the encode view)."""
    if not _fast_render_applies(field, cfg, rcfg):
        raise NotImplementedError("the generic (unfolded) stage-2 render is not ported: it needs a foldable field, "
                                  "use_fast_render, no fine pass and the field's z range")
    imgs, poses, projs = batch["imgs"], batch["poses"], batch["projs"]
    B = imgs.shape[0]
    H, W = cfg.render_height, cfg.render_width
    imgs_e = imgs[:, enc_id:enc_id + 1]
    poses_e, projs_e = poses[:, enc_id:enc_id + 1].float(), projs[:, enc_id:enc_id + 1].float()
    poses_e = torch.linalg.inv_ex(poses_e[:, :1]).inverse @ poses_e  # rebase; no host sync, as in JAX
    state = field.encode(imgs_e, projs_e, poses_e, ids_encoder=(0,))
    # fp32 fold: the training path's numbers match the generic renderer's (bf16 grids are a serving choice)
    fs = build_fast_state(field, state, compute_dtype=torch.float32)
    depth, dino64, rgb = render_encode_view_batched(fs, field.cfg, H, W, u=u, n_coarse=rcfg.n_coarse,
                                                    lindisp=rcfg.lindisp, hard_alpha_cap=rcfg.hard_alpha_cap)
    dino768 = field.expand_dim(dino64.reshape(B, 1, H, W, 1, -1))
    return {"depth": depth, "dino_features": dino768, "rgb": rgb.reshape(B, H * W, 3)}, state, poses_e, projs_e


def _quantile_levels(n: int, device) -> torch.Tensor:
    """`jnp.linspace(0, 1, n + 1)` bit for bit: i x fl(1 / n), the last 1."""
    q = torch.arange(n + 1, device=device, dtype=torch.float32) * torch.tensor(1.0 / n, dtype=torch.float32)
    q[-1] = 1.0
    return q


@torch.no_grad()
def sample_3d_crops(field: SceneField, state, depth: torch.Tensor, poses: torch.Tensor, projs: torch.Tensor,
                    draws: Stage2Draws, cfg: DownstreamTrainConfig):
    """Surface crops (trainer_downstream.py:216-292) with masks in place of
    the reference's ragged filtering. depth (B, H, W) rendered; poses,
    projs (B, 1, ...) of the encode view. Returns (the crops' 768-d
    features (B, n_crops, n_samples, 768), crop_valid (B, n_crops)).

    Per frame the finite depths (< z_far) split at their n_crops + 1
    quantiles into strata; each stratum's pixel is the Gumbel-max pick of
    its members (a stratum with no member is invalid); around the pixel's
    surface point NS = oversampling x n_samples points are drawn in a ball
    of `sample_radius`; a crop is valid when more than n_samples of them
    are denser than `sigma_threshold`, and keeps the n_samples densest by
    validity with random tie-breaks."""
    B, H, W = depth.shape
    nc = cfg.n_crops
    rays = build_frame_rays(poses[:, 0], projs[:, 0], 0.0, 0.0, H, W).reshape(B, H * W, 11)
    d = depth.reshape(B, -1)
    finite = d < cfg.z_far
    limits = torch.nanquantile(torch.where(finite, d, torch.full_like(d, torch.nan)),
                               _quantile_levels(nc, d.device), dim=-1).T  # (B, nc + 1)
    member = finite[:, None] & (d[:, None] > limits[:, :-1, None]) & (d[:, None] < limits[:, 1:, None])
    logits = torch.where(member, torch.zeros_like(draws.pix_gumbel), torch.full_like(draws.pix_gumbel, -torch.inf))
    idx = torch.argmax(logits + draws.pix_gumbel, -1)  # (B, nc)
    ok = member.any(-1)
    picked = rays.gather(1, idx[..., None].expand(B, nc, 11))
    centers = picked[..., :3] + picked[..., 3:6] * d.gather(1, idx)[..., None]

    vecs = draws.sphere_dirs / torch.linalg.vector_norm(draws.sphere_dirs, dim=-1, keepdim=True)
    radii = cfg.sample_radius * draws.sphere_u ** (1 / 3)
    pts = centers[:, :, None] + vecs * radii  # (B, nc, NS, 3)
    NS = pts.shape[2]
    _, _, sigma, dino = field(state, pts.reshape(B, -1, 3), only_density=True)
    sigma = sigma.reshape(B, nc, NS)
    dino = dino.reshape(B, nc, NS, -1)
    valid = sigma > cfg.sigma_threshold
    crop_valid = ok & (valid.sum(-1) > cfg.n_samples)
    top = top_k(valid.float() * 2.0 + draws.tie, cfg.n_samples)[1]
    dino_sel = dino.gather(2, top[..., None].expand(*top.shape, dino.shape[-1]))
    return field.expand_dim(dino_sel), crop_valid


def encode_view_id(draws: Stage2Draws, training: bool) -> int:
    """The view a forward encodes: the side view on a training step whose coin says so, else 0."""
    return draws.side_id if (draws.side_coin and training) else 0


def downstream_forward(field: SceneField, head: SemanticHead, batch: Dict[str, torch.Tensor],
                       buffers: RingBufferState, draws: Stage2Draws, cfg: DownstreamTrainConfig,
                       rcfg: RenderConfig, training: bool = True):
    """One stage-2 forward: the frozen render, the crops, the head's training
    forward. Returns (seg_data, rendered, buffers); training updates the
    buffers in place."""
    enc_id = encode_view_id(draws, training)
    rendered, state, poses_e, projs_e = render_frames(field, batch, draws.u, enc_id, cfg, rcfg)
    crop_feats = crop_valid = None
    if cfg.mode == "3d":
        crop_feats, crop_valid = sample_3d_crops(field, state, rendered["depth"], poses_e, projs_e, draws, cfg)
        crop_feats = crop_feats.reshape(-1, cfg.n_samples, crop_feats.shape[-1])
        crop_valid = crop_valid.reshape(-1)
    seg_target = None
    if "segs" in batch:
        # only the front view has segmentation; side-view steps drop it
        seg_target = batch["segs"][:, 0] if enc_id == 0 else torch.full_like(batch["segs"][:, 0], -1)
    seg_data, buffers = head.forward_training(rendered["dino_features"], buffers, draws.head,
                                              crop_features=crop_feats, seg_target=seg_target,
                                              deterministic=not training, crop_valid=crop_valid)
    return seg_data, rendered, buffers


@dataclasses.dataclass
class SeedDraws:
    """The draws of `seed_cluster_centers`: u (B, H*W, n_coarse) the render's
    strata; subsample (max_points,) the rows kept of a larger frame set, or
    None; direct / stego: k-means++ draws, or (n_classes, dim) normals for
    the "random" init."""

    u: torch.Tensor
    subsample: Optional[torch.Tensor]
    direct: Union[KMeansPPDraws, torch.Tensor]
    stego: Union[KMeansPPDraws, torch.Tensor]


def draw_seed(generator: torch.Generator, cfg: DownstreamTrainConfig, head_cfg: SemanticHeadConfig,
              rcfg: RenderConfig, B: int, init_type: str = "kmeans++", max_points: int = 8192) -> SeedDraws:
    dev = generator.device
    R = cfg.render_height * cfg.render_width
    u = torch.rand(B, R, rcfg.n_coarse, generator=generator, device=dev)
    n = B * R
    sub = torch.randperm(n, generator=generator, device=dev)[:max_points] if n > max_points else None
    m = min(n, max_points)
    K = head_cfg.n_classes
    if init_type == "kmeans++":
        direct, stego = (draw_kmeans_pp(m, K, generator, dev) for _ in range(2))
    elif init_type == "random":
        direct = torch.randn(K, head_cfg.input_dim, generator=generator, device=dev)
        stego = torch.randn(K, head_cfg.code_dim, generator=generator, device=dev)
    else:
        raise ValueError(f"unknown cluster init_type: {init_type!r}")
    return SeedDraws(u, sub, direct, stego)


@torch.no_grad()
def seed_cluster_centers(field: SceneField, head: SemanticHead, batch: Dict[str, torch.Tensor], draws: SeedDraws,
                         cfg: DownstreamTrainConfig, rcfg: RenderConfig) -> None:
    """Set both cluster heads' centres from the first batch (semantic_head.py
    :329-348), in place: k-means++ over the features each head clusters
    (normalized DINO for the direct head, STEGO codes for the other), or the
    drawn normals. The render is the validation forward's (view 0); the
    subsample is taken before the STEGO head, which maps rows one by one."""
    rendered = render_frames(field, batch, draws.u, 0, cfg, rcfg)[0]
    flat = rendered["dino_features"].reshape(-1, rendered["dino_features"].shape[-1])
    if draws.subsample is not None:
        flat = flat[draws.subsample]
    dino_n, stego = head.encode_features(flat)
    K = head.cfg.n_classes
    for module, feats, d in ((head.direct_cluster_head, dino_n, draws.direct),
                             (head.stego_cluster_head, stego, draws.stego)):
        centers = kmeans_plus_plus_init(feats, K, d) if isinstance(d, KMeansPPDraws) else d
        module.cluster_centers.copy_(centers)


@dataclasses.dataclass
class DownstreamTrainState:
    """What a stage-2 step updates besides the head's parameters: the
    optimizer (groups "stego" and "heads"), the ring buffers, the step,
    the applied updates and the non-finite counters."""

    optimizer: torch.optim.Optimizer
    buffers: RingBufferState
    step: int = 0
    applied: int = 0
    notfinite_count: int = 0
    total_notfinite: int = 0


def make_downstream_optimizer(cfg: DownstreamTrainConfig, head: SemanticHead) -> torch.optim.Adam:
    """The STEGO head at lr, the cluster and linear heads at lr x
    head_lr_factor (trainer_downstream.py:349-359, semantic_head.py:259-266)."""
    stego = [p for n, p in head.named_parameters() if n.startswith("stego_head.")]
    heads = [p for n, p in head.named_parameters() if not n.startswith("stego_head.")]
    return torch.optim.Adam([{"params": stego, "lr": cfg.lr, "name": "stego"},
                             {"params": heads, "lr": cfg.lr * cfg.head_lr_factor, "name": "heads"}],
                            betas=(0.9, 0.999), eps=1e-8)


def init_downstream_state(head: SemanticHead, cfg: DownstreamTrainConfig) -> DownstreamTrainState:
    c = head.cfg
    device = head.direct_cluster_head.cluster_centers.device
    return DownstreamTrainState(make_downstream_optimizer(cfg, head),
                                RingBufferState.create(c.buffer_size, c.patch_sample_size, c.input_dim, device))


def make_downstream_train_step(field: SceneField, head: SemanticHead, cfg: DownstreamTrainConfig,
                               rcfg: RenderConfig, loss_cfg: StegoLossConfig = StegoLossConfig()):
    """(state, batch, draws) -> loss dict; updates the head's parameters, the
    ring buffers and `state` in place (training/downstream.py:322-393).

    A step with a non-finite gradient anywhere leaves the parameters and
    the Adam moments as they were and moves the counters, until more than
    `skip_nonfinite_steps` consecutive bad steps, when the update goes
    through (optax.apply_if_finite). A head parameter without a gradient
    gets zeros, as optax updates every leaf."""

    def step(state: DownstreamTrainState, batch: Dict[str, torch.Tensor], draws: Stage2Draws):
        state.optimizer.zero_grad(set_to_none=True)
        seg_data, _, _ = downstream_forward(field, head, batch, state.buffers, draws, cfg, rcfg, training=True)
        losses = stego_loss(seg_data, loss_cfg)
        losses["total_loss"].backward()
        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        apply = True
        if cfg.skip_nonfinite_steps > 0:
            finite = bool(torch.stack([torch.isfinite(p.grad).all() for p in params]).all())
            state.notfinite_count = 0 if finite else state.notfinite_count + 1
            state.total_notfinite += 0 if finite else 1
            apply = finite or state.notfinite_count > cfg.skip_nonfinite_steps
        if apply:
            state.optimizer.step()
            state.applied += 1
        state.step += 1
        losses = {k: v.detach() for k, v in losses.items()}
        if cfg.skip_nonfinite_steps > 0:
            losses["nonfinite_consecutive"] = state.notfinite_count
            losses["nonfinite_total"] = state.total_notfinite
            losses["nonfinite_gave_up"] = int(state.notfinite_count > cfg.skip_nonfinite_steps)
        return losses

    return step
