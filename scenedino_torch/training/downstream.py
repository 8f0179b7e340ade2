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

Where the fold does not apply (a head the fold does not cover,
`use_fast_render` off, a fine pass, density noise, a white background,
another render mode or a z range other than the field's) the render is the
reference's generic one: `ImageRaySampler` rays through
`render_rays_chunked` of the unfolded field, in chunks of `render_chunk`
rays. In `mode: 2d` the head takes five crops of the rendered map instead
of 3D surface crops.

Every random draw of a step is an explicit input (`Stage2Draws`);
`draw_stage2` draws them from a `torch.Generator` with the reference's
distributions.

Data-parallel (`make_downstream_train_step(..., dp=...)`, each rank under
`torchrun` holding its rows of the global batch) reproduces the global
batch's step. The couplings across items are carried so: the ring buffers
take every rank's crops, gathered in rank order (the global batch order),
before the kNN query, so every rank's buffers are the single process's;
the step's draws are the global batch's, each rank keeping its rows
(`shard_stage2_draws`); the ratio losses (the valid crops' STEGO terms,
the probes' mean over labelled pixels, `pointwise`'s mean) divide by the
global count (`stego_loss(..., dp)`), each rank's term scaled by the world
size, so the mean of the ranks' losses and of their gradients is the
global batch's. The other terms are means over equal shares.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch

from scenedino_torch.core.ray_sampler import ImageRaySampler, build_frame_rays
from scenedino_torch.losses.stego import StegoLossConfig, stego_loss
from scenedino_torch.models.downstream import HeadDraws, RingBufferState, SemanticHead, SemanticHeadConfig, top_k
from scenedino_torch.models.field import SceneField
from scenedino_torch.ops.fast_field import build_fast_state, can_fold, render_encode_view_batched
from scenedino_torch.ops.kmeans import KMeansPPDraws, draw_kmeans_pp, gumbel, kmeans_plus_plus_init
from scenedino_torch.renderer.nerf import FineDraws, RenderConfig, render_rays_chunked


@dataclasses.dataclass(frozen=True)
class DownstreamTrainConfig:
    lr: float = 1e-3
    head_lr_factor: float = 10.0
    z_near: float = 3.0
    z_far: float = 80.0
    render_height: int = 192
    render_width: int = 640
    render_chunk: int = 15360  # rays a chunk of the generic render (divides 192 x 640)
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
    head: the head's draws (kNN pick, random rows, dropout masks); fine:
    the generic render's fine-pass draws over the B*H*W rays, with a fine
    pass only.
    """

    side_coin: bool
    side_id: int
    u: torch.Tensor
    pix_gumbel: Optional[torch.Tensor]
    sphere_dirs: Optional[torch.Tensor]
    sphere_u: Optional[torch.Tensor]
    tie: Optional[torch.Tensor]
    head: HeadDraws
    fine: Optional[FineDraws] = None


def draw_stage2(generator: torch.Generator, cfg: DownstreamTrainConfig, head_cfg: SemanticHeadConfig,
                rcfg: RenderConfig, B: int, V: int, training: bool = True) -> Stage2Draws:
    """A forward's draws from `generator`, on its device."""
    dev = generator.device
    coin, side = torch.rand(2, generator=generator, device=dev).tolist()
    lo = min(4, V - 1)
    R = cfg.render_height * cfg.render_width
    u = torch.rand(B, R, rcfg.n_coarse, generator=generator, device=dev)
    fine = FineDraws.draw(generator, B * R, rcfg)
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
                       *(crops or (None,) * 4), head, fine)


def _crop_rows(rank: int, world: int, n_global: int, head: SemanticHead,
               cfg: DownstreamTrainConfig) -> torch.Tensor:
    """The global index of each of a rank's crops: the surface crops
    item-major (item, crop), or the head's five crops crop-major (crop, item)
    as `five_crop` stacks them; a rank holds items [rank b, (rank + 1) b),
    b = n_global / world."""
    b = n_global // world
    if cfg.mode == "3d" and head.cfg.mode == "3d":
        return torch.arange(b * cfg.n_crops) + rank * b * cfg.n_crops
    return (torch.arange(5)[:, None] * n_global + rank * b + torch.arange(b)[None]).reshape(-1)


def shard_stage2_draws(draws: Stage2Draws, dp, n_global: int, head: SemanticHead,
                       cfg: DownstreamTrainConfig) -> Stage2Draws:
    """This rank's draws of a global step's `Stage2Draws` over `n_global`
    items: its items' rows, its crops' kNN picks and random rows; the side
    coin, the side view and the dropout masks are every rank's."""
    sl = dp.rows(n_global)
    idx = _crop_rows(dp.rank, dp.world, n_global, head, cfg).to(draws.head.knn_pick.device)

    def item_rows(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if x is None else x[sl]

    def ray_rows(x: torch.Tensor) -> torch.Tensor:  # of the B*H*W flat rays
        return x.reshape(n_global, -1, x.shape[-1])[sl].reshape(-1, x.shape[-1])

    head = HeadDraws(draws.head.knn_pick[idx], draws.head.rand_u[idx], draws.head.dropout)
    return dataclasses.replace(draws, u=draws.u[sl], pix_gumbel=item_rows(draws.pix_gumbel),
                               sphere_dirs=item_rows(draws.sphere_dirs), sphere_u=item_rows(draws.sphere_u),
                               tie=item_rows(draws.tie), head=head,
                               fine=None if draws.fine is None else draws.fine.map(ray_rows))


def make_crop_gather(dp, n_global: int, head: SemanticHead, cfg: DownstreamTrainConfig):
    """(crops, gaps, valid) of this rank -> the global batch's, in its
    order: what every rank writes to its ring buffers."""
    order = torch.cat([_crop_rows(r, dp.world, n_global, head, cfg) for r in range(dp.world)])

    def gather(*rows: Optional[torch.Tensor]):
        out = []
        for t in rows:
            if t is not None:
                g = dp.gather_rows(t)
                t = torch.empty_like(g)
                t[order.to(g.device)] = g
            out.append(t)
        return out

    return gather


def _fast_render_applies(field: SceneField, cfg: DownstreamTrainConfig, rcfg: RenderConfig) -> bool:
    """The reference's guard of the folded full-frame render
    (training/downstream.py:196-212)."""
    return (cfg.use_fast_render and can_fold(field) and rcfg.n_fine == 0 and rcfg.n_fine_depth == 0
            and rcfg.noise_std == 0.0 and not rcfg.white_bkgd and rcfg.render_mode == "volumetric"
            and (cfg.z_near, cfg.z_far) == (field.cfg.z_near, field.cfg.z_far))


@torch.no_grad()
def render_frames(field: SceneField, batch: Dict[str, torch.Tensor], u: torch.Tensor, enc_id: int,
                  cfg: DownstreamTrainConfig, rcfg: RenderConfig, fine: Optional[FineDraws] = None):
    """The frozen full-frame render of view `enc_id` of every frame: pose
    rebase, encode, then the fp32 fold and the encode-view render (K6)
    where the fold applies, else the generic render (`fine` its fine-pass
    draws, with a fine pass), then the 64 -> 768 expansion. u (B, H*W,
    n_coarse). Returns (rendered {"depth" (B, H, W), "dino_features"
    (B, 1, H, W, 1, 768), "rgb" (B, H*W, 3 or the colour channels)}, the
    scene state, the rebased poses and the intrinsics of the encode view)."""
    imgs, poses, projs = batch["imgs"], batch["poses"], batch["projs"]
    B = imgs.shape[0]
    H, W = cfg.render_height, cfg.render_width
    imgs_e = imgs[:, enc_id:enc_id + 1]
    poses_e, projs_e = poses[:, enc_id:enc_id + 1].float(), projs[:, enc_id:enc_id + 1].float()
    poses_e = torch.linalg.inv_ex(poses_e[:, :1]).inverse @ poses_e  # rebase; no host sync, as in JAX
    state = field.encode(imgs_e, projs_e, poses_e, ids_encoder=(0,))
    if _fast_render_applies(field, cfg, rcfg):
        # fp32 fold: the training path's numbers match the generic renderer's (bf16 grids are a serving choice)
        fs = build_fast_state(field, state, compute_dtype=torch.float32)
        depth, dino64, rgb = render_encode_view_batched(fs, field.cfg, H, W, u=u, n_coarse=rcfg.n_coarse,
                                                        lindisp=rcfg.lindisp, hard_alpha_cap=rcfg.hard_alpha_cap)
        rgb = rgb.reshape(B, H * W, 3)
    else:
        rays = ImageRaySampler(cfg.z_near, cfg.z_far, H, W).sample(poses_e, projs_e)

        def field_fn(xyz, only_density=False):
            return field(state, xyz, only_density=only_density)

        out = render_rays_chunked(field_fn, rays[..., :8], u.reshape(-1, u.shape[-1]), rcfg, chunk=cfg.render_chunk,
                                  fine=fine)["coarse"]
        depth, dino64, rgb = out["depth"].reshape(B, H, W), out["dino_features"], out["rgb"]
    dino768 = field.expand_dim(dino64.reshape(B, 1, H, W, 1, -1))
    return {"depth": depth, "dino_features": dino768, "rgb": rgb}, state, poses_e, projs_e


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
                       rcfg: RenderConfig, training: bool = True, gather_crops=None):
    """One stage-2 forward: the frozen render, the crops, the head's training
    forward. Returns (seg_data, rendered, buffers); training updates the
    buffers in place (with every rank's crops under `gather_crops`,
    `make_crop_gather`)."""
    enc_id = encode_view_id(draws, training)
    rendered, state, poses_e, projs_e = render_frames(field, batch, draws.u, enc_id, cfg, rcfg, draws.fine)
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
                                              deterministic=not training, crop_valid=crop_valid,
                                              gather_crops=gather_crops)
    return seg_data, rendered, buffers


@dataclasses.dataclass
class SeedDraws:
    """The draws of `seed_cluster_centers`: u (B, H*W, n_coarse) the render's
    strata; subsample (max_points,) the rows kept of a larger frame set, or
    None; direct / stego: k-means++ draws, or (n_classes, dim) normals for
    the "random" init; fine: the generic render's fine-pass draws, with a
    fine pass only."""

    u: torch.Tensor
    subsample: Optional[torch.Tensor]
    direct: Union[KMeansPPDraws, torch.Tensor]
    stego: Union[KMeansPPDraws, torch.Tensor]
    fine: Optional[FineDraws] = None


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
    return SeedDraws(u, sub, direct, stego, FineDraws.draw(generator, n, rcfg))


@torch.no_grad()
def seed_cluster_centers(field: SceneField, head: SemanticHead, batch: Dict[str, torch.Tensor], draws: SeedDraws,
                         cfg: DownstreamTrainConfig, rcfg: RenderConfig) -> None:
    """Set both cluster heads' centres from the first batch (semantic_head.py
    :329-348), in place: k-means++ over the features each head clusters
    (normalized DINO for the direct head, STEGO codes for the other), or the
    drawn normals. The render is the validation forward's (view 0); the
    subsample is taken before the STEGO head, which maps rows one by one."""
    rendered = render_frames(field, batch, draws.u, 0, cfg, rcfg, draws.fine)[0]
    flat = rendered["dino_features"].reshape(-1, rendered["dino_features"].shape[-1])
    if draws.subsample is not None:
        flat = flat[draws.subsample]
    dino_n, stego = head.encode_features(flat)
    K = head.cfg.n_classes
    for module, feats, d in ((head.direct_cluster_head, dino_n, draws.direct),
                             (head.stego_cluster_head, stego, draws.stego)):
        centers = kmeans_plus_plus_init(feats, K, d) if isinstance(d, KMeansPPDraws) else d
        module.cluster_centers.copy_(centers)


def seed_cluster_centers_everywhere(field: SceneField, head: SemanticHead,
                                    first_batch: Callable[[], Dict[str, torch.Tensor]], draws: SeedDraws,
                                    cfg: DownstreamTrainConfig, rcfg: RenderConfig, dp=None) -> None:
    """`seed_cluster_centers` on the global first batch, with every rank of a
    data-parallel run (`dp`, a `parallel.data_parallel.DataParallel`) ending
    with its centres: rank 0, or the one process, reads the batch from
    `first_batch()` and seeds; the other ranks read nothing and take rank 0's
    centres by broadcast. Every rank passes the same `draws` (drawn from its
    own generator, so that the generators stay together)."""
    if dp is None or dp.main:
        seed_cluster_centers(field, head, first_batch(), draws, cfg, rcfg)
    if dp is not None:
        dp.broadcast_([head.direct_cluster_head.cluster_centers, head.stego_cluster_head.cluster_centers])


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
                               rcfg: RenderConfig, loss_cfg: StegoLossConfig = StegoLossConfig(), dp=None):
    """(state, batch, draws) -> loss dict; updates the head's parameters, the
    ring buffers and `state` in place (training/downstream.py:322-393).
    Under data parallelism (`dp`) `batch` and `draws` are this rank's share
    of the global batch's (`shard_stage2_draws`): the buffers take every
    rank's crops, the losses are this rank's terms of the global ones and
    the gradients are averaged over the ranks before the update.

    A step with a non-finite gradient anywhere leaves the parameters and
    the Adam moments as they were and moves the counters, until more than
    `skip_nonfinite_steps` consecutive bad steps, when the update goes
    through (optax.apply_if_finite). A head parameter without a gradient
    gets zeros, as optax updates every leaf."""

    def step(state: DownstreamTrainState, batch: Dict[str, torch.Tensor], draws: Stage2Draws):
        state.optimizer.zero_grad(set_to_none=True)
        gather = None
        if dp is not None:
            gather = make_crop_gather(dp, batch["imgs"].shape[0] * dp.world, head, cfg)
        seg_data, _, _ = downstream_forward(field, head, batch, state.buffers, draws, cfg, rcfg, training=True,
                                            gather_crops=gather)
        losses = stego_loss(seg_data, loss_cfg, dp)
        losses["total_loss"].backward()
        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if dp is not None:
            dp.average_([p.grad for p in params])
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
