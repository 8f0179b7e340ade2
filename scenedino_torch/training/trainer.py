"""The stage-1 self-supervised training step (counterpart of
`scenedino_tpu/training/trainer.py`).

One step: pose rebase to frame 0, loss/render frame split, patch-grid
shift and flip augmentation, the frozen teacher on the loss frames, the
student encode of frame 0, patch ray sampling, the coarse volume render,
patch reconstruction, the 64 -> 768 expansion and salience pooling,
artifact compensation, the reconstruction loss, backward, then Adam on
two learning-rate groups (the student ViT at lr x encoder_lr_factor) and
on the artifact field, with the reference's non-finite step skip and,
with `gradient_accum_factor` k > 1, optax `MultiSteps`' accumulation
(the running mean of k micro-batches' gradients applied on the k-th).

The optional branches: `predict_uncertainty` renders the field's
uncertainty map as an extra colour channel (`coarse["uncert"]`,
"uncert_mean"); `predict_consistency` re-encodes views 0 and 1 and logs
"consistency_depth_abs" (`consistency_forward`); `debug_stats` adds the
dbg_* extremes. `ScheduledTrainStep` swaps the render's sample counts on
the `renderer.sched` milestones. `stage1_eval_forward` is the full-frame
validation render.

Every random draw of a step is an explicit input (`Stage1Draws`);
`draw_stage1` draws them from a `torch.Generator` with the reference's
distributions. The loss/render frame split is the RealEstate10K recipe's
for "alternate" (one coin for the sample: the even or the odd frames give
the loss) and the KITTI-360 recipe's (a coin per stereo pair) for every
other name, as in the JAX step.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from scenedino_torch.core.ray_sampler import (
    ImageRaySampler,
    PatchRaySampler,
    PointBasedRaySampler,
    RandomRaySampler,
)
from scenedino_torch.losses.reconstruction import ReconstructionLossConfig, reconstruction_loss
from scenedino_torch.models.field import SceneField
from scenedino_torch.models.upsampler import CropDraws, sample_crop_params
from scenedino_torch.renderer.nerf import (
    FineDraws,
    RenderConfig,
    RenderDraws,
    draw_sigma_noise,
    render_rays,
    render_rays_chunked,
)
from scenedino_torch.training.scheduler import make_schedule

Mark = Optional[Callable[[str], None]]
logger = logging.getLogger("training")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """configs/train_scenedino_kitti_360.yaml + training/scenedino.yaml
    (the reference's TrainConfig, trainer.py:34-78)."""

    lr: float = 1e-4
    encoder_lr_factor: float = 0.1  # the student ViT is fine-tuned at lr/10
    scheduler_type: str = "step"  # "fix" | "step"
    scheduler_step: int = 100000
    scheduler_gamma: float = 0.1
    gradient_accum_factor: int = 1
    # after this many consecutive non-finite steps the update goes through
    # (optax.apply_if_finite); 0 disables the skip
    skip_nonfinite_steps: int = 10
    ray_batch_size: int = 2048
    patch_size: int = 8
    z_near: float = 3.0
    z_far: float = 80.0
    compensate_artifacts: bool = True
    flip_augmentation: bool = True
    grid_shift_augmentation: bool = True
    # the optional research branches (off in shipped configs); the
    # uncertainty map needs SceneField(uncertainty_predictor=...)
    predict_uncertainty: bool = False
    uncertainty_predictor_res: int = 0
    predict_consistency: bool = False
    consistency_rays: int = 512
    dino_upscaled: bool = False
    loss_renderer_strategy: str = "kitti_360"
    debug_stats: bool = False
    # the views the student encodes (the reference's step: view 0); a
    # multi-view head (models.multi_view_head) aggregates several
    ids_encoder: Tuple[int, ...] = (0,)


@dataclasses.dataclass
class ConsistencyDraws:
    """The consistency branch's draws: `idx` (B, consistency_rays) pixels of
    view 0 (`RandomRaySampler.draw`), and the draws of its two renders over
    B * consistency_rays rays each."""

    idx: torch.Tensor
    r0: RenderDraws
    r1: RenderDraws


@dataclasses.dataclass
class Stage1Draws:
    """Every random draw of one step.

    split_coin: per pair of frames (2p, 2p + 1), 1 when the second is the
    loss frame (p = 1/3; with the "alternate" split one coin repeated for
    every pair); shift: the teacher-grid shift (sy, sx) in
    [-P/2, P/2), or None without the augmentation; flip: the flip coin;
    pv, py, px: (B, PC) patch picks; u: (B * R, n_coarse) stratum draws;
    fine: the fine pass's draws (None without one); crops: the
    multiscale-crop teacher's crops of the B x V/2 loss images (None for
    any other teacher); noise: (B * R, n_coarse) ~ N(0, 1), the render's
    density noise (None unless `noise_std > 0`); consistency: the
    consistency branch's draws (None without it).
    """

    split_coin: Tuple[int, ...]
    shift: Optional[Tuple[int, int]]
    flip: bool
    pv: torch.Tensor
    py: torch.Tensor
    px: torch.Tensor
    u: torch.Tensor
    fine: Optional[FineDraws] = None
    crops: Optional[CropDraws] = None
    noise: Optional[torch.Tensor] = None
    consistency: Optional[ConsistencyDraws] = None


def draw_stage1(generator: torch.Generator, cfg: TrainConfig, rcfg: RenderConfig, B: int, V: int,
                H: int, W: int, gt_patch: int = 8, crop_views: int = 0) -> Stage1Draws:
    """A step's draws from `generator`, on the generator's device;
    `crop_views` crops of each loss image (the encoder's `crop_views`), then
    the density noise and the consistency branch's draws, each where the
    configs ask for it."""
    dev = generator.device

    def randint(low, high, n):
        return torch.randint(low, high, (n,), generator=generator, device=dev).tolist()

    if cfg.loss_renderer_strategy == "alternate":  # one coin for the sample (core/strategies.py)
        coin = (int(randint(0, 3, 1)[0] == 0),) * (V // 2)
    else:
        coin = tuple(int(c == 0) for c in randint(0, 3, V // 2))
    shift = tuple(randint(-(gt_patch // 2), gt_patch // 2, 2)) if cfg.grid_shift_augmentation else None
    flip = bool(randint(0, 2, 1)[0]) if cfg.flip_augmentation else False
    sampler = PatchRaySampler(cfg.z_near, cfg.z_far, cfg.ray_batch_size, cfg.patch_size)
    pv, py, px = sampler.draw(B, V // 2, H, W, shift is not None, generator, dev)
    u = torch.rand(B * cfg.ray_batch_size, rcfg.n_coarse, generator=generator, device=dev)
    fine = FineDraws.draw(generator, B * cfg.ray_batch_size, rcfg, training=True)
    crops = sample_crop_params(generator, B * (V // 2), crop_views) if crop_views else None
    noise = draw_sigma_noise(generator, B * cfg.ray_batch_size, rcfg, training=True)
    consistency = None
    if cfg.predict_consistency:
        n = B * cfg.consistency_rays
        idx = RandomRaySampler(cfg.z_near, cfg.z_far, cfg.consistency_rays).draw(B, 1, H, W, generator, dev)
        consistency = ConsistencyDraws(idx, RenderDraws.draw(generator, n, rcfg, True),
                                       RenderDraws.draw(generator, n, rcfg, True))
    return Stage1Draws(coin, shift, flip, pv, py, px, u, fine, crops, noise, consistency)


def sample_frame_split(split_coin: Tuple[int, ...]) -> Tuple[List[int], List[int]]:
    """Per pair (2p, 2p + 1): the coin picks the loss frame, the other
    renders (trainer.py:131-142, and core/strategies.py's alternate split
    with one coin for all pairs). Returns (ids_loss, ids_render)."""
    ids_loss = [2 * p + c for p, c in enumerate(split_coin)]
    ids_render = [2 * p + 1 - c for p, c in enumerate(split_coin)]
    return ids_loss, ids_render


def _mark(mark: Mark, name: str) -> None:
    if mark is not None:
        mark(name)


def stage1_forward(field: SceneField, batch: Dict[str, torch.Tensor], draws: Stage1Draws,
                   cfg: TrainConfig, rcfg: RenderConfig, lcfg: ReconstructionLossConfig,
                   artifact_field: Optional[torch.Tensor] = None, mark: Mark = None):
    """One stage-1 forward (trainer.py:145-351): (loss, loss dict).

    batch: imgs (B, V, 3, H, W) in [-1, 1]; poses (B, V, 4, 4) camera to
    world; projs (B, V, 3, 3) normalized intrinsics. `mark(name)`, when
    given, is called after the stages "teacher", "student", "render" and
    "loss".
    """
    imgs, poses, projs = batch["imgs"], batch["poses"], batch["projs"]
    B, V = imgs.shape[:2]
    # the per-image uncertainty map, rendered as an extra colour channel (trainer.py:171-176)
    uncert = None
    if cfg.predict_uncertainty and field.uncertainty_predictor is not None:
        uncert = field.predict_uncertainty(imgs, cfg.uncertainty_predictor_res)
    # inv_ex: a singular pose gives non-finite values (the step is then skipped), as in JAX
    poses = torch.linalg.inv_ex(poses[:, :1].float()).inverse @ poses.float()
    ids_loss, ids_render = sample_frame_split(draws.split_coin)
    shift = draws.shift if cfg.grid_shift_augmentation else None

    if artifact_field is not None and cfg.dino_upscaled:
        raise ValueError("artifact compensation is tied to the patch-grid teacher (downsample-prediction configs)")
    # (B, Vl, Cd, Gh, Gw); per pixel (Gh, Gw) = (H, W) in upsample-gt mode
    loss_feats = field.loss_features(imgs, ids_loss, shift, crops=draws.crops).float()
    _mark(mark, "teacher")
    state = field.encode(imgs, projs, poses, ids_encoder=cfg.ids_encoder, ids_render=ids_render,
                         flip=draws.flip and cfg.flip_augmentation, extra_color_channels=uncert)
    state.loss_feats = loss_feats
    _mark(mark, "student")

    sampler = PatchRaySampler(cfg.z_near, cfg.z_far, cfg.ray_batch_size, cfg.patch_size, cfg.dino_upscaled)
    dino_feats = loss_feats
    if artifact_field is not None:
        af = artifact_field[None, None].expand(B, loss_feats.shape[1], *artifact_field.shape)
        dino_feats = torch.cat([loss_feats, af], 2)
    imgs_loss = imgs[:, ids_loss] * 0.5 + 0.5
    if uncert is not None:
        imgs_loss = torch.cat([imgs_loss, uncert[:, ids_loss].to(imgs_loss.dtype)], 2)
    frame_ids = torch.tensor(ids_loss, dtype=imgs.dtype, device=imgs.device)
    rays, rgb_gt, dino_gt = sampler.sample(
        imgs_loss, poses[:, ids_loss], projs[:, ids_loss],
        draws.pv, draws.py, draws.px, frame_ids=frame_ids, dino_features=dino_feats, grid_shift=shift,
    )
    dino_artifacts = None
    if artifact_field is not None:
        Cd = artifact_field.shape[0]
        dino_gt, dino_artifacts = dino_gt[..., :-Cd], dino_gt[..., -Cd:]

    out = render_rays(lambda xyz, only_density=False: field(state, xyz, only_density=only_density),
                      rays[..., :8], draws.u, rcfg, want_weights=True, want_rgb_samps=True, fine=draws.fine,
                      noise=draws.noise, training=True)
    _mark(mark, "render")

    P, PC = cfg.patch_size, sampler.patch_count
    c = out["coarse"]
    C_img = 3 + (uncert.shape[2] if uncert is not None else 0)
    Vr, K = c["rgb"].shape[-1] // C_img, c["weights"].shape[-1]
    rgb_full = sampler.reconstruct(c["rgb"]).reshape(B, PC, P, P, Vr, C_img)
    coarse = {
        "rgb": rgb_full[..., :3],
        "depth": sampler.reconstruct(c["depth"]),
        "invalid": sampler.reconstruct(c["invalid"]).reshape(B, PC, P, P, K, Vr),
        "weights": sampler.reconstruct(c["weights"]),
        # per-sample colours: the weight_guided_diverse policy reads them
        "rgb_samps": sampler.reconstruct(c["rgb_samps"]).reshape(B, PC, P, P, K, Vr, C_img)[..., :3],
    }
    if C_img > 3:
        coarse["uncert"] = rgb_full[..., 3:].mean(-2)  # (B, PC, P, P, Ce)
    # expand 64 -> 768 per pixel (the smoothness term reads it), pool each
    # patch to one vector for the cosine loss (per pixel with dino_upscaled),
    # add the artifact field
    dino_768 = field.expand_dim(sampler.reconstruct(c["dino_features"]))
    coarse["dino_features"] = dino_768
    pooled = None if cfg.dino_upscaled else field.downsample(dino_768.reshape(B, PC, P, P, 1, -1), "patch")
    pooled = dino_768 if pooled is None else pooled.reshape(B, PC, 1, 1, -1)
    if dino_artifacts is not None:
        pooled = pooled + dino_artifacts.reshape(B, PC, 1, 1, -1)
    coarse["dino_features_downsampled"] = pooled
    dino_gt = sampler.reconstruct(dino_gt) if cfg.dino_upscaled else dino_gt.reshape(B, PC, 1, 1, -1)
    data = {"rgb_gt": sampler.reconstruct(rgb_gt), "dino_gt": dino_gt, "coarse": coarse}
    losses = reconstruction_loss(data, lcfg)
    if cfg.debug_stats:  # the numerical-stability forensics scalars (trainer.py:328-336)
        losses["dbg_depth_min"] = coarse["depth"].min()
        losses["dbg_depth_max"] = coarse["depth"].max()
        losses["dbg_wsum_min"] = coarse["weights"].sum(-1).min()
        losses["dbg_dino768_absmax"] = dino_768.abs().max()
        losses["dbg_rgb_absmax"] = coarse["rgb"].abs().max()
        losses["dbg_dino_gt_absmax"] = dino_gt.abs().max()
        if dino_artifacts is not None:
            losses["dbg_artifact_absmax"] = dino_artifacts.abs().max()
    if "uncert" in coarse:
        losses["uncert_mean"] = coarse["uncert"].mean()
    if cfg.predict_consistency:
        # a logged diagnostic outside rec_loss (its gradient reaches nothing, as in JAX): no graph
        with torch.no_grad():
            cons = consistency_forward(field, imgs, poses, projs, uncert, draws.consistency, cfg, rcfg)
        losses["consistency_depth_abs"] = cons["depth_abs"]
    _mark(mark, "loss")
    return losses["rec_loss"], losses


def consistency_forward(field: SceneField, imgs: torch.Tensor, poses: torch.Tensor, projs: torch.Tensor,
                        uncert: Optional[torch.Tensor], draws: ConsistencyDraws, cfg: TrainConfig,
                        rcfg: RenderConfig) -> Dict[str, Any]:
    """The predict_consistency double render (trainer.py:354-426): the
    `consistency_rays` rays `draws.idx` of view 0 rendered from view 0's
    encoding; their depths unprojected to surface points; view 1 encoded
    alone and rays from its camera through those points rendered. poses
    are the step's rebased ones. Returns render_dict_0, render_dict_1, xyz,
    rgb_gt_0 and depth_abs, the mean |rendered depth from view 1 - the
    points' distance to its camera|."""
    cf = 1
    state0 = field.encode(imgs, projs, poses, ids_encoder=(0,), ids_render=(0,), extra_color_channels=uncert)
    imgs_ip = imgs[:, :1] * 0.5 + 0.5
    if uncert is not None:
        imgs_ip = torch.cat([imgs_ip, uncert[:, :1].to(imgs_ip.dtype)], 2)
    rays0, rgb_gt0, _ = RandomRaySampler(cfg.z_near, cfg.z_far, cfg.consistency_rays).sample(
        imgs_ip, poses[:, :1], projs[:, :1], draws.idx)
    rd0 = render_rays(lambda xyz, only_density=False: field(state0, xyz, only_density=only_density),
                      rays0[..., :8], draws.r0.u, rcfg, fine=draws.r0.fine, noise=draws.r0.noise, training=True)
    d = rays0[..., 3:6]
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-8)
    xyz = rays0[..., :3] + d * rd0["coarse"]["depth"][..., None]

    state1 = field.encode(imgs[:, cf:cf + 1], projs[:, cf:cf + 1], poses[:, cf:cf + 1],
                          extra_color_channels=None if uncert is None else uncert[:, cf:cf + 1])
    rays1 = PointBasedRaySampler(cfg.z_near, cfg.z_far).sample(xyz, poses[:, cf])
    rd1 = render_rays(lambda p, only_density=False: field(state1, p, only_density=only_density),
                      rays1, draws.r1.u, rcfg, want_weights=True, fine=draws.r1.fine, noise=draws.r1.noise,
                      training=True)
    target_depth = torch.linalg.vector_norm(xyz - poses[:, cf, None, :3, 3], dim=-1)
    depth_abs = (rd1["coarse"]["depth"] - target_depth).abs().mean()
    return {"render_dict_0": rd0, "render_dict_1": rd1, "xyz": xyz, "rgb_gt_0": rgb_gt0, "depth_abs": depth_abs}


@torch.no_grad()
def stage1_eval_forward(field: SceneField, batch: Dict[str, torch.Tensor], cfg: TrainConfig, rcfg: RenderConfig,
                        u: Optional[torch.Tensor] = None, fine: Optional[FineDraws] = None,
                        generator: Optional[torch.Generator] = None, chunk: int = 16384,
                        crops: Optional[CropDraws] = None) -> Dict[str, Any]:
    """The full-frame validation render (trainer.py:429-514), no graph.

    The poses are rebased to frame 0; the student encodes view 0, the
    colours come from view 0 and the teacher sees every view (the shipped
    eval split "single_renderer" with all frames); every pixel of every
    view is rendered in chunks of `chunk` rays, the 64-d features expanded
    to the teacher's space and pooled to its grid ("image" mode; a
    per-pixel teacher, upsample-gt mode, compares them per pixel). u
    (B*V*H*W, n_coarse) and `fine` are the render's draws, and `crops` the
    multiscale-crop teacher's (B*V images), each drawn from `generator` (u
    first, then fine, then crops) where not given. JAX's own validation
    render draws no crops and raises on that teacher. Returns depth (B, V, H, W), rgb
    (B, V, H, W, Vr, 3), dino_pred_grid / dino_gt_grid (B, V, Gh, Gw, Cd),
    imgs_gt (B, V, 3, H, W) in [0, 1], projs (B, V, 3, 3), with
    `batch["depths"]` depths_gt and, with `batch["occ_pts"]` (B, ..., 3),
    occ_densities (B, P): the field's density at those points
    (wrapper.py create_occ_eval:128-183).
    """
    imgs, poses, projs = batch["imgs"], batch["poses"], batch["projs"]
    B, V, _, H, W = imgs.shape
    n_rays = B * V * H * W
    n_crops = field.encoder.crop_views
    if (u is None or (rcfg.using_fine and fine is None) or (n_crops and crops is None)) and generator is None:
        raise ValueError("pass the draws (u, fine, crops) or a generator to draw them from")
    if u is None:
        u = torch.rand(n_rays, rcfg.n_coarse, generator=generator, device=generator.device)
    if fine is None:
        fine = FineDraws.draw(generator, n_rays, rcfg) if rcfg.using_fine else None
    if crops is None and n_crops:
        crops = sample_crop_params(generator, B * V, n_crops)
    poses = torch.linalg.inv_ex(poses[:, :1].float()).inverse @ poses.float()
    ids_loss = list(range(V))
    state = field.encode(imgs, projs, poses, ids_encoder=(0,), ids_render=(0,), ids_loss=ids_loss,
                         with_loss_feats=True, crops=crops)
    rays = ImageRaySampler(cfg.z_near, cfg.z_far, H, W).sample(poses, projs)  # (B, V*H*W, 11)
    out = render_rays_chunked(lambda xyz, only_density=False: field(state, xyz, only_density=only_density),
                              rays[..., :8], u, rcfg, chunk=chunk, fine=fine)
    c = out["coarse"]
    Vr = c["rgb"].shape[-1] // 3
    dino_pred = field.expand_dim(c["dino_features"].reshape(B, V, H, W, 1, -1))
    pooled = field.downsample(dino_pred, "image")
    dino_gt = state.loss_feats.float().permute(0, 1, 3, 4, 2)  # (B, V, Gh, Gw, Cd)
    if pooled is None:  # a per-pixel teacher: the mean over each of its cells (one pixel)
        Gh, Gw = dino_gt.shape[2:4]
        pooled = dino_pred.reshape(B, V, Gh, H // Gh, Gw, W // Gw, -1).mean((3, 5))
    data = {
        "depth": c["depth"].reshape(B, V, H, W),
        "rgb": c["rgb"].reshape(B, V, H, W, Vr, 3),
        "dino_pred_grid": pooled.reshape(dino_gt.shape),
        "dino_gt_grid": dino_gt,
        "imgs_gt": imgs * 0.5 + 0.5,
        "projs": projs,
    }
    if "depths" in batch:
        data["depths_gt"] = batch["depths"]
    if "occ_pts" in batch:
        data["occ_densities"] = field(state, batch["occ_pts"].reshape(B, -1, 3).float(), only_density=True)[2]
    return data


@dataclasses.dataclass
class TrainState:
    """What a step updates besides the field's parameters (which the
    optimizer holds). `applied` counts the updates applied, the count the
    learning-rate schedule reads; a skipped step does not apply one. With
    gradient accumulation, `acc_grads` holds the running mean of this
    cycle's gradients (the optimizer's parameters in order, then the
    artifact field) and `mini_step` how many it has taken."""

    optimizer: torch.optim.Optimizer
    artifact_field: Optional[torch.Tensor] = None  # (Cd, Gh, Gw), a leaf that requires grad
    artifact_optimizer: Optional[torch.optim.Optimizer] = None
    step: int = 0
    applied: int = 0
    notfinite_count: int = 0
    total_notfinite: int = 0
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None


def make_optimizer(cfg: TrainConfig, field: SceneField) -> torch.optim.Adam:
    """Adam with two learning-rate groups (trainer.py:89-128): the student
    ViT (`encoder.vit_encoder`, not the teacher) at lr x encoder_lr_factor,
    every other trainable parameter at lr. Each group keeps its base rate
    under "base_lr" for the schedule. torch's Adam computes
    lr m_hat / (sqrt(v_hat) + eps) with eps = 1e-8, as optax's does."""
    encoder, default = [], []
    for name, p in field.named_parameters():
        if p.requires_grad:
            (encoder if name.startswith("encoder.vit_encoder.") else default).append(p)
    groups = [
        {"params": default, "lr": cfg.lr, "base_lr": cfg.lr, "name": "default"},
        {"params": encoder, "lr": cfg.lr * cfg.encoder_lr_factor,
         "base_lr": cfg.lr * cfg.encoder_lr_factor, "name": "encoder"},
    ]
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(field: SceneField, cfg: TrainConfig, artifact_shape: Optional[Tuple[int, int, int]] = None,
                     generator: Optional[torch.Generator] = None,
                     artifact_field: Optional[torch.Tensor] = None) -> TrainState:
    """The optimizer and, with `compensate_artifacts`, the artifact field:
    `artifact_field` when given (e.g. carried across from a JAX state),
    else 0.001 * N(0, 1) of `artifact_shape` from `generator`, with its
    own Adam at the constant lr (trainer.py:629-654)."""
    opt = make_optimizer(cfg, field)
    art = art_opt = None
    if cfg.compensate_artifacts and (artifact_shape is not None or artifact_field is not None):
        device = next(field.parameters()).device
        if artifact_field is None:
            gdev = generator.device if generator is not None else device
            artifact_field = 0.001 * torch.randn(artifact_shape, generator=generator, device=gdev)
        art = artifact_field.detach().to(device=device, dtype=torch.float32).clone().requires_grad_(True)
        art_opt = torch.optim.Adam([art], lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(opt, art, art_opt)


def _accumulate(state: TrainState, params: List[torch.Tensor], k: int) -> bool:
    """optax MultiSteps' accumulator (trainer.py:118-126): each parameter's
    running mean acc += (g - acc) / (n + 1) over the cycle's n micro-steps
    so far (a parameter without a gradient adds 0). On the k-th the mean
    becomes the gradient and the accumulator restarts (times 0, as optax
    restarts it); returns whether this micro-step applies an update."""
    if state.acc_grads is None:
        state.acc_grads = [torch.zeros_like(p) for p in params]
    n = state.mini_step
    for p, acc in zip(params, state.acc_grads):
        acc.add_(((p.grad if p.grad is not None else torch.zeros_like(acc)) - acc) / (n + 1))
    emit = n == k - 1
    state.mini_step = (n + 1) % k
    if emit:
        for p, acc in zip(params, state.acc_grads):
            p.grad = acc.clone()
            acc.mul_(0.0)
    elif not all(bool(torch.isfinite(acc).all()) for acc in state.acc_grads):
        # optax applies emit x update = 0 x Adam(acc) between applications:
        # a parameter whose accumulator is not finite (a non-finite step let
        # through past the skip budget) becomes NaN
        with torch.no_grad():
            for p, acc in zip(params, state.acc_grads):
                p.add_(acc * 0.0)
    return emit


def make_train_step(field: SceneField, cfg: TrainConfig, rcfg: RenderConfig, lcfg: ReconstructionLossConfig,
                    average_gradients: Optional[Callable[[List[torch.Tensor]], None]] = None):
    """(state, batch, draws, mark=None) -> loss dict; updates the field's
    parameters, the artifact field and `state` in place (trainer.py:517-573).

    The non-finite skip is one decision over every gradient, the
    parameters' and the artifact field's: a step with a NaN or Inf
    anywhere leaves parameters, Adam moments and the gradient accumulator
    as they were and moves the counters, until more than
    `skip_nonfinite_steps` consecutive bad steps, when the update goes
    through. With an artifact field the reference poisons every gradient
    of such a step with NaN (so the update, when it goes through, is all
    NaN); so does the port. With `gradient_accum_factor` k > 1 the
    parameters, the moments and the schedule's count move only on every
    k-th accepted micro-step, with the mean of the k gradients.
    `average_gradients(grads)`, when given, averages the gradients in place
    over the data-parallel ranks before any of this (`parallel`): every
    rank then decides alike. `mark` also sees "backward" and "optimizer".
    """
    sched = {"type": cfg.scheduler_type, "step_size": cfg.scheduler_step, "gamma": cfg.scheduler_gamma}
    k = cfg.gradient_accum_factor

    def step(state: TrainState, batch: Dict[str, torch.Tensor], draws: Stage1Draws, mark: Mark = None):
        state.optimizer.zero_grad(set_to_none=True)
        art = state.artifact_field
        if art is not None:
            art.grad = None
        loss, losses = stage1_forward(field, batch, draws, cfg, rcfg, lcfg, art, mark=mark)
        loss.backward()
        _mark(mark, "backward")

        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        if art is not None:
            params.append(art)
        if average_gradients is not None:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            average_gradients([p.grad for p in params])
        grads = [p.grad for p in params if p.grad is not None]
        apply = True
        if cfg.skip_nonfinite_steps > 0:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            state.notfinite_count = 0 if finite else state.notfinite_count + 1
            state.total_notfinite += 0 if finite else 1
            apply = finite or state.notfinite_count > cfg.skip_nonfinite_steps
            if not finite and art is not None:
                for g in grads:
                    g.add_(float("nan"))
        if apply and k > 1:
            apply = _accumulate(state, params, k)
        if apply:
            for group in state.optimizer.param_groups:
                group["lr"] = make_schedule(sched, group["base_lr"])(state.applied)
            state.optimizer.step()
            if state.artifact_optimizer is not None:
                state.artifact_optimizer.step()
            state.applied += 1
        state.step += 1
        _mark(mark, "optimizer")

        losses = {k_: v.detach() for k_, v in losses.items()}
        if cfg.skip_nonfinite_steps > 0:
            losses["nonfinite_consecutive"] = state.notfinite_count
            losses["nonfinite_total"] = state.total_notfinite
            losses["nonfinite_gave_up"] = int(state.notfinite_count > cfg.skip_nonfinite_steps)
        return losses

    return step


class ScheduledTrainStep:
    """The NeRF sample-count schedule (reference trainer.py:576-627;
    `renderer.sched: [milestones, n_coarse values, n_fine values]`, empty in
    every shipped config). `make_step(rcfg)` builds the step of one render
    config; `for_iteration(it)` returns it for the config in effect at `it`,
    building it again (and logging the change) when the counts change."""

    def __init__(self, make_step: Callable[[RenderConfig], Callable], rcfg: RenderConfig, sched):
        ms, ncs, nfs = (list(x) for x in sched) if sched else ([], [], [])
        if not len(ms) == len(ncs) == len(nfs):
            raise ValueError(f"renderer.sched rows must align, got {sched}")
        if ms != sorted(ms):
            raise ValueError(f"renderer.sched milestones must increase, got {ms}")
        self._make = make_step
        self._rcfg = rcfg
        self._sched = list(zip(ms, ncs, nfs))
        self.current = (rcfg.n_coarse, rcfg.n_fine)
        self._step = make_step(rcfg)

    def config_at(self, it: int) -> Tuple[int, int]:
        """(n_coarse, n_fine) for iteration `it`, the count of completed
        steps: milestone m applies from the m-th step on."""
        nc, nf = self._rcfg.n_coarse, self._rcfg.n_fine
        for m, c, f in self._sched:
            if it >= m:
                nc, nf = c, f
        return nc, nf

    def rcfg_at(self, it: int) -> RenderConfig:
        nc, nf = self.config_at(it)
        return dataclasses.replace(self._rcfg, n_coarse=nc, n_fine=nf)

    def for_iteration(self, it: int) -> Callable:
        key = self.config_at(it)
        if key != self.current:
            logger.info("NeRF sampling resolution changed on schedule ==> c %d f %d", key[0], key[1])
            self.current = key
            self._step = self._make(self.rcfg_at(it))
        return self._step


def configs_from_dict(config: Dict) -> Tuple[Dict, TrainConfig, RenderConfig, ReconstructionLossConfig]:
    """A training config dict (the YAML's blocks, e.g.
    `models.factory.SCENEDINO_KITTI_360_TRAIN`) -> (model config, TrainConfig,
    RenderConfig, ReconstructionLossConfig), as the reference's stage-1 CLI
    maps them (cli/train.py:114-151): `with_amp` is a bf16 compute dtype
    for the encoder. The sample-count schedule `renderer.sched` is the
    caller's (`ScheduledTrainStep`)."""
    model = {**config["model"], "encoder": dict(config["model"].get("encoder", {}))}
    if config.get("with_amp", False) and not model["encoder"].get("dtype"):
        model["encoder"]["dtype"] = "bfloat16"
    rconf = config.get("renderer", {})
    rcfg = RenderConfig(n_coarse=rconf.get("n_coarse", 32), n_fine=rconf.get("n_fine", 0),
                        lindisp=rconf.get("lindisp", True), hard_alpha_cap=rconf.get("hard_alpha_cap", True))
    tconf = config.get("training", {})
    rs = tconf.get("ray_sampler", {})
    sched = tconf.get("scheduler", {}) or {}
    tcfg = TrainConfig(
        lr=tconf.get("optimizer", {}).get("args", {}).get("lr", 1e-4),
        scheduler_step=sched.get("step_size", 100000),
        scheduler_gamma=sched.get("gamma", 0.1),
        ray_batch_size=rs.get("args", {}).get("ray_batch_size", 2048),
        patch_size=rs.get("args", {}).get("patch_size", 8),
        z_near=rs.get("z_near", 3.0),
        z_far=rs.get("z_far", 80.0),
        compensate_artifacts=model.get("compensate_artifacts", True),
        dino_upscaled=rs.get("args", {}).get("dino_upscaled", False),
        flip_augmentation=model.get("flip_augmentation", True),
        grid_shift_augmentation=model.get("grid_shift_augmentation", True),
        gradient_accum_factor=config.get("gradient_accum_factor", 1),
        loss_renderer_strategy=(model.get("loss_renderer_strategy", {}) or {}).get("name", "kitti_360"),
    )
    return model, tcfg, rcfg, ReconstructionLossConfig()
