"""The stage-1 self-supervised training step (counterpart of
`scenedino_tpu/training/trainer.py`).

One step: pose rebase to frame 0, loss/render frame split, patch-grid
shift and flip augmentation, the frozen teacher on the loss frames, the
student encode of frame 0, patch ray sampling, the coarse volume render,
patch reconstruction, the 64 -> 768 expansion and salience pooling,
artifact compensation, the reconstruction loss, backward, then Adam on
two learning-rate groups (the student ViT at lr x encoder_lr_factor) and
on the artifact field, with the reference's non-finite step skip.

`stage1_eval_forward` is the full-frame validation render.

Every random draw of a step is an explicit input (`Stage1Draws`);
`draw_stage1` draws them from a `torch.Generator` with the reference's
distributions. The loss/render frame split is the KITTI-360 recipe's
("kitti_360": a coin per stereo pair) or the RealEstate10K recipe's
("alternate": one coin for the sample, the even or the odd frames give the
loss), the two that the JAX step runs. Not ported yet (each raises): the
uncertainty and consistency branches, gradient accumulation, the
`debug_stats` scalars, the NeRF sample-count schedule
(`ScheduledTrainStep`) and the occupancy probe of the validation render.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from scenedino_torch.core.ray_sampler import ImageRaySampler, PatchRaySampler
from scenedino_torch.losses.reconstruction import ReconstructionLossConfig, reconstruction_loss
from scenedino_torch.models.field import SceneField
from scenedino_torch.models.upsampler import CropDraws, sample_crop_params
from scenedino_torch.renderer.nerf import FineDraws, RenderConfig, render_rays, render_rays_chunked
from scenedino_torch.training.scheduler import make_schedule

Mark = Optional[Callable[[str], None]]


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
    predict_uncertainty: bool = False
    predict_consistency: bool = False
    dino_upscaled: bool = False
    loss_renderer_strategy: str = "kitti_360"
    debug_stats: bool = False


# the frame splits of the JAX step (scenedino_tpu/training/trainer.py:182-190)
LOSS_RENDERER_STRATEGIES = ("kitti_360", "alternate")


def _check_supported(cfg: TrainConfig) -> None:
    unsupported = {
        "predict_uncertainty": cfg.predict_uncertainty,
        "predict_consistency": cfg.predict_consistency,
        "gradient_accum_factor": cfg.gradient_accum_factor > 1,
        "loss_renderer_strategy": cfg.loss_renderer_strategy not in LOSS_RENDERER_STRATEGIES,
        "debug_stats": cfg.debug_stats,
    }
    bad = [name for name, is_bad in unsupported.items() if is_bad]
    if bad:
        raise NotImplementedError(f"not in the port's stage-1 step: {[(n, getattr(cfg, n)) for n in bad]}")


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
    any other teacher).
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


def draw_stage1(generator: torch.Generator, cfg: TrainConfig, rcfg: RenderConfig, B: int, V: int,
                H: int, W: int, gt_patch: int = 8, crop_views: int = 0) -> Stage1Draws:
    """A step's draws from `generator`, on the generator's device;
    `crop_views` crops of each loss image last (the encoder's `crop_views`)."""
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
    fine = FineDraws.draw(generator, B * cfg.ray_batch_size, rcfg)
    crops = sample_crop_params(generator, B * (V // 2), crop_views) if crop_views else None
    return Stage1Draws(coin, shift, flip, pv, py, px, u, fine, crops)


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
    _check_supported(cfg)
    imgs, poses, projs = batch["imgs"], batch["poses"], batch["projs"]
    B, V = imgs.shape[:2]
    # inv_ex: a singular pose gives non-finite values (the step is then skipped), as in JAX
    poses = torch.linalg.inv_ex(poses[:, :1].float()).inverse @ poses.float()
    ids_loss, ids_render = sample_frame_split(draws.split_coin)
    shift = draws.shift if cfg.grid_shift_augmentation else None

    if artifact_field is not None and cfg.dino_upscaled:
        raise ValueError("artifact compensation is tied to the patch-grid teacher (downsample-prediction configs)")
    # (B, Vl, Cd, Gh, Gw); per pixel (Gh, Gw) = (H, W) in upsample-gt mode
    loss_feats = field.loss_features(imgs, ids_loss, shift, crops=draws.crops).float()
    _mark(mark, "teacher")
    state = field.encode(imgs, projs, poses, ids_encoder=(0,), ids_render=ids_render,
                         flip=draws.flip and cfg.flip_augmentation)
    state.loss_feats = loss_feats
    _mark(mark, "student")

    sampler = PatchRaySampler(cfg.z_near, cfg.z_far, cfg.ray_batch_size, cfg.patch_size, cfg.dino_upscaled)
    dino_feats = loss_feats
    if artifact_field is not None:
        af = artifact_field[None, None].expand(B, loss_feats.shape[1], *artifact_field.shape)
        dino_feats = torch.cat([loss_feats, af], 2)
    frame_ids = torch.tensor(ids_loss, dtype=imgs.dtype, device=imgs.device)
    rays, rgb_gt, dino_gt = sampler.sample(
        imgs[:, ids_loss] * 0.5 + 0.5, poses[:, ids_loss], projs[:, ids_loss],
        draws.pv, draws.py, draws.px, frame_ids=frame_ids, dino_features=dino_feats, grid_shift=shift,
    )
    dino_artifacts = None
    if artifact_field is not None:
        Cd = artifact_field.shape[0]
        dino_gt, dino_artifacts = dino_gt[..., :-Cd], dino_gt[..., -Cd:]

    out = render_rays(lambda xyz, only_density=False: field(state, xyz, only_density=only_density),
                      rays[..., :8], draws.u, rcfg, want_weights=True, fine=draws.fine)
    _mark(mark, "render")

    P, PC = cfg.patch_size, sampler.patch_count
    c = out["coarse"]
    Vr, K = c["rgb"].shape[-1] // 3, c["weights"].shape[-1]
    coarse = {
        "rgb": sampler.reconstruct(c["rgb"]).reshape(B, PC, P, P, Vr, 3),
        "depth": sampler.reconstruct(c["depth"]),
        "invalid": sampler.reconstruct(c["invalid"]).reshape(B, PC, P, P, K, Vr),
        "weights": sampler.reconstruct(c["weights"]),
    }
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
    _mark(mark, "loss")
    return losses["rec_loss"], losses


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
    imgs_gt (B, V, 3, H, W) in [0, 1], projs (B, V, 3, 3) and, with
    `batch["depths"]`, depths_gt.
    """
    if "occ_pts" in batch:
        raise NotImplementedError("the occupancy probe of the validation render is not ported yet")
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
    return data


@dataclasses.dataclass
class TrainState:
    """What a step updates besides the field's parameters (which the
    optimizer holds). `applied` counts the updates applied, the count the
    learning-rate schedule reads; a skipped step does not apply one."""

    optimizer: torch.optim.Optimizer
    artifact_field: Optional[torch.Tensor] = None  # (Cd, Gh, Gw), a leaf that requires grad
    artifact_optimizer: Optional[torch.optim.Optimizer] = None
    step: int = 0
    applied: int = 0
    notfinite_count: int = 0
    total_notfinite: int = 0


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
    _check_supported(cfg)
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


def make_train_step(field: SceneField, cfg: TrainConfig, rcfg: RenderConfig, lcfg: ReconstructionLossConfig):
    """(state, batch, draws, mark=None) -> loss dict; updates the field's
    parameters, the artifact field and `state` in place (trainer.py:517-573).

    The non-finite skip is one decision over every gradient, the
    parameters' and the artifact field's: a step with a NaN or Inf
    anywhere leaves parameters and Adam moments as they were and moves
    the counters, until more than `skip_nonfinite_steps` consecutive bad
    steps, when the update goes through. With an artifact field the
    reference poisons every gradient of such a step with NaN (so the
    update, when it goes through, is all NaN); so does the port. `mark`
    also sees "backward" and "optimizer".
    """
    _check_supported(cfg)
    sched = {"type": cfg.scheduler_type, "step_size": cfg.scheduler_step, "gamma": cfg.scheduler_gamma}

    def step(state: TrainState, batch: Dict[str, torch.Tensor], draws: Stage1Draws, mark: Mark = None):
        state.optimizer.zero_grad(set_to_none=True)
        art = state.artifact_field
        if art is not None:
            art.grad = None
        loss, losses = stage1_forward(field, batch, draws, cfg, rcfg, lcfg, art, mark=mark)
        loss.backward()
        _mark(mark, "backward")

        grads = [p.grad for g in state.optimizer.param_groups for p in g["params"] if p.grad is not None]
        if art is not None and art.grad is not None:
            grads.append(art.grad)
        apply = True
        if cfg.skip_nonfinite_steps > 0:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            state.notfinite_count = 0 if finite else state.notfinite_count + 1
            state.total_notfinite += 0 if finite else 1
            apply = finite or state.notfinite_count > cfg.skip_nonfinite_steps
            if not finite and art is not None:
                for g in grads:
                    g.add_(float("nan"))
        if apply:
            for group in state.optimizer.param_groups:
                group["lr"] = make_schedule(sched, group["base_lr"])(state.applied)
            state.optimizer.step()
            if state.artifact_optimizer is not None:
                state.artifact_optimizer.step()
            state.applied += 1
        state.step += 1
        _mark(mark, "optimizer")

        losses = {k: v.detach() for k, v in losses.items()}
        if cfg.skip_nonfinite_steps > 0:
            losses["nonfinite_consecutive"] = state.notfinite_count
            losses["nonfinite_total"] = state.total_notfinite
            losses["nonfinite_gave_up"] = int(state.notfinite_count > cfg.skip_nonfinite_steps)
        return losses

    return step


def configs_from_dict(config: Dict) -> Tuple[Dict, TrainConfig, RenderConfig, ReconstructionLossConfig]:
    """A training config dict (the YAML's blocks, e.g.
    `models.factory.SCENEDINO_KITTI_360_TRAIN`) -> (model config, TrainConfig,
    RenderConfig, ReconstructionLossConfig), as the reference's stage-1 CLI
    maps them (cli/train.py:114-151): `with_amp` is a bf16 compute dtype
    for the encoder."""
    model = {**config["model"], "encoder": dict(config["model"].get("encoder", {}))}
    if config.get("with_amp", False) and not model["encoder"].get("dtype"):
        model["encoder"]["dtype"] = "bfloat16"
    rconf = config.get("renderer", {})
    if rconf.get("sched"):
        raise NotImplementedError("the NeRF sample-count schedule (renderer.sched) is not ported")
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
