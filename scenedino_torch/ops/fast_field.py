"""Serving paths of the shipped field head (counterpart of
`scenedino_tpu/ops/fast_field.py`): the linear fold (exact, or onto an
int8 grid), the novel-view renders (exact fused, unfused and
probe-guided), the encode-view render, the voxel query and the pipelined
stream step.

The head is lin_out(relu(lin_in([feat, code]))). Bilinear sampling is
linear, so the first layer's feature block commutes with the lookup:
lin_in([sample(F, xy), code]) = sample(F @ W_feat, xy) + code @ W_code + b.
`build_fast_state` folds W_feat into the feature grid once per image;
`encode_prefolded` folds it into the decoder's last conv instead, so the
grid comes out folded. The per-point pipeline then runs in the kernels of
`kernels.point_render`: K2 for the novel-view renders, K3 for the probe,
K4 for the voxel query. The encode-view render needs no lookup at all: its
per-sample work runs in K6 (`kernels.encode_view`).

The int8 grid (`build_fast_state(quantize_grid=True)`) is a serving
option of the reference that is not exact: it runs where the reference
runs it, through the unfused `render_novel_view` and `fast_query` in
plain torch and through K6 after a dequantization. The fused paths (K2,
K3, K4) refuse it, as the reference's do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from scenedino_torch.core import cameras, compositing, encoding, grid_sample
from scenedino_torch.core import rays as rays_mod
from scenedino_torch.core import sampling
from scenedino_torch.kernels import encode_view, point_query, point_render, probe_weights, row_gather
from scenedino_torch.kernels.encode_view import EncodeViewConfig
from scenedino_torch.kernels.point_render import PointRenderConfig, _sample_quads, _sample_grid
from scenedino_torch.models.dpt import DPTHead
from scenedino_torch.models.field import FieldConfig, SceneState
from scenedino_torch.models.heads import ResnetFC
from scenedino_torch.parallel import mesh


class FastFieldState(NamedTuple):
    """Prefolded scene state; grids channels-last."""

    folded_grid: torch.Tensor  # (B, V, Hg, Wg, d_hidden) = feat_grid @ W_feat
    w_code: torch.Tensor  # (code_dims, d_hidden)
    b1: torch.Tensor  # (d_hidden,) fp32
    w2: torch.Tensor  # (d_hidden, d_out)
    b2: torch.Tensor  # (d_out,) fp32
    feat_ks: torch.Tensor
    feat_w2c: torch.Tensor
    color_imgs: torch.Tensor  # (B, V, H, W, 3)
    color_ks: torch.Tensor
    color_w2c: torch.Tensor
    # (d_hidden,) fp32 per-channel scale of an int8 folded grid; None: the exact grid
    grid_scale: Optional[torch.Tensor] = None


INT8_REFUSAL = "fused path is exact-only (no int8 grid)"


def _refuse_int8(fs: FastFieldState) -> None:
    if fs.grid_scale is not None:
        raise NotImplementedError(INT8_REFUSAL)


def quantize_folded(folded: torch.Tensor):
    """Symmetric per-channel int8 of a folded grid (B, V, Hg, Wg, D), fp32
    (reference fast_field.py:94-98): scale = max(amax, 1e-12) / 127 over
    (B, V, Hg, Wg), values clip(round(folded / scale), -127, 127), rounded
    half to even as jnp.round. Returns (int8 grid, scale (D,) fp32)."""
    amax = folded.abs().amax(dim=(0, 1, 2, 3))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    return torch.clamp(torch.round(folded / scale), -127, 127).to(torch.int8), scale


def can_fold(field, head_name: str = "normal_head", head_confs=None) -> bool:
    """True when the fold applies: the single n_blocks=0 ResnetFC head,
    sampled colours and a predicted DINO feature, no learned empty feature.

    head_confs (default `field.head_confs`): a relu resnet head only;
    beta > 0 (softplus activation) and d_latent > 0 (latent row mixing)
    leave no trace in the parameters but change the math the fold
    hard-codes, so they refuse it (reference fast_field.py:184-223)."""
    cfg = field.cfg
    if cfg.learn_empty or not (cfg.sample_color and cfg.predict_dino):
        return False
    if head_confs is None:
        head_confs = getattr(field, "head_confs", ())
    for name, conf in head_confs:
        if name != head_name:
            continue
        args = dict(conf).get("args", {}) or {}
        if dict(conf).get("type", "resnet") != "resnet":
            return False
        if args.get("beta", 0.0) > 0 or args.get("d_latent", 0) > 0:
            return False
    head = field.heads[head_name] if list(field.heads.keys()) == [head_name] else None
    return isinstance(head, ResnetFC) and head.n_blocks == 0


def _refuse_unfoldable(field, head_name: str, caller: str) -> None:
    if not can_fold(field, head_name):
        raise ValueError(
            f"{caller}: head/config not foldable (needs the shipped n_blocks=0 relu "
            "ResnetFC single head, sample_color + predict_dino, learn_empty off)"
        )


def _fast_state(head, state: SceneState, folded: torch.Tensor, w_code: torch.Tensor,
                compute_dtype: torch.dtype, grid_scale: Optional[torch.Tensor] = None) -> FastFieldState:
    """The state around a folded grid (B, V, Hg, Wg, d_hidden), stored in
    `compute_dtype` unless it is int8 (then `grid_scale` is its scale)."""
    return FastFieldState(
        folded_grid=(folded if grid_scale is not None else folded.to(compute_dtype)).contiguous(),
        w_code=w_code.to(compute_dtype).contiguous(),
        b1=head.lin_in.bias.detach().float().contiguous(),
        w2=head.lin_out.weight.detach().float().T.to(compute_dtype).contiguous(),
        b2=head.lin_out.bias.detach().float().contiguous(),
        feat_ks=state.feat_ks.float().contiguous(),
        feat_w2c=state.feat_w2c.float().contiguous(),
        color_imgs=state.color_imgs.permute(0, 1, 3, 4, 2).to(compute_dtype).contiguous(),
        color_ks=state.color_ks.float().contiguous(),
        color_w2c=state.color_w2c.float().contiguous(),
        grid_scale=grid_scale,
    )


@torch.no_grad()
def build_fast_state(field, state: SceneState, head_name: str = "normal_head",
                     compute_dtype: torch.dtype = torch.bfloat16, quantize_grid: bool = False) -> FastFieldState:
    """Fold the head's first layer into the feature grid (exact; fp32 fold,
    stored in `compute_dtype`).

    quantize_grid: store the folded grid int8 with a per-channel scale
    (`quantize_folded`; reference fast_field.py:49-111), a serving option that is not
    exact; the scale is applied after the bilinear blend, which it commutes
    with. The weights and colours stay in `compute_dtype`."""
    _refuse_unfoldable(field, head_name, "build_fast_state")
    head = field.heads[head_name]
    k1 = head.lin_in.weight.detach().float().T  # (C + code, d_hidden)
    C = state.feat_grid.shape[2]
    folded = torch.einsum("bvchw,cd->bvhwd", state.feat_grid.float(), k1[:C])
    grid_scale = None
    if quantize_grid:
        folded, grid_scale = quantize_folded(folded)
    return _fast_state(head, state, folded, k1[C:], compute_dtype, grid_scale)


@torch.no_grad()
def encode_prefolded(field, imgs: torch.Tensor, projs: torch.Tensor, poses_c2w: torch.Tensor,
                     ids_encoder=(0,), ids_render=None, head_name: str = "normal_head",
                     compute_dtype: torch.dtype = torch.bfloat16) -> FastFieldState:
    """`encode` + `build_fast_state` with W_feat folded into the DPT head's
    final conv (reference fast_field.py:114-181): conv(x, K) @ W ==
    conv(x, K @ W), so the decoder writes the d_hidden-channel folded grid
    directly, at half the conv's work, and the full-width grid never
    reaches memory. Equal to the two-step fold up to fp reassociation; an
    encoder without a DPT decoder takes the two-step fold.
    imgs (B, V, 3, H, W) in [-1, 1]; projs (B, V, 3, 3); poses_c2w (B, V, 4, 4).
    """
    _refuse_unfoldable(field, head_name, "encode_prefolded")
    decoder = getattr(field.encoder, "decoder", None)
    if not isinstance(decoder, DPTHead):
        state = field.encode(imgs, projs, poses_c2w, ids_encoder=ids_encoder, ids_render=ids_render)
        return build_fast_state(field, state, head_name, compute_dtype)
    head = field.heads[head_name]
    k1 = head.lin_in.weight.detach().float().T
    C = decoder.head_conv1.weight.shape[0]
    state = field.encode(imgs, projs, poses_c2w, ids_encoder=ids_encoder, ids_render=ids_render,
                         fold_matrix=k1[:C])
    return _fast_state(head, state, state.feat_grid.permute(0, 1, 3, 4, 2), k1[C:], compute_dtype)


def _point_config(cfg: FieldConfig, hard_alpha_cap: bool = True,
                  depth_statistic: str = "expectation") -> PointRenderConfig:
    return PointRenderConfig(
        z_near=cfg.z_near, z_far=cfg.z_far, inv_z=cfg.inv_z, code_mode=cfg.code_mode,
        num_freqs=cfg.num_freqs, freq_factor=cfg.freq_factor, include_input=cfg.include_input,
        hard_alpha_cap=hard_alpha_cap, depth_statistic=depth_statistic,
    )


def _single_view(fs: FastFieldState, caller: str):
    """The field tensors of a 1-view state, as the point kernels take them."""
    B, V = fs.folded_grid.shape[:2]
    if B != 1 or V != 1:
        raise ValueError(f"{caller} expects 1 encode view, got B={B}, V={V}")
    return (fs.folded_grid[0, 0], fs.w_code, fs.b1, fs.w2, fs.b2, fs.feat_w2c[0, 0], fs.feat_ks[0, 0])


def _colour_view(fs: FastFieldState):
    return fs.color_imgs[0, 0], fs.color_w2c[0, 0], fs.color_ks[0, 0]


def _target_rays(cfg: FieldConfig, target_pose_c2w: torch.Tensor, target_k: torch.Tensor,
                 height: int, width: int) -> torch.Tensor:
    r, _ = rays_mod.rays_from_k(target_pose_c2w[None].float(), target_k[None].float(),
                                width, height, cfg.z_near, cfg.z_far)
    return r.reshape(height, width, 8)


@torch.no_grad()
def render_novel_view_fused(fs: FastFieldState, cfg: FieldConfig, target_pose_c2w: torch.Tensor,
                            target_k: torch.Tensor, height: int, width: int,
                            u: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            n_coarse: int = 32, lindisp: bool = True,
                            hard_alpha_cap: bool = True, depth_statistic: str = "expectation"):
    """Full-frame render of an arbitrary camera from one encode view.

    target_pose_c2w (4, 4); target_k (3, 3) normalized intrinsics. The
    stratum draws `u` (height*width, n_coarse) are an explicit input, drawn
    from `generator` when None. Returns (depth (H, W) as E[z] or the weight
    median, dino (H, W, d_out-1), rgb (H, W, 3)), fp32. An int8 state
    raises `NotImplementedError`, as the reference's fused path does.
    """
    _refuse_int8(fs)
    field_args = _single_view(fs, "render_novel_view_fused")
    flat = _target_rays(cfg, target_pose_c2w, target_k, height, width).reshape(-1, 8).contiguous()
    z = sampling.sample_coarse(flat, n_coarse, lindisp, u=u, generator=generator).contiguous()
    depth, dino, rgb = point_render(flat, z, *field_args, *_colour_view(fs),
                                    _point_config(cfg, hard_alpha_cap, depth_statistic))
    return depth.reshape(height, width), dino.reshape(height, width, -1), rgb.reshape(height, width, 3)


def replicate_state(fs: FastFieldState, devices) -> dict:
    """The state on each distinct device of `devices` (itself where it lies)."""
    return {d: FastFieldState(*(None if t is None else t.to(d) for t in fs)) for d in mesh.distinct(devices)}


@torch.no_grad()
def render_novel_view_fused_sharded(fs: FastFieldState, cfg: FieldConfig, target_pose_c2w: torch.Tensor,
                                    target_k: torch.Tensor, height: int, width: int, devices,
                                    u: Optional[torch.Tensor] = None,
                                    generator: Optional[torch.Generator] = None,
                                    n_coarse: int = 32, lindisp: bool = True, hard_alpha_cap: bool = True,
                                    depth_statistic: str = "expectation", rows_per_seg: int = 4,
                                    states: Optional[dict] = None):
    """`render_novel_view_fused` over a list of devices (reference
    fast_field.py:600-676): the frame splits into `height // rows_per_seg`
    strips of rows, dealt to `devices` in contiguous blocks; each device
    renders its block through K2 against its replica of the state, with no
    collective. Rays and strata are made once for the whole frame (`u`,
    else drawn from `generator`), so the result is the single-device
    render's bit for bit for any list of devices. `states` maps each
    device to its replica (`replicate_state`; built here when None). The
    outputs land on the first device."""
    _refuse_int8(fs)
    devices = [torch.device(d) for d in devices]
    if height % rows_per_seg:
        raise AssertionError(f"height {height} is not a multiple of rows_per_seg {rows_per_seg}")
    n_seg, n_dev = height // rows_per_seg, len(devices)
    if n_seg % n_dev:
        raise AssertionError(f"{n_seg} segments not divisible over {n_dev} devices")
    _single_view(fs, "render_novel_view_fused_sharded")
    flat = _target_rays(cfg, target_pose_c2w, target_k, height, width).reshape(-1, 8).contiguous()
    z = sampling.sample_coarse(flat, n_coarse, lindisp, u=u, generator=generator)
    states = states or replicate_state(fs, devices)
    pcfg = _point_config(cfg, hard_alpha_cap, depth_statistic)
    flats, zs = flat.tensor_split(n_dev), z.tensor_split(n_dev)

    def share(i: int, d: torch.device):
        fs_d = states[d]
        out = point_render(flats[i].to(d).contiguous(), zs[i].to(d).contiguous(),
                           *_single_view(fs_d, "render_novel_view_fused_sharded"), *_colour_view(fs_d), pcfg)
        return [t.to(devices[0]) for t in out]

    depth, dino, rgb = (torch.cat(parts) for parts in zip(*mesh.run_shares(share, devices)))
    return depth.reshape(height, width), dino.reshape(height, width, -1), rgb.reshape(height, width, 3)


@torch.no_grad()
def render_novel_view(fs: FastFieldState, cfg: FieldConfig, target_pose_c2w: torch.Tensor,
                      target_k: torch.Tensor, height: int, width: int,
                      u: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                      n_coarse: int = 32, lindisp: bool = True, hard_alpha_cap: bool = True,
                      want_rgb: bool = True, depth_statistic: str = "expectation"):
    """The unfused full-frame render of an arbitrary camera from one encode
    view (reference fast_field.py:393-529), in plain torch as the reference
    runs it in XLA: every sample point's projection, code, bilinear lookup
    in the folded grid and the head's two products, then compositing.

    Takes the exact grid and the int8 grid: the int8 corners are blended in
    fp32 and scaled after the blend (:470-481). On a bf16 state the (P,
    d_hidden) activation is stored in bf16 between the two products, as the
    reference stores it (:496-500). Colours come from the first render view
    through the reference's packed-quad lookup, blended in the image's dtype
    (`kernels.point_render._sample_quads`). The strata
    `u` (height*width, n_coarse) are an explicit input (the reference draws
    them from the first of a five-way key split, :446), drawn from
    `generator` when None. Returns (depth (H, W), dino (H, W, d_out-1), rgb
    (H, W, 3) or None), fp32.
    """
    B, V = fs.folded_grid.shape[:2]
    if B != 1 or V != 1:
        raise ValueError(f"render_novel_view expects 1 encode view, got B={B}, V={V}")
    K = n_coarse
    flat = _target_rays(cfg, target_pose_c2w, target_k, height, width).reshape(-1, 8)
    z = sampling.sample_coarse(flat, K, lindisp, u=u, generator=generator)  # (R, K)
    pts = (flat[:, None, :3] + z[..., None] * flat[:, None, 3:6]).reshape(1, -1, 3)  # (1, P, 3)

    xy, zc, dist, _ = cameras.project_points(pts, fs.feat_w2c, fs.feat_ks)
    coords = encoding.encode_coords(xy, zc, dist, cfg.z_near, cfg.z_far, mode=cfg.code_mode, inv_z=cfg.inv_z)
    code = encoding.positional_encoding(coords, cfg.num_freqs, cfg.freq_factor, cfg.include_input)[0, 0]
    g2d = fs.folded_grid[0, 0]
    Hg, Wg = g2d.shape[:2]
    px = (xy[0, 0, :, 0] + 1.0) * 0.5 * Wg - 0.5
    py = (xy[0, 0, :, 1] + 1.0) * 0.5 * Hg - 0.5
    if fs.grid_scale is not None:
        sampled = _sample_quads(g2d, px, py) * fs.grid_scale
    else:
        sampled = _sample_grid(g2d, px, py)  # (P, d_hidden) fp32
    h = torch.relu(sampled + code.to(fs.w_code.dtype).float() @ fs.w_code.float() + fs.b1)
    if fs.w2.dtype == torch.bfloat16:
        h = h.to(torch.bfloat16)
    out = h.float() @ fs.w2.float() + fs.b2  # (P, d_out)
    sigma = F.softplus(out[:, 0]).reshape(-1, K)
    comp = compositing.composite_rays(sigma, z, hard_alpha_cap, depth_statistic=depth_statistic)
    depth = comp.depth.reshape(height, width)
    dino = compositing.weighted_reduce(comp.weights, out[:, 1:].reshape(-1, K, out.shape[1] - 1))
    rgb = None
    if want_rgb:
        img = fs.color_imgs[0, 0]  # (Hc, Wc, 3)
        Hc, Wc = img.shape[:2]
        xy_c = cameras.project_points(pts, fs.color_w2c[:, :1], fs.color_ks[:, :1])[0]
        cx = (xy_c[0, 0, :, 0] + 1.0) * 0.5 * Wc - 0.5
        cy = (xy_c[0, 0, :, 1] + 1.0) * 0.5 * Hc - 0.5
        rgb_k = _sample_quads(img, cx, cy).float().reshape(-1, K, img.shape[-1])
        rgb = compositing.weighted_reduce(comp.weights, rgb_k).reshape(height, width, -1)
    return depth, dino.reshape(height, width, -1), rgb


class ProbeDraws(NamedTuple):
    """Every draw of one probe-guided render, in [0, 1). The reference
    splits its key into (kp, kf, ku) (fast_field.py:748) and kf again into
    the bin picks and their places (sampling.py:81)."""

    u_probe: torch.Tensor  # (Rp, n_probe) strata of the probe rays
    u_fine: torch.Tensor  # (R, n_fine) bin picks of the importance resampling
    t_fine: torch.Tensor  # (R, n_fine) places inside the picked bins
    u_uniform: Optional[torch.Tensor]  # (R, n_uniform) safety strata; None when n_uniform = 0


def draw_probe(height: int, width: int, generator: Optional[torch.Generator] = None, device=None,
               n_probe: int = 16, n_fine: int = 10, n_uniform: int = 2, probe_stride: int = 4) -> ProbeDraws:
    """Draw a `ProbeDraws` from `generator`."""
    R, Rp = height * width, (height // probe_stride) * (width // probe_stride)

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return ProbeDraws(rand(Rp, n_probe), rand(R, n_fine), rand(R, n_fine),
                      rand(R, n_uniform) if n_uniform > 0 else None)


@torch.no_grad()
def render_novel_view_probe(fs: FastFieldState, cfg: FieldConfig, target_pose_c2w: torch.Tensor,
                            target_k: torch.Tensor, height: int, width: int,
                            draws: Optional[ProbeDraws] = None,
                            generator: Optional[torch.Generator] = None,
                            n_probe: int = 16, n_fine: int = 10, n_uniform: int = 2,
                            probe_stride: int = 4, lindisp: bool = True, hard_alpha_cap: bool = True,
                            want_rgb: bool = True, depth_statistic: str = "expectation"):
    """Two-pass probe-guided novel-view render (reference fast_field.py:678-789).

    Pass 1: a sigma-only probe (K3) of the (H/s) x (W/s) strided rays at
    `n_probe` stratified samples gives each probe ray its compositing
    weights, a histogram of where along the ray the mass lies. Every
    full-resolution ray reads its probe pixel's histogram and depths (a
    nearest upsample through `row_gather`), resamples `n_fine` depths from
    it (`sampling.sample_coarse_from_dist`), adds `n_uniform` stratified
    safety samples, sorts them, and renders through K2 on those
    n_fine + n_uniform samples. A serving mode, not the exact path: its
    samples are placed unlike `render_novel_view_fused`'s.

    `draws` holds every draw (drawn from `generator` when None). Returns
    (depth (H, W), dino (H, W, d_out-1), rgb (H, W, 3) or None), fp32. An
    int8 state raises `NotImplementedError`, as the reference's does.
    """
    _refuse_int8(fs)
    field_args = _single_view(fs, "render_novel_view_probe")
    s = probe_stride
    if height % s or width % s:
        raise ValueError(f"render_novel_view_probe: H={height} and W={width} must divide by the stride {s}")
    Hp, Wp = height // s, width // s
    device = fs.folded_grid.device
    if draws is None:
        draws = draw_probe(height, width, generator, device, n_probe, n_fine, n_uniform, s)
    prc = _point_config(cfg, hard_alpha_cap, depth_statistic)

    grid_rays = _target_rays(cfg, target_pose_c2w, target_k, height, width)
    flat = grid_rays.reshape(-1, 8).contiguous()
    probe_rays = grid_rays[::s, ::s].reshape(-1, 8).contiguous()
    zp = sampling.sample_coarse(probe_rays, n_probe, lindisp, u=draws.u_probe).contiguous()
    grid, w_code, b1, w2, b2, feat_w2c, feat_k = field_args
    w_probe = probe_weights(probe_rays, zp, grid, w_code, b1, w2[:, :1].contiguous(), b2[:1].contiguous(),
                            feat_w2c, feat_k, prc)  # (Rp, n_probe)

    # nearest upsample: pixel (y, x) reads probe row (y // s) * Wp + x // s
    rows = torch.arange(height, device=device) // s
    cols = torch.arange(width, device=device) // s
    idx = (rows[:, None] * Wp + cols[None]).reshape(-1).to(torch.int32)
    table = torch.cat([w_probe, zp], -1)
    table = F.pad(table, (0, -table.shape[1] % 4)).contiguous()  # the card's gather takes rows of 16-byte multiples
    full = row_gather(table, idx)
    w_full, z_full = full[:, :n_probe], full[:, n_probe:2 * n_probe]

    z = sampling.sample_coarse_from_dist(flat, w_full, z_full, n_fine, lindisp,
                                         u=draws.u_fine, t=draws.t_fine)
    if n_uniform > 0:
        z = torch.cat([z, sampling.sample_coarse(flat, n_uniform, lindisp, u=draws.u_uniform)], -1)
    z = torch.sort(z, -1).values.contiguous()  # compositing needs sorted depths
    depth, dino, rgb = point_render(flat, z, *field_args, *_colour_view(fs), prc)
    rgb = rgb.reshape(height, width, 3) if want_rgb else None
    return depth.reshape(height, width), dino.reshape(height, width, -1), rgb


SEG_BLOCK = 128 * 128 * 32  # points a call of fast_query_fused's seg_fn takes at most


@torch.no_grad()
def fast_query_fused(fs: FastFieldState, cfg: FieldConfig, xyz: torch.Tensor,
                     segments: int = 64, band: int = 128, seg_fn=None):
    """`fast_query(only_density=True)` of one encode view through K4
    (reference fast_field.py:990-1035): xyz (P, 3) world points ->
    (sigma (P,), feature (P, d_out-1)) fp32, or (sigma, seg_fn(feature))
    when `seg_fn` is given.

    seg_fn: a callable on a (p, d_out-1) block of features, such as the
    SSC path's expansion to 768 and the stage-2 head
    (`SceneField.segment_features`). It runs on blocks of at most
    `SEG_BLOCK` points, as the reference runs it inside its per-segment
    map: at 2,097,152 voxel centres the 768-wide fp32 features alone would
    take 6.4 GB. `segments` and `band` tune the TPU's banded gather; the
    port takes them and ignores them. An int8 state raises
    `NotImplementedError`, as the reference's does.
    """
    _refuse_int8(fs)
    sigma, feat = point_query(xyz.float().contiguous(), *_single_view(fs, "fast_query_fused"),
                              _point_config(cfg))
    if seg_fn is None:
        return sigma, feat
    return sigma, torch.cat([seg_fn(feat[p0:p0 + SEG_BLOCK]) for p0 in range(0, feat.shape[0], SEG_BLOCK)])


@torch.no_grad()
def fast_query(fs: FastFieldState, cfg: FieldConfig, xyz: torch.Tensor, only_density: bool = False,
               segments: Optional[int] = None, band: int = 32):
    """Drop-in for `SceneField.forward` on the fast state (reference
    fast_field.py:1038-1114), in plain torch as the reference computes it
    in XLA: xyz (B, P, 3) -> (rgb (B, P, Vr*3) or None, invalid, sigma
    (B, P), dino (B, P, dino_dims)). `segments` and `band` tune the TPU's
    banded gather; the port takes them and ignores them. An int8 grid is
    sampled in fp32 and scaled after the blend (reference :1075-1083).
    """
    B, P, _ = xyz.shape
    xy, z, dist, invalid_f = cameras.project_points(xyz, fs.feat_w2c, fs.feat_ks)
    coords = encoding.encode_coords(xy, z, dist, cfg.z_near, cfg.z_far, mode=cfg.code_mode, inv_z=cfg.inv_z)
    code = encoding.positional_encoding(coords, cfg.num_freqs, cfg.freq_factor, cfg.include_input)
    sampled = grid_sample.grid_sample_views_hwc(fs.folded_grid, xy)  # (B, V, P, d_hidden) fp32
    if fs.grid_scale is not None:
        sampled = sampled * fs.grid_scale
    h = torch.relu(sampled + code.to(fs.w_code.dtype).float() @ fs.w_code.float() + fs.b1)
    out = h.to(fs.w2.dtype).float() @ fs.w2.float() + fs.b2
    out = out.transpose(1, 2).mean(2)  # collapse the (single) view axis
    sigma = F.softplus(out[..., 0])
    dino = out[..., 1:] if cfg.predict_dino else None
    inv_feat = invalid_f[..., 0].transpose(1, 2)  # (B, P, V)
    if only_density:
        return None, inv_feat.float(), sigma, dino
    xy_c, _, _, invalid_c = cameras.project_points(xyz, fs.color_w2c, fs.color_ks)
    colors = grid_sample.grid_sample_views_hwc(fs.color_imgs, xy_c)
    Vr, Cc = colors.shape[1], colors.shape[-1]
    rgb = colors.transpose(1, 2).reshape(B, P, Vr * Cc)
    inv_c = invalid_c[..., 0].transpose(1, 2)
    invalid = (inv_c | inv_feat.all(-1, keepdim=True)).to(rgb.dtype)
    return rgb, invalid, sigma, dino


@torch.no_grad()
def render_encode_view(fs: FastFieldState, cfg: FieldConfig, height: int, width: int,
                       u: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                       n_coarse: int = 32, lindisp: bool = True, hard_alpha_cap: bool = True,
                       depth_statistic: str = "expectation"):
    """Render the encode camera's own view with no feature lookup
    (reference fast_field.py:254-390).

    Every sample on pixel p's ray projects back to p, so the bilinear
    lookup reads the folded map at p: a 2x2 mean where the grid is twice
    the render size, the map itself at equal size, a true NDC lookup
    (`grid_sample_views_hwc`) at any other ratio. The positional code's
    x/y channels are constant along a ray: W_code splits into a per-pixel
    bias (x, y channels) and the per-sample z channels. The colour is the
    render-view image itself times the ray's total weight, so it must be
    the render size. The per-sample work runs in the K6 kernel
    (`kernels.encode_view`). The strata `u` (height*width, n_coarse) are an
    explicit input (the reference draws them from the first of a
    five-way key split, :294), drawn from `generator` when None.
    Returns (depth (H, W), dino (H, W, d_out-1), rgb (H, W, 3)), fp32.

    The kernel takes any n_coarse, d_hidden, d_out and z-code width: every
    shipped config (8, 32 or 48 samples, d_hidden 64 or 128, d_out 17 or
    65, 13 z rows) runs its shipped instantiations, wider fields its wide
    walk (csrc/wide_walk.cuh); on the CPU the plain version takes any size.
    """
    B, V = fs.folded_grid.shape[:2]
    if B != 1 or V != 1:
        raise ValueError(f"render_encode_view expects 1 view, got B={B}, V={V}")
    depth, dino, rgb = render_encode_view_batched(fs, cfg, height, width, None if u is None else u[None],
                                                  generator, n_coarse, lindisp, hard_alpha_cap, depth_statistic)
    return depth[0], dino[0], rgb[0]


@torch.no_grad()
def render_encode_view_batched(fs: FastFieldState, cfg: FieldConfig, height: int, width: int,
                               u: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None, n_coarse: int = 32,
                               lindisp: bool = True, hard_alpha_cap: bool = True,
                               depth_statistic: str = "expectation"):
    """`render_encode_view` of every batch element of a (B, V)-view state,
    view 0 of each (the stage-2 full-frame render: each sample renders its
    own encode camera), all B frames in one K6 launch, at any n_coarse and
    width (`render_encode_view`). u (B, height*width,
    n_coarse) or None. Returns (depth (B, H, W), dino (B, H, W, D), rgb
    (B, H, W, 3))."""
    B = fs.folded_grid.shape[0]
    args, ecfg = encode_view_inputs(fs, cfg, height, width, u, generator, n_coarse, lindisp, hard_alpha_cap,
                                    depth_statistic)
    depth, dino, rgb = encode_view(*args, ecfg)
    return depth.reshape(B, height, width), dino.reshape(B, height, width, -1), rgb.reshape(B, height, width, 3)


def encode_view_inputs(fs: FastFieldState, cfg: FieldConfig, height: int, width: int,
                       u: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                       n_coarse: int = 32, lindisp: bool = True, hard_alpha_cap: bool = True,
                       depth_statistic: str = "expectation"):
    """The per-pixel preamble of the encode-view render of view 0 of each of
    the B frames: the arguments of `kernels.encode_view` for all B x height x
    width rays, (base, z, zscale, w_z, w2, b2, color), and its config.
    u (B, height*width, n_coarse) or None (drawn from `generator`)."""
    B = fs.folded_grid.shape[0]
    R = height * width
    rgb_map = fs.color_imgs[:, 0]
    if rgb_map.shape[1:3] != (height, width):
        raise ValueError(f"render_encode_view: color image {tuple(rgb_map.shape[1:3])} != render size "
                         f"{(height, width)}; use the generic renderer")
    kmat = fs.feat_ks[:, 0].float()
    device = kmat.device
    pose_c2w = torch.linalg.inv_ex(fs.feat_w2c[:, 0].float()).inverse  # no raise, no host sync, as in JAX
    r, xy_img = rays_mod.rays_from_k(pose_c2w, kmat, width, height, cfg.z_near, cfg.z_far)
    if u is not None:
        if tuple(u.shape) != (B, R, n_coarse):
            raise ValueError(f"u must be {(B, R, n_coarse)}, got {tuple(u.shape)}")
        u = u.reshape(B * R, n_coarse)
    z = sampling.sample_coarse(r.reshape(-1, 8), n_coarse, lindisp, u=u, generator=generator)  # (B R, K)
    if cfg.code_mode == "z":  # the code's depth is camera z; z is the ray distance
        focal = torch.stack([kmat[:, 0, 0], kmat[:, 1, 1]], -1)
        centre = torch.stack([kmat[:, 0, 2], kmat[:, 1, 2]], -1)
        dirs_cam, _ = rays_mod.unproj_map(width, height, focal, c=centre, device=device)
        zscale = dirs_cam[..., 2].reshape(-1)
    else:
        zscale = torch.ones(B * R, device=device)

    n_code = fs.w_code.shape[0]
    z_mask = torch.arange(n_code, device=device) % 3 == 2
    w_xy = fs.w_code[~z_mask].float()
    xy = xy_img[0].reshape(-1, 2)  # exact NDC pixel centres, the same in every frame
    code_xy = encoding.positional_encoding(torch.cat([xy, torch.zeros_like(xy[:, :1])], -1), cfg.num_freqs,
                                           cfg.freq_factor, cfg.include_input)[:, ~z_mask]
    pixel_bias = code_xy.to(fs.w_code.dtype).float() @ w_xy  # (R, d_hidden)

    g2d = fs.folded_grid[:, 0]
    if fs.grid_scale is not None:  # no lookup here: dequantize first (reference :334-336); the mean stays fp32
        g2d = g2d.float() * fs.grid_scale
    Hg, Wg, D = g2d.shape[1:]
    if (Hg, Wg) == (2 * height, 2 * width):
        # render pixel centres fall midway between grid pixels: a 2x2 mean
        g2d = g2d.float().reshape(B, height, 2, width, 2, D).mean((2, 4)).to(g2d.dtype)
    elif (Hg, Wg) != (height, width):
        xs = torch.linspace(-1 + 1 / width, 1 - 1 / width, width, device=device)
        ys = torch.linspace(-1 + 1 / height, 1 - 1 / height, height, device=device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        centres = torch.stack([gx, gy], -1).reshape(1, 1, -1, 2).expand(B, 1, R, 2)
        g2d = grid_sample.grid_sample_views_hwc(g2d[:, None], centres)[:, 0]
    base = (g2d.reshape(B, R, D).float() + pixel_bias + fs.b1).reshape(B * R, D)
    ecfg = EncodeViewConfig(z_near=cfg.z_near, z_far=cfg.z_far, inv_z=cfg.inv_z, num_freqs=cfg.num_freqs,
                            freq_factor=cfg.freq_factor, include_input=cfg.include_input,
                            hard_alpha_cap=hard_alpha_cap, depth_statistic=depth_statistic)
    args = (base.contiguous(), z.contiguous(), zscale.contiguous(), fs.w_code[z_mask].contiguous(), fs.w2, fs.b2,
            rgb_map.reshape(B * R, 3).float().contiguous())
    return args, ecfg


def make_pipelined_stream_step(field, height: int, width: int, n_coarse: int = 32):
    """The pipelined video/novel-view stream (reference fast_field.py:1117-1173):
    one step renders the previous frame's folded bf16 state at a novel
    camera through `render_novel_view_fused` (K2), then encodes the next
    frame and folds it (`build_fast_state`).

        step(fs_prev, imgs, projs, poses, target_pose, target_k, u=None,
             generator=None) -> (fs_next, (depth, dino, rgb))

    imgs (1, 1, 3, H, W), projs (1, 1, 3, 3), poses (1, 1, 4, 4) are the next
    frame's encode inputs; target_pose (4, 4) cam2world and target_k (3, 3)
    the rendered camera; `u` the render's strata (drawn from `generator`
    when None). Bootstrap `fs_prev` with the same encode and fold of frame
    0. The two halves run in turn on the current stream, so the outputs are
    the two-call sequence's bit for bit (the reference measured that XLA
    does not overlap them either, :1131-1140).
    """

    @torch.no_grad()
    def step(fs_prev, imgs, projs, poses, target_pose, target_k, u=None, generator=None):
        out = render_novel_view_fused(fs_prev, field.cfg, target_pose, target_k, height, width, u=u,
                                      generator=generator, n_coarse=n_coarse)
        return build_fast_state(field, field.encode(imgs, projs, poses, ids_encoder=(0,))), out

    return step
