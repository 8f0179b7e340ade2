"""K2, K3 and K4: the folded field's per-point pipeline in one CUDA source.

All three run projection -> positional code -> 4-corner bilinear lookup in
the folded grid -> the head's two products, per point, in the kernels of
`csrc/point_render.cu` (one copy of the pipeline, three output modes):

- `point_render` (K2): rays and their sample depths -> per-ray depth (E[z]
  or the weight median), feature and colour. Replaces the XLA-fused point
  pipeline of `scenedino_tpu/ops/fast_field.py:825-987`.
- `probe_weights` (K3): the sigma-only probe of the probe-guided render:
  rays and depths -> compositing weights. Replaces `_probe_weights_body`
  (fast_field.py:792-822).
- `point_query` (K4): world points -> sigma and the feature, no
  compositing. Replaces `fast_query_fused` (fast_field.py:990-1035).

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it takes its plain version, the same math in torch over chunks so that
memory stays bounded.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from scenedino_torch.core import cameras, compositing, encoding
from scenedino_torch.kernels import build

DEPTH_STATISTICS = ("expectation", "median")
MODES = {"point_render": 0, "probe_weights": 1, "point_query": 2}
# what the shipped instantiations of the CUDA kernels hold (csrc/point_render.cu's
# `shipped`): samples a ray, hidden width (a multiple of 8), output width,
# code columns; past any of them the wide walk runs
SHIPPED_SAMPLES, SHIPPED_HIDDEN, SHIPPED_OUT, SHIPPED_CODE = 256, 128, 128, 64


@dataclasses.dataclass(frozen=True)
class PointRenderConfig:
    """The field and compositing constants the point pipeline needs."""

    z_near: float = 3.0
    z_far: float = 80.0
    inv_z: bool = True
    code_mode: str = "z"  # "z" | "distance"
    num_freqs: int = 6
    freq_factor: float = 1.5
    include_input: bool = True
    hard_alpha_cap: bool = True
    depth_statistic: str = "expectation"  # "expectation" | "median"

    @property
    def code_dims(self) -> int:
        return encoding.positional_encoding_dims(self.num_freqs, 3, self.include_input)


def _to_pixel(v: torch.Tensor, n: int) -> torch.Tensor:
    """NDC -> continuous pixel coordinate (align_corners=False)."""
    return (v + 1.0) * 0.5 * n - 0.5


def _corners(x: torch.Tensor, y: torch.Tensor, H: int, W: int):
    x0, y0 = torch.floor(x), torch.floor(y)
    xi, yi = x0.long(), y0.long()
    return (
        (yi.clamp(0, H - 1), xi.clamp(0, W - 1), (yi + 1).clamp(0, H - 1), (xi + 1).clamp(0, W - 1)),
        x - x0,
        y - y0,
    )


def _sample_grid(grid: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear rows of an (H, W, D) grid at pixel coords, blended in fp32
    with clamped corners (grid_sample's border rule)."""
    H, W, D = grid.shape
    (y0, x0, y1, x1), wx, wy = _corners(x, y, H, W)
    flat = grid.reshape(H * W, D)

    def rows(i):  # index_select: the same rows as flat[i], about twice as fast on the CPU
        return torch.index_select(flat, 0, i).float()

    wx, wy = wx[:, None], wy[:, None]
    top = rows(y0 * W + x0) * (1.0 - wx) + rows(y0 * W + x1) * wx
    bot = rows(y1 * W + x0) * (1.0 - wx) + rows(y1 * W + x1) * wx
    return top * (1.0 - wy) + bot * wy


def _sample_quads(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear rows of an (H, W, C) map at pixel coords as the reference's
    packed 2x2 quads blend them (`ops/tile_gather.py` `pack_quads` and
    `_quad_weights`): corners clamped, an axis' weight 0 where clamping
    makes its two corners one. An int8 map is blended in fp32, any other
    in its own dtype with the weights rounded to it first (the reference's
    `bilinear_gather_packed_plain` on a bf16 colour image); K2 blends fp32
    colours, so its plain version passes an fp32 image."""
    H, W, C = img.shape
    (y0, x0, y1, x1), wx, wy = _corners(x, y, H, W)
    wx = torch.where(x1 > x0, wx, torch.zeros_like(wx))
    wy = torch.where(y1 > y0, wy, torch.zeros_like(wy))
    w4 = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy], -1)
    flat = img.reshape(H * W, C)
    rows = torch.stack([torch.index_select(flat, 0, i) for i in (y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1)],
                       1)
    if rows.dtype == torch.int8:
        rows = rows.float()
    else:
        w4 = w4.to(rows.dtype)
    return torch.sum(rows * w4[..., None], 1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _head_out(pts, folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k, cfg: PointRenderConfig):
    """The per-point pipeline of all three kernels: world points (P, 3) ->
    the pre-softplus head output (P, E) fp32."""
    Hg, Wg, _ = folded_grid.shape
    xy, zc, cam = cameras.project(pts, feat_w2c, feat_k)
    depth_like = zc if cfg.code_mode == "z" else torch.linalg.vector_norm(cam, dim=-1, keepdim=True)
    zn = encoding.normalize_z(depth_like, cfg.z_near, cfg.z_far, inv_z=cfg.inv_z)
    code = encoding.positional_encoding(torch.cat([xy, zn], -1), cfg.num_freqs, cfg.freq_factor, cfg.include_input)
    g = _sample_grid(folded_grid, _to_pixel(xy[:, 0], Wg), _to_pixel(xy[:, 1], Hg))
    h = torch.relu(g + code.to(w_code.dtype).float() @ w_code.float() + b1.float())
    if w2.dtype == torch.bfloat16:
        h = h.to(torch.bfloat16)
    return h.float() @ w2.float() + b2.float()


def _ray_points(rays: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return (rays[:, None, :3] + z[..., None] * rays[:, None, 3:6]).reshape(-1, 3)


def point_render_plain(rays, z, folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k,
                       color_img, color_w2c, color_k, cfg: PointRenderConfig,
                       chunk_rays: int = 4096):
    """The K2 kernel's function in plain torch; see `point_render`."""
    R, K = z.shape
    Hc, Wc, _ = color_img.shape
    color_img = color_img.float()
    depth, dino, rgb = [], [], []
    for r0 in range(0, R, chunk_rays):
        rs, zs = rays[r0:r0 + chunk_rays], z[r0:r0 + chunk_rays]
        n = rs.shape[0]
        pts = _ray_points(rs, zs)
        out = _head_out(pts, folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k, cfg)
        sigma = _softplus(out[:, 0]).reshape(n, K)
        comp = compositing.composite_rays(sigma, zs, cfg.hard_alpha_cap, cfg.depth_statistic)
        depth.append(comp.depth)
        dino.append(compositing.weighted_reduce(comp.weights, out[:, 1:].reshape(n, K, -1)))
        cxy = cameras.project(pts, color_w2c, color_k)[0]
        cols = _sample_quads(color_img, _to_pixel(cxy[:, 0], Wc), _to_pixel(cxy[:, 1], Hc))
        rgb.append(compositing.weighted_reduce(comp.weights, cols.reshape(n, K, 3)))
    return torch.cat(depth), torch.cat(dino), torch.cat(rgb)


def probe_weights_plain(rays, z, folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k,
                        cfg: PointRenderConfig, chunk_rays: int = 4096):
    """The K3 kernel's function in plain torch: `point_render_plain`'s
    steps up to the compositing weights; see `probe_weights`."""
    R, K = z.shape
    weights = []
    for r0 in range(0, R, chunk_rays):
        rs, zs = rays[r0:r0 + chunk_rays], z[r0:r0 + chunk_rays]
        out = _head_out(_ray_points(rs, zs), folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k, cfg)
        sigma = _softplus(out[:, 0]).reshape(rs.shape[0], K)
        weights.append(compositing.composite_rays(sigma, zs, cfg.hard_alpha_cap).weights)
    return torch.cat(weights)


def point_query_plain(pts, folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k,
                      cfg: PointRenderConfig, chunk_points: int = 1 << 16):
    """The K4 kernel's function in plain torch; see `point_query`."""
    sigma, feat = [], []
    for p0 in range(0, pts.shape[0], chunk_points):
        out = _head_out(pts[p0:p0 + chunk_points], folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k, cfg)
        sigma.append(_softplus(out[:, 0]))
        feat.append(out[:, 1:])
    return torch.cat(sigma), torch.cat(feat)


def _check_shapes(name: str, shapes: dict, tensors) -> None:
    for arg, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {shape}, got {tuple(t.shape)}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}'s tensors must share one device")


def _check_field(name, folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k, cfg, min_e):
    """The checks every wrapper shares: the field's shapes and constants."""
    if folded_grid.ndim != 3:
        raise ValueError(f"{name}: folded_grid must be (Hg, Wg, D), got {tuple(folded_grid.shape)}")
    D = folded_grid.shape[-1]
    E = w2.shape[-1]
    _check_shapes(name, {
        "w_code": (w_code, (cfg.code_dims, D)), "b1": (b1, (D,)), "w2": (w2, (D, E)), "b2": (b2, (E,)),
        "feat_w2c": (feat_w2c, (4, 4)), "feat_k": (feat_k, (3, 3)),
    }, (folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k))
    if E < min_e:
        raise ValueError(f"{name}: w2 needs at least {min_e} output column(s), got {E}")
    if cfg.code_mode not in ("z", "distance"):
        raise ValueError(f"code_mode must be 'z' or 'distance', got {cfg.code_mode!r}")
    if cfg.depth_statistic not in DEPTH_STATISTICS:
        raise ValueError(f"depth_statistic must be 'expectation' or 'median', got {cfg.depth_statistic!r}")


def _cuda_ready(name: str, bf16: dict, f32: dict) -> None:
    """Raise on what the CUDA kernels do not take."""
    for arg, t in bf16.items():
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the CUDA {name} kernel takes a bf16 {arg}, got {t.dtype}")
    for arg, t in f32.items():
        if t.dtype != torch.float32:
            raise ValueError(f"the CUDA {name} kernel takes an fp32 {arg}, got {t.dtype}")
    for arg, t in {**bf16, **f32}.items():
        if not t.is_contiguous():
            raise ValueError(f"the CUDA {name} kernel takes a contiguous {arg}")
    if bf16["folded_grid"].data_ptr() % 16:
        raise ValueError(f"the CUDA {name} kernel takes a 16-byte aligned folded_grid")


def _field_consts(cfg: PointRenderConfig):
    """(num_freqs, include_input, inv_z, code_distance) as ints and
    (zn_sub, zn_scale, freq_factor): normalized depth = fma(x - zn_sub,
    zn_scale, -1) with x = 1/depth under inv_z (`encoding.zn_constants`)."""
    ints = (cfg.num_freqs, int(cfg.include_input), int(cfg.inv_z), int(cfg.code_mode == "distance"))
    return ints, (*encoding.zn_constants(cfg.z_near, cfg.z_far, cfg.inv_z), cfg.freq_factor)


def _wide_buffers(entry: str, device, R: int, K: int, D: int, E: int, C: int, out_bytes: int):
    """The wide walk's packed weights and scratch for this launch (None, None
    where the shipped instantiations take the shape)."""
    if D <= SHIPPED_HIDDEN and D % 8 == 0 and E <= SHIPPED_OUT and C <= SHIPPED_CODE and K <= SHIPPED_SAMPLES:
        return None, None
    fn = build.function("point_render", "point_wide_bytes", [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    packed, scratch = ctypes.c_longlong(0), ctypes.c_longlong(0)
    with torch.cuda.device(device):
        err = fn(MODES[entry], R, K, D, E, C, ctypes.byref(packed), ctypes.byref(scratch))
    if err != 0:
        raise RuntimeError(f"{entry}: sizing the wide walk failed: cudaError {err}")
    return build.wide_buffers(entry, device, packed.value, scratch.value, out_bytes)


def _launch(entry: str, device, pointers, ints, floats) -> None:
    """Call `entry` of the point_render library on the current stream of
    `device` (a pointer None is passed as null); raises if the launch was
    refused."""
    fn = build.function("point_render", entry, [ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * len(ints)
                        + [ctypes.c_float] * len(floats) + [ctypes.c_void_p])
    err = build.call_on_stream(fn, device, *(None if t is None else t.data_ptr() for t in pointers), *ints, *floats)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")


def _on_cpu_or_cuda(name: str, t: torch.Tensor) -> bool:
    """True for CPU tensors (take the plain version); raise on anything but CUDA."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {t.device}")
    return False


def point_render(rays, z, folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k,
                 color_img, color_w2c, color_k, cfg: PointRenderConfig):
    """Render rays through the folded field (K2).

    rays (R, 8) fp32; z (R, K) sorted sample depths; folded_grid (Hg, Wg, D);
    w_code (code_dims, D); b1 (D,); w2 (D, E); b2 (E,); feat_w2c / color_w2c
    (4, 4) and feat_k / color_k (3, 3) normalized intrinsics of the encode
    and colour cameras; color_img (Hc, Wc, 3) in [0, 1].
    Returns depth (R,) (E[z], or the weight median under
    cfg.depth_statistic="median"), feature (R, E - 1) and rgb (R, 3), fp32.

    On CUDA the kernel takes contiguous tensors, a bf16 grid (16-byte
    aligned), weights and colour image, fp32 rays, depths, biases and
    cameras, and raises on anything else. Any D, E, code width and K: the
    shipped instantiations hold D <= 128 (a multiple of 8), E <= 128,
    code_dims <= 64 and K <= 256 (a ray of more than 64 samples spans
    several of the kernel's 64-point tiles); past them the wide walk streams
    the weights (csrc/wide_walk.cuh), and the wrapper raises only where its
    outputs and buffers would not fit in the card's memory.
    """
    _check_field("point_render", folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k, cfg, min_e=2)
    R, K = z.shape
    _check_shapes("point_render", {"rays": (rays, (R, 8)), "color_w2c": (color_w2c, (4, 4)),
                                   "color_k": (color_k, (3, 3))}, (rays, z, folded_grid, color_img, color_w2c, color_k))
    if color_img.ndim != 3 or color_img.shape[-1] != 3:
        raise ValueError("point_render: color_img must be (Hc, Wc, 3)")
    args = (rays, z, folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k, color_img, color_w2c, color_k)
    if _on_cpu_or_cuda("point_render", rays):
        return point_render_plain(*args, cfg)
    Hg, Wg, D = folded_grid.shape
    Hc, Wc, _ = color_img.shape
    E = w2.shape[-1]
    _cuda_ready("point_render", {"folded_grid": folded_grid, "w_code": w_code, "w2": w2, "color_img": color_img},
                {"rays": rays, "z": z, "b1": b1, "b2": b2, "feat_w2c": feat_w2c, "feat_k": feat_k,
                 "color_w2c": color_w2c, "color_k": color_k})
    wide = _wide_buffers("point_render", rays.device, R, K, D, E, cfg.code_dims, R * (E + 3) * 4)
    depth = torch.empty(R, device=rays.device, dtype=torch.float32)
    dino = torch.empty(R, E - 1, device=rays.device, dtype=torch.float32)
    rgb = torch.empty(R, 3, device=rays.device, dtype=torch.float32)
    ints, floats = _field_consts(cfg)
    _launch("point_render", rays.device, (*args, depth, dino, rgb, *wide),
            (R, K, Hg, Wg, D, E, cfg.code_dims, Hc, Wc, *ints, int(cfg.hard_alpha_cap),
             int(cfg.depth_statistic == "median")), floats)
    build.count_launch(point_render)
    return depth, dino, rgb


def probe_weights(rays, z, folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k, cfg: PointRenderConfig):
    """Compositing weights of rays through the folded field's density (K3).

    rays (R, 8) fp32; z (R, K) sorted sample depths; w2 (D, 1) and b2 (1,)
    the head's density column alone (the rest as in `point_render`).
    Returns the weights (R, K) fp32: alpha compositing of
    softplus(out[0]) with the max(1 - a, 1e-10) floor and, under
    cfg.hard_alpha_cap, alpha 1 on the last sample.

    On CUDA the kernel takes what `point_render`'s does, at any D, code
    width and K, and raises on anything else.
    """
    _check_field("probe_weights", folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k, cfg, min_e=1)
    R, K = z.shape
    _check_shapes("probe_weights", {"rays": (rays, (R, 8)), "w2": (w2, (folded_grid.shape[-1], 1))},
                  (rays, z, folded_grid))
    args = (rays, z, folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k)
    if _on_cpu_or_cuda("probe_weights", rays):
        return probe_weights_plain(*args, cfg)
    Hg, Wg, D = folded_grid.shape
    _cuda_ready("probe_weights", {"folded_grid": folded_grid, "w_code": w_code, "w2": w2},
                {"rays": rays, "z": z, "b1": b1, "b2": b2, "feat_w2c": feat_w2c, "feat_k": feat_k})
    wide = _wide_buffers("probe_weights", rays.device, R, K, D, 1, cfg.code_dims, R * K * 4)
    weights = torch.empty(R, K, device=rays.device, dtype=torch.float32)
    ints, floats = _field_consts(cfg)
    _launch("probe_weights", rays.device, (*args, weights, *wide),
            (R, K, Hg, Wg, D, cfg.code_dims, *ints, int(cfg.hard_alpha_cap)), floats)
    build.count_launch(probe_weights)
    return weights


def point_query(pts, folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k, cfg: PointRenderConfig):
    """Density and feature of world points in the folded field (K4).

    pts (P, 3) fp32 world points (the rest as in `point_render`). Returns
    sigma = softplus(out[0]) (P,) and the feature out[1:] (P, E - 1), fp32.

    On CUDA the kernel takes what `point_render`'s does, at any D, E and
    code width, and raises on anything else.
    """
    _check_field("point_query", folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k, cfg, min_e=2)
    if pts.ndim != 2 or pts.shape[-1] != 3:
        raise ValueError(f"point_query: pts must be (P, 3), got {tuple(pts.shape)}")
    _check_shapes("point_query", {}, (pts, folded_grid))
    args = (pts, folded_grid, w_code, b1, w2, b2, feat_w2c, feat_k)
    if _on_cpu_or_cuda("point_query", pts):
        return point_query_plain(*args, cfg)
    P = pts.shape[0]
    Hg, Wg, D = folded_grid.shape
    E = w2.shape[-1]
    _cuda_ready("point_query", {"folded_grid": folded_grid, "w_code": w_code, "w2": w2},
                {"pts": pts, "b1": b1, "b2": b2, "feat_w2c": feat_w2c, "feat_k": feat_k})
    wide = _wide_buffers("point_query", pts.device, P, 1, D, E, cfg.code_dims, P * E * 4)
    sigma = torch.empty(P, device=pts.device, dtype=torch.float32)
    feat = torch.empty(P, E - 1, device=pts.device, dtype=torch.float32)
    ints, floats = _field_consts(cfg)
    _launch("point_query", pts.device, (*args, sigma, feat, *wide), (P, Hg, Wg, D, E, cfg.code_dims, *ints), floats)
    build.count_launch(point_query)
    return sigma, feat


point_render.launches = 0
probe_weights.launches = 0
point_query.launches = 0
