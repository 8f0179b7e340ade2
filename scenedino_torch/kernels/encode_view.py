"""K6: the encode-view render's per-sample work in one CUDA kernel.

The counterpart of `scenedino_tpu/ops/fast_field.py:254`
`render_encode_view` (and `render_encode_view_batched`), XLA in the
reference. `ops.fast_field.render_encode_view(_batched)` computes the
per-pixel preamble in torch (the folded grid at the pixel, the x/y code
folded into a bias, b1, the sample depths and each ray's camera-z factor)
and hands every ray of every frame to `encode_view` at once; the kernel,
`csrc/encode_view.cu`, forms the z code, both head products on the tensor
cores (bf16 wgmma for the bf16 state, three TF32 passes for the fp32 one),
softplus, the compositing and the feature sum per sample, and writes only
the per-ray depth, feature and colour.

On CUDA tensors `encode_view` launches the kernel or raises; on CPU
tensors it takes `encode_view_plain`, the same arithmetic in torch over
chunks of rays, so that the (rays, K, d_hidden) intermediates stay
bounded.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from scenedino_torch.core import compositing, encoding
from scenedino_torch.kernels import build

DEPTH_STATISTICS = ("expectation", "median")
DTYPES = (torch.float32, torch.bfloat16)
# what the shipped instantiations of the CUDA kernel hold (csrc/encode_view.cu's
# `shipped`): samples a ray, hidden width, output width, z-code columns; past
# any of them the wide walk runs. Rays the kernel takes (its tiles count rays
# in 32 bits)
SHIPPED_SAMPLES, SHIPPED_HIDDEN, SHIPPED_OUT, SHIPPED_CODE = 256, 128, 68, 32
MAX_RAYS = 2 ** 31 - 1 - 64
ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 10 + [ctypes.c_float] * 3
            + [ctypes.c_void_p])
WIDE_ARGTYPES = [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2


@dataclasses.dataclass(frozen=True)
class EncodeViewConfig:
    """The field and compositing constants of the encode-view render."""

    z_near: float = 3.0
    z_far: float = 80.0
    inv_z: bool = True
    num_freqs: int = 6
    freq_factor: float = 1.5
    include_input: bool = True
    hard_alpha_cap: bool = True
    depth_statistic: str = "expectation"  # "expectation" | "median"

    @property
    def code_dims(self) -> int:
        """The z code's columns: the input and a sine and cosine per frequency."""
        return encoding.positional_encoding_dims(self.num_freqs, 1, self.include_input)


def encode_view_plain(base, z, zscale, w_z, w2, b2, color, cfg: EncodeViewConfig, chunk_rays: int = 4096):
    """The K6 kernel's function in plain torch; see `encode_view`."""
    depth, dino, rgb = [], [], []
    for r0 in range(0, z.shape[0], chunk_rays):
        zs = z[r0:r0 + chunk_rays].float()
        zn = encoding.normalize_z(zs * zscale[r0:r0 + chunk_rays, None].float(), cfg.z_near, cfg.z_far,
                                  inv_z=cfg.inv_z)
        code = encoding.positional_encoding(zn[..., None], cfg.num_freqs, cfg.freq_factor, cfg.include_input)
        h = torch.relu(base[r0:r0 + chunk_rays, None].float() + code.to(w_z.dtype).float() @ w_z.float())
        out = h.to(w2.dtype).float() @ w2.float() + b2.float()  # (n, K, E)
        comp = compositing.composite_rays(F.softplus(out[..., 0]), zs, cfg.hard_alpha_cap, cfg.depth_statistic)
        depth.append(comp.depth)
        dino.append(compositing.weighted_reduce(comp.weights, out[..., 1:]))
        rgb.append(color[r0:r0 + chunk_rays].float() * comp.weights.sum(-1)[:, None])
    return torch.cat(depth), torch.cat(dino), torch.cat(rgb)


def _check(base, z, zscale, w_z, w2, b2, color, cfg: EncodeViewConfig) -> None:
    if base.ndim != 2 or z.ndim != 2:
        raise ValueError(f"encode_view: base must be (N, D) and z (N, K), got {tuple(base.shape)}, {tuple(z.shape)}")
    N, D = base.shape
    K = z.shape[1]
    E = w2.shape[-1]
    shapes = {"z": (z, (N, K)), "zscale": (zscale, (N,)), "w_z": (w_z, (cfg.code_dims, D)), "w2": (w2, (D, E)),
              "b2": (b2, (E,)), "color": (color, (N, 3))}
    for arg, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"encode_view: {arg} must be {shape}, got {tuple(t.shape)}")
    if len({t.device for t in (base, z, zscale, w_z, w2, b2, color)}) != 1:
        raise ValueError("encode_view's tensors must share one device")
    if E < 2:
        raise ValueError(f"encode_view: w2 needs a density and at least one feature column, got {E}")
    if w_z.dtype != w2.dtype or w2.dtype not in DTYPES:
        raise ValueError(f"encode_view: w_z and w2 must share the state's dtype (fp32 or bf16), got "
                         f"{w_z.dtype}, {w2.dtype}")
    if cfg.depth_statistic not in DEPTH_STATISTICS:
        raise ValueError(f"depth_statistic must be 'expectation' or 'median', got {cfg.depth_statistic!r}")


def encode_view(base, z, zscale, w_z, w2, b2, color, cfg: EncodeViewConfig):
    """Render N rays of encode-view pixels from their per-pixel preamble (K6).

    base (N, D) fp32: each ray's pre-activation without the z code (the
    folded grid at the pixel + the x/y code's bias + b1); z (N, K) fp32
    sorted sample distances; zscale (N,) fp32 the code's depth per unit of
    distance (the ray's camera-z component, or 1 for code_mode
    "distance"); w_z (code_dims, D) the z rows of W_code and w2 (D, E), both
    in the state's dtype (fp32, or bf16: the code and h are then rounded to
    bf16 before their products); b2 (E,) fp32; color (N, 3) fp32, the
    pixel's colour. Returns depth (N,) (E[z], or the weight median under
    cfg.depth_statistic="median"), feature (N, E - 1) and rgb = color x
    the ray's total weight (N, 3), fp32.

    On CUDA the kernel takes contiguous tensors and N < 2^31 - 64, and
    raises on anything else, at any D, E, code width and K: the shipped
    instantiations hold K <= 256 samples a ray (padded to 8, 16, 32 or 64 in
    their 64-row tiles; past 64 a ray spans several tiles), D <= 128
    (zero-padded to 64 or 128), E <= 68 and code_dims <= 32; past them the
    wide walk streams the weights (csrc/wide_walk.cuh), and the wrapper
    raises only where its outputs and buffers would not fit in the card's
    memory. The CPU's plain version takes any size.
    """
    _check(base, z, zscale, w_z, w2, b2, color, cfg)
    device = base.device
    if device.type == "cpu":
        return encode_view_plain(base, z, zscale, w_z, w2, b2, color, cfg)
    if device.type != "cuda":
        raise ValueError(f"encode_view runs on cuda or cpu tensors, got {device}")
    N, D = base.shape
    K, E = z.shape[1], w2.shape[1]
    for arg, t in {"base": base, "z": z, "zscale": zscale, "b2": b2, "color": color}.items():
        if t.dtype != torch.float32:
            raise ValueError(f"the CUDA encode_view kernel takes an fp32 {arg}, got {t.dtype}")
    tensors = (base, z, zscale, w_z, w2, b2, color)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA encode_view kernel takes contiguous tensors")
    if N > MAX_RAYS:
        raise ValueError(f"the CUDA encode_view kernel takes N <= {MAX_RAYS}, got N={N}")
    bf16 = int(w2.dtype == torch.bfloat16)
    wide = (None, None)
    if not (K <= SHIPPED_SAMPLES and D <= SHIPPED_HIDDEN and E <= SHIPPED_OUT and cfg.code_dims <= SHIPPED_CODE):
        # the wide walk's packed weights and scratch
        sizes = (ctypes.c_longlong(0), ctypes.c_longlong(0))
        with torch.cuda.device(device):
            err = build.function("encode_view", "encode_view_wide_bytes", WIDE_ARGTYPES)(
                N, K, D, E, cfg.code_dims, bf16, *map(ctypes.byref, sizes))
        if err != 0:
            raise RuntimeError(f"encode_view: sizing the wide walk failed: cudaError {err}")
        wide = build.wide_buffers("encode_view", device, sizes[0].value, sizes[1].value, N * (E + 3) * 4)
    depth = torch.empty(N, device=device, dtype=torch.float32)
    dino = torch.empty(N, E - 1, device=device, dtype=torch.float32)
    rgb = torch.empty(N, 3, device=device, dtype=torch.float32)
    zn_sub, zn_scale = encoding.zn_constants(cfg.z_near, cfg.z_far, cfg.inv_z)
    fn = build.function("encode_view", "encode_view", ARGTYPES)
    err = build.call_on_stream(
        fn, device, *(None if t is None else t.data_ptr() for t in (*tensors, depth, dino, rgb, *wide)),
        N, K, D, E, cfg.code_dims, bf16, cfg.num_freqs, int(cfg.include_input),
        int(cfg.inv_z), int(cfg.hard_alpha_cap), int(cfg.depth_statistic == "median"), zn_sub, zn_scale,
        cfg.freq_factor)
    if err != 0:
        raise RuntimeError(f"encode_view kernel launch failed: cudaError {err}")
    build.count_launch(encode_view)
    return depth, dino, rgb


encode_view.launches = 0
