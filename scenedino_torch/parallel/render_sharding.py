"""One image's render with its ray axis split over devices (counterpart of
`scenedino_tpu/parallel/render_sharding.py`; the reference's
intra-renderer `nn.DataParallel(..., dim=1)`, nerf.py:641-658).

Volume rendering is independent per ray: each device renders a
contiguous share of every item's rays through its replica of the field
and the scene state, and the outputs are concatenated along the ray axis
on the first device, with no collective. The draws are made for the whole
ray batch by the caller and sliced here, so the result is
`renderer.nerf.render_rays` on the same draws.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from scenedino_torch.parallel import mesh
from scenedino_torch.renderer.nerf import FieldFn, FineDraws, RenderConfig, render_rays


def make_sharded_renderer(make_field_fn: Callable[[torch.device], FieldFn], rcfg: RenderConfig,
                          devices: Sequence[torch.device], **render_kwargs) -> Callable:
    """`(rays (B, R, >=8), u (B*R, n_coarse), fine=None, noise=None) -> out`,
    `render_rays`' output with every per-ray tensor on the first device.

    `make_field_fn(device)` gives the field function on `device` (a closure
    over that device's replica of the field and its scene state, e.g. via
    `mesh.replicate`); it is called once per distinct device, when the
    renderer is built. Build once per scene and reuse it for its frames."""
    devices = [torch.device(d) for d in devices]
    field_fns = {d: make_field_fn(d) for d in mesh.distinct(devices)}

    def run(rays: torch.Tensor, u: torch.Tensor, fine: Optional[FineDraws] = None,
            noise: Optional[torch.Tensor] = None) -> Dict:
        B, R = rays.shape[:2]
        n = len(devices)

        def shares(x: Optional[torch.Tensor]):
            """Each share's rows of a per-ray tensor (B*R, ...) or (B, R, ...)."""
            return [None] * n if x is None else x.reshape(B, R, -1).tensor_split(n, dim=1)

        def flat(x: Optional[torch.Tensor], d: torch.device) -> Optional[torch.Tensor]:
            return None if x is None else x.reshape(-1, x.shape[-1]).to(d)

        ray_s, u_s, noise_s = rays.tensor_split(n, dim=1), shares(u), shares(noise)
        fine_s = None if fine is None else fine.map(shares)

        def share(i: int, d: torch.device) -> Dict:
            out = render_rays(field_fns[d], ray_s[i].to(d), flat(u_s[i], d), rcfg,
                              fine=None if fine is None else fine_s.map(lambda x: flat(x[i], d)),
                              noise=flat(noise_s[i], d), **render_kwargs)
            return {level: {k: None if v is None else v.to(devices[0]) for k, v in outs.items()}
                    for level, outs in out.items()}

        parts = mesh.run_shares(share, devices)
        return {level: {k: None if parts[0][level][k] is None else torch.cat([p[level][k] for p in parts], 1)
                        for k in parts[0][level]}
                for level in parts[0]}

    return run


def render_rays_sharded(make_field_fn: Callable[[torch.device], FieldFn], rays: torch.Tensor, u: torch.Tensor,
                        rcfg: RenderConfig, devices: Sequence[torch.device], fine: Optional[FineDraws] = None,
                        noise: Optional[torch.Tensor] = None, **render_kwargs) -> Dict:
    """One call of `make_sharded_renderer` (it builds the replicas again:
    for a loop over frames build the renderer once)."""
    return make_sharded_renderer(make_field_fn, rcfg, devices, **render_kwargs)(rays, u, fine=fine, noise=noise)
