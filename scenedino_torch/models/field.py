"""SceneField: encoder + positional code + field head (counterpart of
`scenedino_tpu/models/field.py`).

`encode` runs the image encoder once and returns a `SceneState` of
per-view feature grids, colour images and cameras (and, for training, the
frozen teacher's loss features). The serving path (ops/fast_field.py)
folds the head into that state; training queries the field directly:
`forward(state, xyz)` projects world points into the encode views,
samples pixel-aligned features, appends the positional code, runs the
head, and samples the render views' colours.

`encode` builds an autograd graph like any module call; serving callers
wrap their request in `torch.inference_mode()`.

An optional `uncertainty_predictor` (a `monodepth2.Monodepth2` in the
reference's research configs; no factory builds one) gives a per-pixel
uncertainty map (`predict_uncertainty`) that the training step renders as
an extra colour channel (`encode(extra_color_channels=...)`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scenedino_torch.core import cameras, encoding, grid_sample
from scenedino_torch.core.resize import jax_resize
from scenedino_torch.models.heads import make_head


@dataclasses.dataclass
class SceneState:
    """feat_grid (B, Ve, C, Hf, Wf); color_imgs (B, Vr, 3 + extra, H, W), the
    colours in [0, 1] and any extra channels;
    ks normalized intrinsics (B, V, 3, 3); poses world->camera (B, V, 4, 4);
    loss_feats the teacher's maps (B, Vl, Cd, Gh, Gw), or None."""

    feat_grid: torch.Tensor
    feat_ks: torch.Tensor
    feat_w2c: torch.Tensor
    color_imgs: torch.Tensor
    color_ks: torch.Tensor
    color_w2c: torch.Tensor
    loss_feats: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Static field hyper-parameters (configs/model/dino_downsampler.yaml)."""

    z_near: float = 3.0
    z_far: float = 80.0
    inv_z: bool = True
    code_mode: str = "z"  # "z" | "distance"
    learn_empty: bool = False
    sample_color: bool = True
    predict_dino: bool = True
    dino_dims: int = 64
    num_freqs: int = 6
    freq_factor: float = 1.5
    include_input: bool = True

    @property
    def code_dims(self) -> int:
        return encoding.positional_encoding_dims(self.num_freqs, 3, self.include_input)

    @property
    def d_out(self) -> int:
        if self.sample_color and self.predict_dino:
            return 1 + self.dino_dims
        if self.sample_color:
            return 1
        return 4


_DEFAULT_HEADS = (("normal_head", {"type": "resnet", "args": {"n_blocks": 0, "d_hidden": 128}}),)


def shift_pad_crop(imgs: torch.Tensor, shift: Tuple[int, int], pad: int = 8) -> torch.Tensor:
    """Edge-pad by `pad`, then crop at offset (pad + shift): the DINO
    patch-grid shift augmentation (field.py:380-389). imgs (B, V, C, H, W)."""
    B, V, C, H, W = imgs.shape
    x = F.pad(imgs.reshape(B * V, C, H, W), (pad, pad, pad, pad), mode="replicate")
    i, j = pad + int(shift[0]), pad + int(shift[1])
    return x[:, :, i:i + H, j:j + W].reshape(B, V, C, H, W)


class SceneField(nn.Module):
    """Encoder + field heads (`heads.<name>` like the reference's `heads_<name>`)."""

    def __init__(self, encoder: nn.Module, cfg: FieldConfig,
                 head_confs: Tuple[Tuple[str, Any], ...] = _DEFAULT_HEADS,
                 final_pred_head: str = "normal_head", uncertainty_predictor: Optional[nn.Module] = None):
        super().__init__()
        self.encoder = encoder
        self.uncertainty_predictor = uncertainty_predictor
        self.cfg = cfg
        self.final_pred_head = final_pred_head
        self.head_confs = head_confs
        d_in = encoder.latent_size + cfg.code_dims
        self.heads = nn.ModuleDict(
            {name: make_head(dict(conf), d_in, cfg.d_out) for name, conf in head_confs}
        )
        if cfg.learn_empty:  # the feature of a point outside a view (field.py:99-101)
            self.empty_feature = nn.Parameter(torch.randn(encoder.latent_size))

    def encode(self, images: torch.Tensor, ks: torch.Tensor, poses_c2w: torch.Tensor,
               ids_encoder: Optional[Sequence[int]] = None,
               ids_render: Optional[Sequence[int]] = None,
               ids_loss: Optional[Sequence[int]] = None,
               with_loss_feats: bool = False,
               loss_feature_grid_shift: Optional[Tuple[int, int]] = None,
               flip: bool = False,
               fold_matrix: Optional[torch.Tensor] = None,
               crops=None, extra_color_channels: Optional[torch.Tensor] = None) -> SceneState:
        """images (B, V, 3, H, W) in [-1, 1]; ks (B, V, 3, 3); poses_c2w (B, V, 4, 4).

        The student sees the `ids_encoder` views (all by default); the colour
        views are `ids_render` and the teacher's are `ids_loss` (all by
        default). `flip` (the augmentation coin, an explicit input) mirrors
        the student's input images and un-mirrors its feature grid; the
        teacher's images are shifted by `loss_feature_grid_shift` and never
        flipped. Poses are inverted to world->camera in fp32.
        `fold_matrix` (C, d) is folded into the decoder's last conv (serving,
        `ops.fast_field.encode_prefolded`): the grid comes out already
        projected, (B, Ve, d, Hf, Wf). `extra_color_channels` (B, V, Ce, H, W)
        of the `ids_render` views ride along the colours (field.py:183-188).
        """
        B, V = images.shape[:2]
        all_ids = list(range(V))
        ids_encoder = list(ids_encoder) if ids_encoder is not None else all_ids
        ids_render = list(ids_render) if ids_render is not None else all_ids
        ids_loss = list(ids_loss) if ids_loss is not None else all_ids
        poses_w2c = torch.linalg.inv_ex(poses_c2w.float()).inverse  # a singular pose gives non-finite values, as in JAX
        imgs_enc = images[:, ids_encoder]
        ne = imgs_enc.shape[1]
        if flip:
            imgs_enc = imgs_enc.flip(-1)
        feats = self.encoder(imgs_enc.reshape(B * ne, *imgs_enc.shape[2:]), fold_matrix=fold_matrix)[0]
        if flip:
            feats = feats.flip(-1)

        loss_feats = (self.loss_features(images, ids_loss, loss_feature_grid_shift, crops) if with_loss_feats
                      else None)
        color_imgs = images[:, ids_render] * 0.5 + 0.5
        if extra_color_channels is not None:
            color_imgs = torch.cat([color_imgs, extra_color_channels[:, ids_render].to(color_imgs.dtype)], 2)
        return SceneState(
            feat_grid=feats.reshape(B, ne, *feats.shape[1:]),
            feat_ks=ks[:, ids_encoder],
            feat_w2c=poses_w2c[:, ids_encoder],
            color_imgs=color_imgs,
            color_ks=ks[:, ids_render],
            color_w2c=poses_w2c[:, ids_render],
            loss_feats=loss_feats,
        )

    def loss_features(self, images: torch.Tensor, ids_loss: Sequence[int],
                      shift: Optional[Tuple[int, int]] = None, crops=None) -> torch.Tensor:
        """The frozen teacher's feature maps of the `ids_loss` views, the
        images shifted by `shift` first: (B, Vl, Cd, Gh, Gw), no graph
        (`crops`: the multiscale-crop teacher's draws of the B x Vl images)."""
        imgs = images[:, list(ids_loss)]
        if shift is not None:
            imgs = shift_pad_crop(imgs, shift)
        B, nl = imgs.shape[:2]
        lf = self.encoder(imgs.reshape(B * nl, *imgs.shape[2:]), ground_truth=True, crops=crops)[0]
        return lf.reshape(B, nl, *lf.shape[1:])

    def sample_features(self, state: SceneState, xyz: torch.Tensor):
        """xyz (B, P, 3) -> (features (B, P, V, C + code) fp32, invalid (B, P, V) bool)."""
        cfg = self.cfg
        xy, z, dist, invalid = cameras.project_points(xyz, state.feat_w2c, state.feat_ks)
        coords = encoding.encode_coords(xy, z, dist, cfg.z_near, cfg.z_far, mode=cfg.code_mode, inv_z=cfg.inv_z)
        code = encoding.positional_encoding(coords, cfg.num_freqs, cfg.freq_factor, cfg.include_input)
        sampled = grid_sample.grid_sample_views(state.feat_grid, xy)  # (B, V, P, C)
        if cfg.learn_empty:
            sampled = torch.where(invalid, self.empty_feature.to(sampled.dtype), sampled)
        feats = torch.cat([sampled, code.to(sampled.dtype)], -1)
        return feats.transpose(1, 2), invalid[..., 0].transpose(1, 2)

    def sample_colors(self, state: SceneState, xyz: torch.Tensor):
        """Colours (and extra channels) of world points in the render views:
        (colors (B, Vr, P, 3 + extra), invalid (B, Vr, P, 1))."""
        xy, _, _, invalid = cameras.project_points(xyz, state.color_w2c, state.color_ks)
        return grid_sample.grid_sample_views(state.color_imgs, xy), invalid

    def forward(self, state: SceneState, xyz: torch.Tensor, only_density: bool = False):
        """Field query: xyz (B, P, 3) -> (rgb (B, P, Vr*3) or None,
        invalid (B, P, Vr) fp32, sigma (B, P) fp32, dino (B, P, dino_dims)
        or None without `predict_dino`). A field that does not sample colours
        predicts them (bts.py:545-552): relu sigma and sigmoid rgb (B, P, 3)
        from the head, invalid (B, P, V) the encode views', and no dino."""
        feats, invalid_features = self.sample_features(state, xyz)
        mlp_out = self.heads[self.final_pred_head](feats, invalid_features=invalid_features)
        B, P = xyz.shape[:2]
        mlp_out = mlp_out.reshape(B, P, -1, mlp_out.shape[-1]).mean(2)
        if not self.cfg.sample_color:
            rgb = torch.sigmoid(mlp_out[..., 1:4])
            return rgb, invalid_features.to(rgb.dtype), torch.relu(mlp_out[..., 0].float()), None
        sigma = F.softplus(mlp_out[..., 0].float())
        dino = mlp_out[..., 1:] if self.cfg.predict_dino else None
        if only_density:
            return None, invalid_features.float(), sigma, dino
        colors, invalid_colors = self.sample_colors(state, xyz)
        Vr = colors.shape[1]
        rgb = colors.transpose(1, 2).reshape(B, P, Vr * colors.shape[-1])
        inv_c = invalid_colors[..., 0].transpose(1, 2)  # (B, P, Vr)
        invalid = (inv_c | invalid_features.all(-1, keepdim=True)).to(rgb.dtype)
        return rgb, invalid, sigma, dino

    def predict_uncertainty(self, images: torch.Tensor, res: int = 0) -> torch.Tensor:
        """images (B, V, 3, H, W) in [-1, 1] -> (B, V, 1, H, W): the predictor's
        map at scale `res`, resized to the image bilinearly as
        `jax.image.resize` resizes (half-pixel centres) where it is coarser,
        then softplus'd (field.py:337-349)."""
        B, V, C, H, W = images.shape
        u = self.uncertainty_predictor(images.reshape(B * V, C, H, W))[res]
        if tuple(u.shape[-2:]) != (H, W):
            u = jax_resize(u, (H, W), "bilinear")
        return F.softplus(u).reshape(B, V, 1, H, W)

    def expand_dim(self, features: torch.Tensor) -> torch.Tensor:
        """64-d field feature -> 768-d DINO space."""
        return self.encoder.expand_dim(features)

    def segment_features(self, dino: torch.Tensor, head: Optional[nn.Module], mode: str = "stego_kmeans"):
        """The semantic tail of `query_segmentation` for precomputed field
        features: (768-d features, the head's labels in `mode`, or None
        without a head). The head is an argument (the reference's field
        carries it as `downstream`), so the field's parameters stay those
        of stage 1."""
        dino_full = self.expand_dim(dino)
        return dino_full, (head(dino_full, mode=mode) if head is not None else None)

    def query_segmentation(self, state: SceneState, xyz: torch.Tensor, head: Optional[nn.Module],
                           mode: str = "stego_kmeans"):
        """The SSC query (bts.py:553-593): xyz (B, P, 3) -> (768-d features,
        sigma (B, P), labels (B, P) or None without a head)."""
        _, _, sigma, dino = self(state, xyz, only_density=True)
        dino_full, seg = self.segment_features(dino, head, mode)
        return dino_full, sigma, seg

    def downsample(self, features: torch.Tensor, mode: str = "patch") -> torch.Tensor:
        """Pool rendered pixel features back to the teacher's patch grid."""
        return self.encoder.downsample(features, mode)


class EncoderDummy(nn.Module):
    """A learned constant feature map, the overfit runs' encoder
    (field.py:392; trainer_overfit.py:21-29): forward(x) gives the map
    (B, feat_dim, H, W) itself, not a list, as the reference's does."""

    def __init__(self, size: Tuple[int, int], feat_dim: int, latent_size: int = 0):
        super().__init__()
        self.size, self.feat_dim, self.latent_size = tuple(size), feat_dim, latent_size
        self.feat = nn.Parameter(torch.randn(1, feat_dim, *self.size))

    def forward(self, x: torch.Tensor, ground_truth: bool = False) -> torch.Tensor:
        return self.feat.expand(x.shape[0], self.feat_dim, *self.size)

    def expand_dim(self, x: torch.Tensor) -> torch.Tensor:
        return x
