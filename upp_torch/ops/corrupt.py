"""Corruption ops of the robust pipeline (counterpart of
``upp_tpu/ops/corrupt.py``): viewpoint crop, lidar and shell noise, the
augmentations (scale-translate, rotate, scale, translate, jitter, input
dropout, horizontal flip), unit-sphere normalisation.

Each random op takes a ``torch.Generator`` on its tensors' device, or the
draws themselves, so a test can feed both packages the same numbers (JAX's
threefry and torch's Philox give different numbers from the same seed). A
per-cloud draw is made through ``parallel.shard``: inside a train step of
several ranks, for the global batch, of which this rank keeps its rows; the
draws the batch shares (the lidar indices and factors) are the same on
every rank.
Variable-size crops are static-shape masked ops: the crop/partial split is a
mask from a distance threshold, and masked FPS with an explicit start
resamples each side to a fixed size; the raw crop (no resampling) is a
stable sort by the distance to the viewpoint.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel import shard
from .fps import fps


def gaussian_shell_noise(shape: Tuple[int, ...], loc: float = 0.0,
                         scale: float = 0.2, shell_radius: float = 0.9, *,
                         generator: Optional[torch.Generator] = None,
                         normal: Optional[torch.Tensor] = None,
                         device=None) -> torch.Tensor:
    """Shell noise imitating depth-camera outliers: N(loc, scale) samples
    pushed radially outward by ``shell_radius``. ``normal`` are the standard
    normal draws of ``shape``; without them they come from ``generator``."""
    if normal is None:
        normal = shard.randn(shape, generator=generator, device=device)
    g = loc + scale * normal
    direction = g / torch.linalg.norm(g, dim=-1, keepdim=True)
    return g + direction * shell_radius


def lidar_noise(points: torch.Tensor, number: int = 64, scale: float = 1.3,
                low: float = 1.02, *, generator: Optional[torch.Generator] = None,
                idx: Optional[torch.Tensor] = None,
                factor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lidar-style outliers: ``number`` existing points pushed radially
    outward by U(low, scale). As in the reference, the indices [number] and
    factors [number] are shared across the batch."""
    if idx is None:
        idx = torch.randint(0, points.shape[1], (number,), generator=generator,
                            device=points.device)
    if factor is None:
        factor = low + (scale - low) * torch.rand(
            (number,), generator=generator, device=points.device)
    return points[:, idx, :] * factor[None, :, None]


def _viewpoints(B: int, viewpoint, generator, device) -> torch.Tensor:
    """[B, 3] viewpoints: the given [3] or [B, 3] as they are, else random
    unit vectors (``misc.seprate_point_cloud``'s F.normalize(randn))."""
    if viewpoint is not None:
        return viewpoint.to(device=device, dtype=torch.float32).expand(B, 3)
    v = shard.randn((B, 3), generator=generator, device=device)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _viewpoint_dist(xyz: torch.Tensor, viewpoint, generator) -> torch.Tensor:
    """Squared distance [B, N] of each point to its cloud's viewpoint."""
    v = _viewpoints(xyz.shape[0], viewpoint, generator, xyz.device)
    dx = xyz[..., 0] - v[:, 0:1]
    dy = xyz[..., 1] - v[:, 1:2]
    dz = xyz[..., 2] - v[:, 2:3]
    return dx * dx + dy * dy + dz * dz


def _crop_masks(xyz: torch.Tensor, num_crop: int, viewpoint, generator):
    """Squared viewpoint distance d [B, N] and the crop mask: the nearest
    ``num_crop`` points, ties at the threshold taken in index order exactly
    where a stable sort would place them."""
    d = _viewpoint_dist(xyz, viewpoint, generator)
    thresh = torch.kthvalue(d, num_crop, dim=1, keepdim=True).values
    below = d < thresh
    at = d == thresh
    n_below = below.sum(1, keepdim=True)
    tie_rank = torch.cumsum(at.int(), dim=1)              # 1-based
    crop_valid = below | (at & (tie_rank <= num_crop - n_below))
    return d, crop_valid


def _resample(xyz, d, valid, sample_points):
    """FPS of the ``valid`` points, starting from the one nearest the
    viewpoint (the start of the reference's FPS of the sorted subset)."""
    start = torch.where(valid, d, torch.inf).argmin(1)
    return fps(xyz, sample_points, valid=valid, start_idx=start)[0]


def partial_point_cloud(xyz: torch.Tensor, num_crop: int,
                        sample_points: int = 1024, *, viewpoint=None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """The partial half of ``separate_point_cloud`` alone: the farthest
    N - num_crop points from the viewpoint, FPS-resampled to
    ``sample_points``."""
    d, crop_valid = _crop_masks(xyz, num_crop, viewpoint, generator)
    return _resample(xyz, d, ~crop_valid, sample_points)


def separate_point_cloud(xyz: torch.Tensor, num_crop: int,
                         sample_points: int = 1024, *, viewpoint=None,
                         generator: Optional[torch.Generator] = None,
                         resample: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Viewpoint crop → (partial, crop): per sample a viewpoint ([3] or
    [B, 3], else a random unit vector), the nearest ``num_crop`` points form
    the crop, the rest the partial cloud.

    With ``resample`` (the JAX package's resampled path) each side is
    resampled to ``sample_points`` by masked FPS starting from its point
    nearest the viewpoint; requires num_crop >= sample_points and
    N - num_crop >= sample_points. Without it (``_separate_raw``, the
    segmentation runner's crop) the points are sorted by their distance to
    the viewpoint, ties in index order as JAX's stable ``argsort``, and
    split there: ([B, N - num_crop, 3], [B, num_crop, 3]), no FPS."""
    if not resample:
        order = torch.argsort(_viewpoint_dist(xyz, viewpoint, generator), dim=1, stable=True)
        ordered = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
        return ordered[:, num_crop:], ordered[:, :num_crop]
    d, crop_valid = _crop_masks(xyz, num_crop, viewpoint, generator)
    return (_resample(xyz, d, ~crop_valid, sample_points),
            _resample(xyz, d, crop_valid, sample_points))


def scale_translate(pc: torch.Tensor, scale_low: float = 2.0 / 3.0,
                    scale_high: float = 3.0 / 2.0, translate_range: float = 0.2,
                    *, generator: Optional[torch.Generator] = None,
                    scale: Optional[torch.Tensor] = None,
                    shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample anisotropic scale [B, 1, 3] and translate [B, 1, 3]."""
    B = pc.shape[0]
    if scale is None:
        scale = scale_low + (scale_high - scale_low) * shard.rand(
            (B, 1, 3), generator=generator, device=pc.device)
    if shift is None:
        shift = translate_range * (2.0 * shard.rand(
            (B, 1, 3), generator=generator, device=pc.device) - 1.0)
    return pc * scale + shift


def rotate_y(pc: torch.Tensor, *, generator: Optional[torch.Generator] = None,
             theta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample rotation about the y axis by ``theta`` [B] ~ U(-pi, pi),
    ``pc @ R.T`` with R = [[c, 0, s], [0, 1, 0], [-s, 0, c]]. Written as
    elementwise products and sums, so no TF32 matrix product can reach it
    (the JAX package computes it in full float32)."""
    if theta is None:
        theta = torch.pi * (2.0 * shard.rand((pc.shape[0],), generator=generator,
                                             device=pc.device) - 1.0)
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    return torch.stack([x * c + z * s, y, z * c - x * s], dim=-1)


def jitter(pc: torch.Tensor, std: float = 0.01, clip: float = 0.03, *,
           generator: Optional[torch.Generator] = None,
           normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Clipped Gaussian jitter; ``normal`` are the standard normal draws
    [B, N, 3]."""
    if normal is None:
        normal = shard.randn(pc.shape, generator=generator, device=pc.device)
    return pc + (std * normal).clamp(-clip, clip)


def pointcloud_scale(pc: torch.Tensor, scale_low: float = 2.0 / 3.0,
                     scale_high: float = 3.0 / 2.0, *,
                     generator: Optional[torch.Generator] = None,
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample anisotropic scale [B, 1, 3] only."""
    if scale is None:
        scale = scale_low + (scale_high - scale_low) * shard.rand(
            (pc.shape[0], 1, 3), generator=generator, device=pc.device)
    return pc * scale


def pointcloud_translate(pc: torch.Tensor, translate_range: float = 0.2, *,
                         generator: Optional[torch.Generator] = None,
                         shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample translate [B, 1, 3] only."""
    if shift is None:
        shift = translate_range * (2.0 * shard.rand(
            (pc.shape[0], 1, 3), generator=generator, device=pc.device) - 1.0)
    return pc + shift


def random_input_dropout(pc: torch.Tensor, max_dropout_ratio: float = 0.5, *,
                         generator: Optional[torch.Generator] = None,
                         ratio: Optional[torch.Tensor] = None,
                         u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per sample a ratio [B, 1] ~ U(0, max); a point whose draw ``u``
    [B, N] ~ U(0, 1) is <= the ratio becomes the cloud's first point (the
    reference's replacement rule, shapes kept)."""
    B, N, _ = pc.shape
    if ratio is None:
        ratio = max_dropout_ratio * shard.rand((B, 1), generator=generator, device=pc.device)
    if u is None:
        u = shard.rand((B, N), generator=generator, device=pc.device)
    return torch.where((u <= ratio)[..., None], pc[:, :1], pc)


def random_horizontal_flip(pc: torch.Tensor, upright_axis: str = "z",
                           p_apply: float = 0.95, p_axis: float = 0.5, *,
                           generator: Optional[torch.Generator] = None,
                           apply: Optional[torch.Tensor] = None,
                           axis: Optional[torch.Tensor] = None) -> torch.Tensor:
    """With probability ``p_apply`` per sample (draws ``apply`` [B, 1] ~
    U(0, 1)), each axis but the upright one flips with probability
    ``p_axis`` (draws ``axis`` [B, 3]) as ``coord_max - coord``, the
    reference's reflection (not a sign flip)."""
    up = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
    B = pc.shape[0]
    if apply is None:
        apply = shard.rand((B, 1), generator=generator, device=pc.device)
    if axis is None:
        axis = shard.rand((B, 3), generator=generator, device=pc.device)
    do = (apply < p_apply) & (axis < p_axis)
    do[:, up] = False
    cmax = pc.amax(1, keepdim=True)
    return torch.where(do[:, None, :], cmax - pc, pc)


def normalize_unit_sphere(pc: torch.Tensor, recenter: bool = False) -> torch.Tensor:
    """Scale each cloud into the unit sphere (optionally recentered first)."""
    if recenter:
        p_max = pc.amax(1, keepdim=True)
        p_min = pc.amin(1, keepdim=True)
        pc = pc - (p_max + p_min) / 2.0
    scale = torch.linalg.norm(pc, dim=-1, keepdim=True).amax(1, keepdim=True)
    return pc / scale
