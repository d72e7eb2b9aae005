"""Per-batch corruption pipeline (counterpart of ``upp_tpu/train/pipeline.py``):
FPS-or-crop subsampling, then lidar and shell noise, then augmentation.

Noise constants follow the reference's ``tools/runner_finetune.py:20-21``:
Gaussian_noise_number = 24, lidar_noise_number = 48.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..ops.corrupt import (gaussian_shell_noise, jitter, lidar_noise,
                           normalize_unit_sphere, partial_point_cloud,
                           pointcloud_scale, pointcloud_translate,
                           random_horizontal_flip, random_input_dropout, rotate_y,
                           scale_translate)
from ..ops.fps import fps

GAUSSIAN_NOISE_NUMBER = 24
LIDAR_NOISE_NUMBER = 48


@dataclasses.dataclass
class AugmentDraws:
    """The random numbers of one augmentation. A field left None is drawn
    from the generator; each augmentation reads its own fields."""
    aug_scale: Optional[torch.Tensor] = None     # [B, 1, 3] scale, scale-translate
    aug_shift: Optional[torch.Tensor] = None     # [B, 1, 3] translate, scale-translate
    aug_theta: Optional[torch.Tensor] = None     # [B] rotate: angle in [-pi, pi)
    aug_normal: Optional[torch.Tensor] = None    # [B, N, 3] jitter: standard normal
    aug_ratio: Optional[torch.Tensor] = None     # [B, 1] dropout: ratio in [0, 0.5)
    aug_u: Optional[torch.Tensor] = None         # [B, N] dropout: U(0, 1)
    aug_apply: Optional[torch.Tensor] = None     # [B, 1] hflip: U(0, 1)
    aug_axis: Optional[torch.Tensor] = None      # [B, 3] hflip: U(0, 1)


@dataclasses.dataclass
class CorruptDraws(AugmentDraws):
    """The random numbers of one ``corrupt_batch`` call. A field left None
    is drawn from the generator. Tests fill them with the JAX package's
    draws."""
    viewpoints: Optional[torch.Tensor] = None    # [B, 3] crop viewpoints
    choice: Optional[torch.Tensor] = None        # [npoints] FPS-column pick
    lidar_idx: Optional[torch.Tensor] = None     # [lidar_number]
    lidar_factor: Optional[torch.Tensor] = None  # [lidar_number]
    shell_normal: Optional[torch.Tensor] = None  # [B, gaussian_number, 3]


# augmentation name → (op, {op keyword: AugmentDraws field}), the reference's
# transform registry (datasets/data_transforms.py); shipped configs use
# 'scale-translate' and 'rotate'
AUGMENTATIONS = {
    "rotate": (rotate_y, {"theta": "aug_theta"}),
    "scale-translate": (scale_translate, {"scale": "aug_scale", "shift": "aug_shift"}),
    "scale": (pointcloud_scale, {"scale": "aug_scale"}),
    "translate": (pointcloud_translate, {"shift": "aug_shift"}),
    "jitter": (jitter, {"normal": "aug_normal"}),
    "dropout": (random_input_dropout, {"ratio": "aug_ratio", "u": "aug_u"}),
    "hflip": (random_horizontal_flip, {"apply": "aug_apply", "axis": "aug_axis"}),
}


def resolve_augmentation(name: Optional[str]) -> Optional[Callable[..., torch.Tensor]]:
    """Config key → ``augment(points, generator=None, draws=None)``, or None
    for no augmentation; an unknown name raises at step-build time instead
    of training without augmentation."""
    if not name or name == "none":
        return None
    if name not in AUGMENTATIONS:
        raise ValueError(f"unknown data_augmentation {name!r}; "
                         f"known: {sorted(AUGMENTATIONS)}")
    op, fields = AUGMENTATIONS[name]

    def augment(points: torch.Tensor, generator: Optional[torch.Generator] = None,
                draws: Optional[AugmentDraws] = None) -> torch.Tensor:
        kw = {k: getattr(draws, f) for k, f in fields.items()} if draws else {}
        return op(points, generator=generator, **kw)

    return augment


def point_all_for(npoints: int, available: int) -> int:
    """Oversampling size before the random FPS-column pick
    (``runner_module.py:112-124``)."""
    table = {1024: 1200, 2048: 2400, 4096: 4800, 8192: 8192}
    point_all = table.get(npoints, max(int(npoints * 1.17), npoints))
    return min(point_all, available)


def subsample_fps_random(pts: torch.Tensor, npoints: int, *,
                         generator: Optional[torch.Generator] = None,
                         choice: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FPS to point_all, then keep a random npoints-subset of the FPS
    columns (``runner_module.py:151-153``)."""
    point_all = point_all_for(npoints, pts.shape[1])
    sampled, _ = fps(pts, point_all)
    if choice is None:
        choice = torch.randperm(point_all, generator=generator,
                                device=pts.device)[:npoints]
    return sampled[:, choice, :]


def corrupt_batch(pts: torch.Tensor, *, npoints: int, n_points_dataset: int,
                  noisy_train: bool, incomplete_cropping: bool,
                  crop_ratio: float = 0.25, add_noise: bool = True,
                  noise_types: Sequence[str] = ("gaussian_noise", "lidar_noise"),
                  gaussian_number: int = GAUSSIAN_NOISE_NUMBER,
                  lidar_number: int = LIDAR_NOISE_NUMBER,
                  augmentation: Optional[str] = None,
                  normalize: bool = False,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[CorruptDraws] = None) -> torch.Tensor:
    """Crop/subsample → normalize? → noise → augment. Output has npoints
    (+ noise points) per cloud.

    The crop half of the viewpoint split is never computed: the pipeline
    keeps only the partial cloud. ``augmentation`` is a key of
    ``AUGMENTATIONS``, or None / 'none'."""
    augment = resolve_augmentation(augmentation)
    dr = draws or CorruptDraws()
    B = pts.shape[0]
    if noisy_train and incomplete_cropping:
        points = partial_point_cloud(
            pts, int(n_points_dataset * crop_ratio), sample_points=npoints,
            viewpoint=dr.viewpoints, generator=generator)
    else:
        points = subsample_fps_random(pts, npoints, generator=generator,
                                      choice=dr.choice)

    if normalize:
        points = normalize_unit_sphere(points)

    if noisy_train and add_noise:
        if "lidar_noise" in noise_types:
            noise = lidar_noise(points, lidar_number, low=1.2, scale=1.5,
                                generator=generator, idx=dr.lidar_idx,
                                factor=dr.lidar_factor)
            points = torch.cat([points, noise], dim=1)
        if "gaussian_noise" in noise_types:
            noise = gaussian_shell_noise(
                (B, gaussian_number, 3), loc=0.0, scale=0.1, shell_radius=0.9,
                generator=generator, normal=dr.shell_normal, device=pts.device)
            points = torch.cat([points, noise], dim=1)

    if augment is not None:
        points = augment(points, generator, dr)
    return points
