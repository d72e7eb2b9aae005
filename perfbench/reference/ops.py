"""Plain PyTorch point-cloud operations of the benchmark's reference.

A frozen copy, with no kernels, of what UPP's models, corruption and losses
compute: furthest point sampling, k nearest neighbours, grouping,
inverse-distance interpolation, Chamfer distances and the F-score, the
viewpoint crop, lidar and shell noise and the scale-translate augmentation.
Distances are ``(dx*dx + dy*dy) + dz*dz`` one elementwise op at a time in
float32, ties go to the lowest index, as the published CUDA operators of
pointnet2 and pytorch3d define them.

Every selection (FPS, kNN, Chamfer nearest neighbour) is reported to
``CALLS`` when a recorder is active, so a test can hold a cell's call
table to what the reference computes.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Optional

import torch

_BIG = 1e10
_PENALTY = 1e30

CALLS: list = []        # active recorders (Counters)


@contextlib.contextmanager
def record_calls():
    """Count the selections made inside the block by (kind, sizes)."""
    calls = Counter()
    CALLS.append(calls)
    try:
        yield calls
    finally:
        CALLS.remove(calls)


def _note(key) -> None:
    for calls in CALLS:
        calls[key] += 1


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., S, N] squared distances of a [..., S, 3] to b [..., N, 3]."""
    a, b = a.float(), b.float()
    dx = a[..., 0][..., :, None] - b[..., 0][..., None, :]
    dy = a[..., 1][..., :, None] - b[..., 1][..., None, :]
    dz = a[..., 2][..., :, None] - b[..., 2][..., None, :]
    return dx * dx + dy * dy + dz * dz


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C] at idx [B, ...] -> [B, ..., C]."""
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1, 1).long().expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


def fps(xyz: torch.Tensor, n: int, valid: Optional[torch.Tensor] = None,
        start: Optional[torch.Tensor] = None):
    """Furthest point sampling: (points [B, n, 3], idx [B, n]). Starts at the
    first valid point (or ``start``); a masked-out point is never taken."""
    _note(("fps", xyz.shape[1], n, valid is not None))
    p = xyz.detach().float()
    B, N, _ = p.shape
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    cur = (torch.zeros(B, dtype=torch.long, device=p.device) if valid is None
           else valid.float().argmax(1))
    if start is not None:
        cur = start.long()
    best = torch.full((B, N), _BIG, dtype=torch.float32, device=p.device)
    idx = torch.empty((B, n), dtype=torch.long, device=p.device)
    rows = torch.arange(B, device=p.device)
    for i in range(n):
        idx[:, i] = cur
        dx = x - x[rows, cur][:, None]
        dy = y - y[rows, cur][:, None]
        dz = z - z[rows, cur][:, None]
        best = torch.minimum(best, dx * dx + dy * dy + dz * dz)
        cand = best if valid is None else torch.where(valid, best, -1.0)
        cur = cand.argmax(1)
    return gather(xyz, idx), idx


def knn(query: torch.Tensor, points: torch.Tensor, k: int, with_xyz: bool = False):
    """(squared distances [B, S, k] ascending, idx [B, S, k]) of each query's
    k nearest points, differentiable in both clouds; with ``with_xyz`` also
    the neighbours' coordinates [B, S, k, 3]."""
    _note(("knn", query.shape[1], points.shape[1], k, with_xyz))
    d = sqdist(query, points)
    _, order = torch.sort(d.detach(), dim=-1, stable=True)
    idx = order[..., :k]
    d = torch.gather(d, -1, idx)
    return (d, idx, gather(points, idx)) if with_xyz else (d, idx)


def group(xyz: torch.Tensor, num_group: int, group_size: int):
    """(neighbourhoods [B, G, S, 3] relative to their centres, centres
    [B, G, 3], neighbour idx [B, G, S], centre idx [B, G])."""
    center, center_idx = fps(xyz, num_group)
    _, idx, nbr = knn(center, xyz, group_size, with_xyz=True)
    return nbr - center[:, :, None, :], center, idx, center_idx


def interpolate(xyz1, xyz2, feats2, k: int, eps: float):
    """Features of xyz2 [B, S, 3] blended onto xyz1 [B, N, 3] with weights
    1 / (d + eps) over the k nearest, normalised."""
    d, idx = knn(xyz1, xyz2, min(k, xyz2.shape[1]))
    w = 1.0 / (d.clamp_min(0.0) + eps)
    w = w / w.sum(-1, keepdim=True)
    return (gather(feats2, idx) * w[..., None]).sum(2)


def nearest(x: torch.Tensor, y: torch.Tensor):
    """(idx [B, N] of each x's nearest y, idx [B, M] of each y's nearest x),
    chunked over queries."""
    _note(("chamfer", x.shape[1], y.shape[1], False))

    def one(q, p):
        chunk = max(1, (1 << 26) // max(q.shape[0] * p.shape[1], 1))
        return torch.cat([sqdist(q[:, lo:lo + chunk], p).argmin(-1)
                          for lo in range(0, q.shape[1], chunk)], 1)

    return one(x.detach(), y.detach()), one(y.detach(), x.detach())


def chamfer_sq(x: torch.Tensor, y: torch.Tensor):
    """Squared distances of each x to its nearest y [B, N], and of each y to
    its nearest x [B, M], differentiable through the matched pairs."""
    i1, i2 = nearest(x, y)
    d1 = ((x - gather(y, i1)) ** 2).sum(-1)
    d2 = ((y - gather(x, i2)) ** 2).sum(-1)
    return d1, d2


def chamfer_l1(x, y, eps: float = 1e-12) -> torch.Tensor:
    """(mean sqrt(d1) + mean sqrt(d2)) / 2 over the batch."""
    d1, d2 = chamfer_sq(x, y)
    return (d1.clamp_min(eps).sqrt().mean() + d2.clamp_min(eps).sqrt().mean()) / 2.0


def chamfer_l1_per_sample(x, y, eps: float = 1e-12) -> torch.Tensor:
    d1, d2 = chamfer_sq(x, y)
    return (d1.clamp_min(eps).sqrt().mean(-1) + d2.clamp_min(eps).sqrt().mean(-1)) / 2.0


def chamfer_l2_per_sample(x, y) -> torch.Tensor:
    d1, d2 = chamfer_sq(x, y)
    return d1.mean(-1) + d2.mean(-1)


def fscore(pred, gt, threshold: float = 0.01) -> torch.Tensor:
    """Per-sample F-score at ``threshold``."""
    d1, d2 = chamfer_sq(pred, gt)
    recall = (d2.sqrt() < threshold).float().mean(-1)
    precision = (d1.sqrt() < threshold).float().mean(-1)
    f = 2 * recall * precision / (recall + precision + 1e-12)
    return torch.where(recall + precision > 0, f, 0.0)


def crop(xyz: torch.Tensor, num_crop: int, viewpoints: torch.Tensor, n: int):
    """Viewpoint crop: the ``num_crop`` points nearest each cloud's viewpoint
    [B, 3] (ties in index order) are cut away; the rest, FPS-resampled to
    ``n`` from its point nearest the viewpoint, is the partial cloud."""
    v = viewpoints.to(device=xyz.device, dtype=torch.float32).expand(xyz.shape[0], 3)
    dx = xyz[..., 0] - v[:, 0:1]
    dy = xyz[..., 1] - v[:, 1:2]
    dz = xyz[..., 2] - v[:, 2:3]
    d = dx * dx + dy * dy + dz * dz
    thresh = torch.kthvalue(d, num_crop, dim=1, keepdim=True).values
    below, at = d < thresh, d == thresh
    cut = below | (at & (torch.cumsum(at.int(), 1) <= num_crop - below.sum(1, keepdim=True)))

    keep = ~cut
    start = torch.where(keep, d, torch.inf).argmin(1)
    return fps(xyz, n, valid=keep, start=start)[0]


def lidar_noise(points, idx, factor) -> torch.Tensor:
    """Existing points ``idx`` pushed outward by ``factor`` (shared by the
    batch)."""
    return points[:, idx, :] * factor[None, :, None]


def shell_noise(normal, scale: float, radius: float) -> torch.Tensor:
    """N(0, scale) samples pushed radially outward by ``radius``."""
    g = scale * normal
    return g + g / torch.linalg.norm(g, dim=-1, keepdim=True) * radius


def scale_translate(pc, scale, shift) -> torch.Tensor:
    return pc * scale + shift


def positional_embedding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    out = [x]
    for k in range(n_freqs):
        out += [torch.sin(float(2 ** k) * x), torch.cos(float(2 ** k) * x)]
    return torch.cat(out, dim=-1)
