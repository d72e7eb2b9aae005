"""Chamfer distance (counterpart of ``upp_tpu/ops/chamfer.py``).

The nearest neighbours in both directions come from ``nn_both``: on CUDA
tensors the hand-written kernel (``chamfer_cuda`` / ``csrc/chamfer.cu``) at
every call site, whatever the size; on CPU tensors ``nn_both_plain``, the
plain PyTorch version the kernel is held against. Both use the difference
form of the squared distance, as the Pallas kernel does, and break ties
toward the lowest index. The indices are constants; ``nn_distance``
recomputes the matched-pair distances differentiably, so gradients flow
through the matched pairs only (the reference's custom backward).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .geometry import index_points

_BIG = 1e30                 # additive penalty of an invalid target
_CHUNK_ELEMS = 1 << 26      # query chunk: B*chunk*M distances at a time


def _nn_one_plain(q: torch.Tensor, p: torch.Tensor, valid_p: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query, (min over targets of d + penalty, its lowest index)."""
    B, N, _ = q.shape
    M = p.shape[1]
    pen = None if valid_p is None else torch.where(valid_p, 0.0, _BIG)[:, None, :]
    px, py, pz = (p[..., c][:, None, :] for c in range(3))
    chunk = max(1, _CHUNK_ELEMS // max(B * M, 1))
    ds, idxs = [], []
    for lo in range(0, N, chunk):
        qc = q[:, lo:lo + chunk]
        dx = qc[..., 0][:, :, None] - px
        dy = qc[..., 1][:, :, None] - py
        dz = qc[..., 2][:, :, None] - pz
        d = dx * dx + dy * dy + dz * dz                   # [B, chunk, M]
        if pen is not None:
            d = d + pen
        i = d.argmin(-1)                                  # first minimum
        ds.append(torch.gather(d, -1, i[..., None])[..., 0])
        idxs.append(i)
    return torch.cat(ds, 1), torch.cat(idxs, 1)


def nn_both_plain(x: torch.Tensor, y: torch.Tensor,
                  valid_x: Optional[torch.Tensor] = None,
                  valid_y: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch bidirectional nearest neighbours: (d1 [B,N], i1 [B,N]
    int64, d2 [B,M], i2 [B,M] int64), the kernel's arithmetic: ``(dx*dx +
    dy*dy) + dz*dz`` one elementwise op at a time, plus the 1e30 penalty of
    an invalid target, then the first minimum. Chunked over queries, so the
    [B, N, M] distances are never held whole."""
    xf, yf = x.detach().float(), y.detach().float()
    d1, i1 = _nn_one_plain(xf, yf, valid_y)
    d2, i2 = _nn_one_plain(yf, xf, valid_x)
    return d1, i1, d2, i2


def nn_both(x: torch.Tensor, y: torch.Tensor,
            valid_x: Optional[torch.Tensor] = None,
            valid_y: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bidirectional nearest neighbours of ``x`` [B,N,3] vs ``y`` [B,M,3]:
    (d1, i1 int64, d2, i2 int64). Not differentiable; invalid slots are
    never chosen as targets, and their own entries are unspecified."""
    if x.device.type == "cuda":
        from . import chamfer_cuda
        c = lambda v: None if v is None else v.bool().contiguous()  # noqa: E731
        d1, i1, d2, i2 = chamfer_cuda.nn_both(
            x.detach().float().contiguous(), y.detach().float().contiguous(),
            c(valid_x), c(valid_y))
        return d1, i1.long(), d2, i2.long()
    if x.device.type == "cpu":
        return nn_both_plain(x, y, valid_x, valid_y)
    raise ValueError(f"nn_both: unsupported device {x.device}")


def nn_distance(xyz1: torch.Tensor, xyz2: torch.Tensor,
                valid1: Optional[torch.Tensor] = None,
                valid2: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bidirectional nearest-neighbour squared distances: (dist1 [B,N],
    idx1 [B,N], dist2 [B,M], idx2 [B,M]). ``valid*`` masks exclude padded
    slots as targets, and their own distances are 0. Differentiable in
    xyz1/xyz2 through the matched pairs."""
    _, idx1, _, idx2 = nn_both(xyz1, xyz2, valid1, valid2)
    dist1 = ((xyz1 - index_points(xyz2, idx1)) ** 2).sum(-1)
    dist2 = ((xyz2 - index_points(xyz1, idx2)) ** 2).sum(-1)
    if valid1 is not None:
        dist1 = torch.where(valid1, dist1, 0.0)
    if valid2 is not None:
        dist2 = torch.where(valid2, dist2, 0.0)
    return dist1, idx1, dist2, idx2


def _masked_mean(d: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return d.mean()
    return d.sum() / valid.sum().clamp_min(1)


def chamfer_raw(xyz1, xyz2, valid1=None, valid2=None):
    """(mean dist1, mean dist2): the building block of the L1/L2 losses."""
    d1, _, d2, _ = nn_distance(xyz1, xyz2, valid1, valid2)
    return _masked_mean(d1, valid1), _masked_mean(d2, valid2)


def chamfer_l2(xyz1, xyz2, valid1=None, valid2=None):
    """ChamferDistanceL2: mean(d1) + mean(d2) of squared distances."""
    m1, m2 = chamfer_raw(xyz1, xyz2, valid1, valid2)
    return m1 + m2


def chamfer_l2_split(xyz1, xyz2, valid1=None, valid2=None):
    """ChamferDistanceL2_split: (mean(d1), mean(d2))."""
    return chamfer_raw(xyz1, xyz2, valid1, valid2)


def chamfer_l1(xyz1, xyz2, valid1=None, valid2=None, eps: float = 1e-12):
    """ChamferDistanceL1: (mean sqrt(d1) + mean sqrt(d2)) / 2, with d clamped
    at ``eps`` so coincident points have a finite gradient."""
    d1, _, d2, _ = nn_distance(xyz1, xyz2, valid1, valid2)
    s1 = d1.clamp_min(eps).sqrt()
    s2 = d2.clamp_min(eps).sqrt()
    if valid1 is not None:
        s1 = torch.where(valid1, s1, 0.0)
    if valid2 is not None:
        s2 = torch.where(valid2, s2, 0.0)
    return (_masked_mean(s1, valid1) + _masked_mean(s2, valid2)) / 2.0


def chamfer_l1_per_sample(xyz1, xyz2, eps: float = 1e-12):
    """Per-sample [B] ChamferDistanceL1 (the reference evaluates one sample
    at a time; one batched call gives the same per-sample values)."""
    d1, _, d2, _ = nn_distance(xyz1, xyz2)
    return (d1.clamp_min(eps).sqrt().mean(-1) + d2.clamp_min(eps).sqrt().mean(-1)) / 2.0


def chamfer_l2_per_sample(xyz1, xyz2):
    """Per-sample [B] ChamferDistanceL2."""
    d1, _, d2, _ = nn_distance(xyz1, xyz2)
    return d1.mean(-1) + d2.mean(-1)
