"""Approximate Earth Mover's Distance (counterpart of ``upp_tpu/ops/emd.py``).

The reference's CUDA extension ``extensions/emd`` (Fan/Mo auction-style
approxmatch): 10 rounds of exponentially sharpened soft assignment (levels
-4^7 ... -4^-2, then 0), each round three dense passes over the pairwise
squared-distance matrix. The JAX package computes it with XLA (a scan of
dense passes, no Pallas kernel); here it is plain tensor code on every
device, a loop of ten rounds.

Everything is float32: ``exp(level * d)`` with level as low as -16384
underflows to 0 as JAX's does. The backward of ``match_cost`` and of the
fused ``earth_mover_distance`` treats the match as a constant, as the JAX
custom VJPs and the reference's CUDA autograd (``emd_kernel.cu:286-358``) do.
"""

from __future__ import annotations

import torch

from .geometry import square_distance

# levels j = 7..-2; j == -2 uses level 0 (emd_kernel.cu:45-49)
_LEVELS = tuple(-(4.0 ** j) for j in range(7, -2, -1)) + (0.0,)


def _marginals(n: int, m: int):
    """The integer-division marginals (emd_kernel.cu:28-34)."""
    return (1.0, float(n // m)) if n >= m else (float(m // n), 1.0)


def _round(d2, level, remain_l, remain_r):
    """One round's kernel, row ratios and column ratios; updates remain_r."""
    kern = torch.exp(level * d2)                                     # [B, n, m]
    suml = 1e-9 + torch.einsum("bnm,bm->bn", kern, remain_r)
    ratio_l = remain_l / suml
    sumr = torch.einsum("bnm,bn->bm", kern, ratio_l) * remain_r
    consumption = torch.clamp(remain_r / (sumr + 1e-9), max=1.0)
    ratio_r = consumption * remain_r
    remain_r = torch.clamp(remain_r - sumr, min=0.0)
    return kern, ratio_l, ratio_r, remain_r


def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Soft assignment matrix between two clouds.

    Args:
      xyz1: [B, n, 3]; xyz2: [B, m, 3]
    Returns:
      match: [B, m, n] (the CUDA kernel's layout, ``match[i, l, k]`` with l
      over xyz2 and k over xyz1), float32, without gradient.
    """
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    mult_l, mult_r = _marginals(n, m)
    with torch.no_grad():
        d2 = square_distance(xyz1.float(), xyz2.float())             # [B, n, m]
        remain_l = d2.new_full((B, n), mult_l)
        remain_r = d2.new_full((B, m), mult_r)
        match = torch.zeros_like(d2)
        for level in _LEVELS:
            kern, ratio_l, ratio_r, remain_r = _round(d2, level, remain_l, remain_r)
            w = kern * ratio_l[:, :, None] * ratio_r[:, None, :]
            match = match + w
            remain_l = torch.clamp(remain_l - w.sum(2), min=0.0)
    return match.transpose(1, 2)                                     # [B, m, n]


def _grads(xyz1, xyz2, row, col, mx2, mx1, g):
    """(grad1, grad2) of the match cost with the match constant: row/col its
    marginals, mx2 = match @ xyz2, mx1 = match^T @ xyz1, g [B] the upstream
    gradient."""
    g = g[:, None, None]
    grad1 = 2.0 * (xyz1 * row[..., None] - mx2) * g
    grad2 = 2.0 * (xyz2 * col[..., None] - mx1) * g
    return grad1, grad2


class MatchCost(torch.autograd.Function):
    """cost[b] = sum_{k,l} ||xyz1_k - xyz2_l||^2 * match[b,l,k] (emd_kernel.cu
    matchcost, squared distances in float32), with the match a constant in
    the backward (matchcostgrad1/2)."""

    @staticmethod
    def forward(ctx, xyz1, xyz2, match):
        x1, x2 = xyz1.float(), xyz2.float()
        ctx.save_for_backward(x1, x2, match)
        d2 = square_distance(x1, x2)                                  # [B, n, m]
        return torch.einsum("bnm,bmn->b", d2, match.float())

    @staticmethod
    def backward(ctx, g):
        x1, x2, match = ctx.saved_tensors
        m_nm = match.float().transpose(1, 2)                          # [B, n, m]
        grad1, grad2 = _grads(x1, x2, m_nm.sum(2), m_nm.sum(1), m_nm @ x2,
                              m_nm.transpose(1, 2) @ x1, g)
        return grad1, grad2, None


def match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor, match: torch.Tensor) -> torch.Tensor:
    """[B] transport cost of ``match`` [B, m, n] between xyz1 [B, n, 3] and
    xyz2 [B, m, 3]."""
    return MatchCost.apply(xyz1, xyz2, match)


def _emd_scan(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """The fused match and cost: the same rounds as ``approx_match``,
    accumulating only reductions of each round's transported mass (the cost
    and the four gradient residuals: row and column marginals, match @ xyz2,
    match^T @ xyz1), so the [B, n, m] match is never held. Returns (cost,
    row, col, mx2, mx1)."""
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    mult_l, mult_r = _marginals(n, m)
    x1, x2 = xyz1.float(), xyz2.float()
    d2 = square_distance(x1, x2)                                      # [B, n, m]
    remain_l = d2.new_full((B, n), mult_l)
    remain_r = d2.new_full((B, m), mult_r)
    cost = d2.new_zeros((B,))
    row, col = d2.new_zeros((B, n)), d2.new_zeros((B, m))
    mx2, mx1 = d2.new_zeros((B, n, 3)), d2.new_zeros((B, m, 3))
    for level in _LEVELS:
        kern, ratio_l, ratio_r, remain_r = _round(d2, level, remain_l, remain_r)
        rhs = torch.cat([ratio_r[..., None], ratio_r[..., None] * x2], -1)     # [B, m, 4]
        left = kern @ rhs                                                       # [B, n, 4]
        w_row = ratio_l * left[..., 0]
        mx2 = mx2 + ratio_l[..., None] * left[..., 1:]
        lhs = torch.cat([ratio_l[..., None], ratio_l[..., None] * x1], -1)     # [B, n, 4]
        right = kern.transpose(1, 2) @ lhs                                      # [B, m, 4]
        col = col + ratio_r * right[..., 0]
        mx1 = mx1 + ratio_r[..., None] * right[..., 1:]
        cost = cost + torch.einsum("bn,bnm,bm->b", ratio_l, d2 * kern, ratio_r)
        row = row + w_row
        remain_l = torch.clamp(remain_l - w_row, min=0.0)
    return cost, row, col, mx2, mx1


class EmdCost(torch.autograd.Function):
    """[B] approximate EMD cost (not divided by n), the match a constant in
    the backward."""

    @staticmethod
    def forward(ctx, xyz1, xyz2):
        with torch.no_grad():
            cost, row, col, mx2, mx1 = _emd_scan(xyz1, xyz2)
        ctx.save_for_backward(xyz1, xyz2, row, col, mx2, mx1)
        return cost

    @staticmethod
    def backward(ctx, g):
        xyz1, xyz2, row, col, mx2, mx1 = ctx.saved_tensors
        grad1, grad2 = _grads(xyz1.float(), xyz2.float(), row, col, mx2, mx1, g)
        return grad1.to(xyz1.dtype), grad2.to(xyz2.dtype)


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         reduce_mean: bool = True) -> torch.Tensor:
    """EMD loss: the per-cloud match cost / n, batch-meaned unless
    ``reduce_mean`` is False (``extensions/emd/emd.py:26-49``). The fused
    path; ``approx_match`` + ``match_cost`` are the explicit-match API."""
    cost = EmdCost.apply(xyz1, xyz2) / xyz1.shape[1]
    return cost.mean() if reduce_mean else cost
