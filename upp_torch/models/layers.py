"""Shared neural building blocks (counterpart of ``upp_tpu/models/layers.py``).

Module and parameter names follow the reference's ``.pth`` layout
(``models/Point_MAE_unify.py``), so its checkpoints load without renaming.
Pointwise ("Conv1d/Conv2d k=1") layers keep the reference's weight shapes
but compute on a channels-last layout as a matrix product, like the JAX
package's Dense layers.

Numerics as in the JAX model: LayerNorm eps 1e-6, BatchNorm eps 1e-5 with
torch's running-statistics semantics (momentum 0.1 here is flax's 0.9;
batch statistics in ``.train()``, the unbiased variance folded into the
running average, as the JAX ``TorchBatchNorm`` imitates), exact GELU.
Inside a train step of several ranks (``parallel.shard.global_batch``)
every BatchNorm takes the statistics of the global batch, as the JAX jit
step over a sharded batch does. Random draws of train mode (dropout,
drop-path) come from the train step's generator inside ``global_batch``,
drawn for the global batch; else from torch's RNG, or drop-path's from a
generator the caller passes.

``if_half`` (``compute_dtype=torch.bfloat16``): the products of the
transformer blocks (``Attention``, ``Mlp``) and of ``Encoder``'s pointwise
convolutions take bf16 operands with float32 accumulation, as the JAX
package's ``preferred_element_type=float32`` einsums do
(``upp_tpu/models/scan_blocks.py:336-362``); parameters, LayerNorm,
softmax, BatchNorm statistics, biases and residuals stay float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import shard
from ..parallel.dist import all_reduce_sum, data_group

LN_EPS = 1e-6
BN_EPS = 1e-5


class _HalfLinear(torch.autograd.Function):
    """``x @ w.T (+ b)`` on the card with bf16 operands and a float32
    product: one ``torch.mm``/``addmm(..., out_dtype=float32)``
    (``aten::mm.dtype``, a bf16 tensor-core GEMM whose epilogue adds the
    float32 bias), which has no derivative of its own. Each operand's
    gradient is a bf16 GEMM of the bf16-rounded cotangent, rounded once to
    bf16 as JAX's ``dot_general`` transpose casts to its operand's type;
    the bias's is the float32 sum. One Function a product keeps the host's
    work per call near ``F.linear``'s: the step is host-bound at these
    token counts."""

    @staticmethod
    def forward(ctx, x, w, b):
        x16 = x.reshape(-1, x.shape[-1]).bfloat16()
        w16 = w.bfloat16()
        # a frozen weight (the PEFT backbone) needs no copy of its input
        ctx.save_for_backward(x16 if ctx.needs_input_grad[1] else None, w16)
        ctx.has_bias = b is not None
        y = (torch.mm(x16, w16.t(), out_dtype=torch.float32) if b is None
             else torch.addmm(b, x16, w16.t(), out_dtype=torch.float32))
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x16, w16 = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        g16 = g2.bfloat16()
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(g16, w16).reshape(*g.shape[:-1], w16.shape[1])
        if ctx.needs_input_grad[1]:
            gw = torch.mm(g16.t(), x16)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = g2.sum(0)
        return gx, gw, gb


class _HalfBmm(torch.autograd.Function):
    """``a @ b`` batched over the leading axes on the card, bf16 operands,
    float32 product (``torch.bmm(..., out_dtype=float32)``); gradients as
    ``_HalfLinear``'s."""

    @staticmethod
    def forward(ctx, a, b):
        a16 = a.bfloat16().reshape(-1, *a.shape[-2:])
        b16 = b.bfloat16().reshape(-1, *b.shape[-2:])
        ctx.save_for_backward(a16, b16)
        ctx.shapes = (a.shape, b.shape)
        out = torch.bmm(a16, b16, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-2], *out.shape[-2:])

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        a_shape, b_shape = ctx.shapes
        g16 = g.bfloat16().reshape(-1, *g.shape[-2:])
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g16, b16.transpose(1, 2)).reshape(a_shape)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a16.transpose(1, 2), g16).reshape(b_shape)
        return ga, gb


def half_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with both operands rounded to bf16 and the product in
    float32: ``jnp.einsum(a.astype(bf16), b.astype(bf16),
    preferred_element_type=float32)``. ``b`` is a weight [K, N] or batched
    like ``a``. On the CPU the operands are upcast again, which is exact (a
    product of two bf16 values fits a float32), and autograd rounds each
    gradient to bf16 through the casts, as JAX does; on the card
    ``_HalfLinear``/``_HalfBmm``. A plain ``bf16 @ bf16`` would round the
    product to bf16 before the bias."""
    if a.device.type == "cuda":
        return _HalfLinear.apply(a, b.t(), None) if b.dim() == 2 else _HalfBmm.apply(a, b)
    return a.bfloat16().float() @ b.bfloat16().float()


def compute_dtype(if_half: bool) -> torch.dtype:
    """The products' operand type of a model with the config's ``if_half``."""
    return torch.bfloat16 if if_half else torch.float32


def matmul(a: torch.Tensor, b: torch.Tensor, half: bool) -> torch.Tensor:
    """``a @ b``, or ``half_matmul`` with ``half``."""
    return half_matmul(a, b) if half else a @ b


def linear(x: torch.Tensor, layer: nn.Linear, half: bool, bias: bool = True) -> torch.Tensor:
    """``layer(x)``, or with ``half`` its product by ``half_matmul`` and the
    float32 bias added after (in the GEMM's epilogue on the card); without
    ``bias`` the product alone."""
    b = layer.bias if bias else None
    if not half:
        return layer(x) if bias else F.linear(x, layer.weight)
    if x.device.type == "cuda":
        return _HalfLinear.apply(x, layer.weight, b)
    y = half_matmul(x, layer.weight.t())
    return y if b is None else y + b


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-sample stochastic depth (timm DropPath): in training, each sample
    is zeroed with probability ``rate`` and the rest scaled by 1/(1-rate),
    drawn from ``generator``, else the train step's (torch's RNG outside
    one)."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    mask = shard.bernoulli((x.shape[0],) + (1,) * (x.dim() - 1), keep,
                           generator=generator if generator is not None
                           else shard.model_generator(), device=x.device, dtype=x.dtype)
    return x / keep * mask


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose mask is drawn, inside a train step
    (``shard.global_batch``), from the step's generator for the global
    batch; from torch's RNG outside one."""

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        return x * shard.bernoulli(x.shape, keep, generator=shard.model_generator(),
                                   device=x.device, dtype=x.dtype) / keep


def batch_norm_last(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Apply a BatchNorm module over the last axis of ``x`` (statistics over
    all other axes), whatever the module's own dimensionality; in train
    mode inside a train step of several ranks, with the global batch's
    statistics (``global_batch_norm``)."""
    flat = x.reshape(-1, x.shape[-1])
    if bn.training and shard.current().is_global:
        y = global_batch_norm(bn, flat)
    else:
        y = F.batch_norm(flat, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         bn.training, bn.momentum, bn.eps)
    return y.reshape(x.shape)


def global_batch_norm(bn: nn.modules.batchnorm._BatchNorm, flat: torch.Tensor) -> torch.Tensor:
    """Train-mode BatchNorm of this rank's rows ``flat`` [n, C] with the
    statistics of every data rank's rows (the reference's SyncBN, the JAX
    step's global batch; ``dist.data_group``): the count and the sum are
    all-reduced for the mean, then the centred sum of squares for the
    biased variance, which normalises (two passes: a one-pass sum of
    squares drifts in float32). The running
    statistics take the mean and the unbiased variance over the global
    count, torch's semantics (``upp_tpu/models/layers.py:41``). The
    all-reduces are differentiable: their backward sums the gradients over
    ranks, which with the optimizer's mean over ranks gives the one-process
    gradient."""
    total = all_reduce_sum(torch.cat([flat.sum(0), flat.new_full((1,), flat.shape[0])]),
                           data_group())
    count = total[-1]
    mean = total[:-1] / count
    centred = flat - mean
    var = all_reduce_sum((centred * centred).sum(0), data_group()) / count
    y = centred * torch.rsqrt(var + bn.eps)
    if bn.affine:
        y = y * bn.weight + bn.bias
    if bn.track_running_stats:
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1.0 - m).add_(m * mean)
            bn.running_var.mul_(1.0 - m).add_(m * var * (count / (count - 1.0)))
    return y


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (same parameters, buffers and state-dict keys) on
    channels-last input [..., C] through ``batch_norm_last``."""

    def forward(self, x):
        if self.training and self.track_running_stats:
            self.num_batches_tracked.add_(1)
        return batch_norm_last(self, x)


class PointConv(nn.Module):
    """Pointwise convolution with the reference's ``Conv1d``/``Conv2d``
    (kernel 1) weight shape [out, in, 1] / [out, in, 1, 1], applied to
    channels-last input as ``x @ W.T + b``."""

    def __init__(self, in_ch: int, out_ch: int, conv_dims: int = 1, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((out_ch, in_ch) + (1,) * conv_dims))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        # torch's Conv default init: kaiming_uniform(a=sqrt(5))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if self.bias is not None:
            bound = 1.0 / math.sqrt(in_ch)
            nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x):
        return F.linear(x, self.weight.reshape(self.weight.shape[0], -1), self.bias)


class TwoLayerHead(nn.Sequential):
    """Linear → GELU → Linear (shape_pred / coarse_pred /
    predict_token_generator, ``Point_MAE_unify.py:424-439``)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int):
        super().__init__(nn.Linear(in_dim, hidden), nn.GELU(),
                         nn.Linear(hidden, out_dim))


class PosEmbedMLP(TwoLayerHead):
    """3 → 128 → GELU → out_dim positional embedding
    (``Point_MAE_unify.py:408-412``)."""

    def __init__(self, out_dim: int, hidden: int = 128):
        super().__init__(3, hidden, out_dim)


class Mlp(nn.Module):
    """Transformer MLP (``Point_MAE_unify.py:226-242``); dropout 0. With
    ``compute_dtype`` bf16 its two products are ``half_matmul``s. Under
    tensor parallelism (``tp``, set by ``parallel.tensor``) ``fc1`` holds
    this rank's rows (column parallel) and ``fc2`` the matching columns
    (row parallel): ``fc1``'s bias, replicated as in JAX, is sliced at use,
    and ``fc2``'s is added once, after the sum over the model group."""

    def __init__(self, dim: int, hidden: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.half = compute_dtype == torch.bfloat16
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.tp = None

    def forward(self, x):
        tp = self.tp
        if tp is None:
            return linear(F.gelu(linear(x, self.fc1, self.half)), self.fc2, self.half)
        h = linear(tp.copy_in(x), self.fc1, self.half, bias=False)
        h = F.gelu(h + tp.local_rows(tp.copy_in(self.fc1.bias)))
        return tp.reduce_out(linear(h, self.fc2, self.half, bias=False)) + self.fc2.bias


class Attention(nn.Module):
    """Multi-head self-attention without qkv bias
    (``Point_MAE_unify.py:245-269``), written out as matrix products. With
    ``compute_dtype`` bf16 the four products are ``half_matmul``s: q, k, v
    and the probabilities enter theirs as bf16, the scores and the softmax
    stay float32 (``upp_tpu/models/scan_blocks.py:336-351``). Under tensor
    parallelism (``tp``, set by ``parallel.tensor``) ``qkv`` holds the q, k
    and v rows of this rank's whole heads (column parallel) and ``proj``
    the matching columns (row parallel), its bias added once, after the sum
    over the model group."""

    def __init__(self, dim: int, num_heads: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.half = compute_dtype == torch.bfloat16
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.tp = None

    def forward(self, x):
        B, N, C = x.shape
        tp = self.tp
        hd = C // self.num_heads
        H = self.num_heads // (tp.size if tp is not None else 1)
        qkv = linear(x if tp is None else tp.copy_in(x), self.qkv, self.half)
        qkv = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                     # [B, H, N, hd]
        attn = torch.softmax(matmul(q, k.transpose(-2, -1), self.half) * hd ** -0.5, dim=-1)
        out = matmul(attn, v, self.half).transpose(1, 2).reshape(B, N, H * hd)
        if tp is None:
            return linear(out, self.proj, self.half)
        return tp.reduce_out(linear(out, self.proj, self.half, bias=False)) + self.proj.bias


class Adapter(nn.Module):
    """Bottleneck adapter with dropout 0.1 inside and a fixed 0.7 output
    scale (``Point_MAE_pretask_dev.py:54-104``)."""

    scale = 0.7

    def __init__(self, embed_dims: int, reduction_dims: int = 32):
        super().__init__()
        self.layer_norm = layer_norm(embed_dims)
        self.ln1 = nn.Linear(embed_dims, reduction_dims)
        self.dropout = Dropout(0.1)
        self.ln2 = nn.Linear(reduction_dims, embed_dims)

    def forward(self, x):
        h = self.dropout(F.gelu(self.ln1(self.layer_norm(x))))
        return self.ln2(h) * self.scale


class Encoder(nn.Module):
    """Mini-PointNet group tokenizer (``Point_MAE_unify.py:191-222``):
    [B, G, n, 3] center-relative neighbourhoods → tokens [B, G, C]. BatchNorm
    statistics span (batch, groups, points), as torch's BatchNorm1d on the
    flattened (B*G, C, n) layout.

    ``vis_idx`` [B, V] (MAE pretraining) returns the tokens of those groups
    alone, gathered right after the second BatchNorm: every group enters
    both BatchNorms' statistics, as the reference encodes all groups before
    its mask select (``Point_MAE_cp.py:352-357``), and the last conv and
    pool run on the visible groups only (``upp_tpu/models/layers.py:224-228``).
    Gathering before the encoder would change the statistics.

    ``compute_dtype`` bf16 (``Point_MAE``'s ``if_half``) runs each conv as
    flax's ``Dense(dtype=bfloat16)`` does: a ``half_matmul`` rounded to
    bf16, plus the bias rounded to bf16; each BatchNorm normalises in
    float32 and its output is cast back to bf16; the tokens come out
    float32 (``upp_tpu/models/layers.py:205-230``)."""

    def __init__(self, encoder_channel: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder_channel = encoder_channel
        self.half = compute_dtype == torch.bfloat16
        self.first_conv = nn.Sequential(
            PointConv(3, 128), BatchNorm1d(128, eps=BN_EPS), nn.ReLU(),
            PointConv(128, 256))
        self.second_conv = nn.Sequential(
            PointConv(512, 512), BatchNorm1d(512, eps=BN_EPS), nn.ReLU(),
            PointConv(512, encoder_channel))

    def _conv(self, conv: PointConv, x: torch.Tensor) -> torch.Tensor:
        if not self.half:
            return conv(x)
        w = conv.weight.reshape(conv.weight.shape[0], -1)
        return half_matmul(x, w.t()).bfloat16() + conv.bias.bfloat16()

    def _bn(self, bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return bn(x.float()).bfloat16() if self.half else bn(x)

    def forward(self, point_groups, vis_idx: Optional[torch.Tensor] = None):
        bs, g, n, _ = point_groups.shape
        fc, sc = self.first_conv, self.second_conv
        x = fc[2](self._bn(fc[1], self._conv(fc[0], point_groups.reshape(bs * g * n, 3))))
        x = self._conv(fc[3], x).reshape(bs * g, n, 256)
        g_max = x.amax(1, keepdim=True).expand(-1, n, -1)
        x = torch.cat([g_max, x], dim=-1).reshape(bs * g * n, 512)
        x = self._bn(sc[1], self._conv(sc[0], x))
        if vis_idx is not None:
            g = vis_idx.shape[1]
            x = torch.gather(x.reshape(bs, -1, n, 512), 1,
                             vis_idx[:, :, None, None].expand(-1, -1, n, 512))
            x = x.reshape(bs * g * n, 512)
        x = self._conv(sc[3], sc[2](x))
        x = x.reshape(bs * g, n, self.encoder_channel).amax(1)
        x = x.reshape(bs, g, self.encoder_channel)
        return x.float() if self.half else x


def positional_embedding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """NeRF sin/cos embedding, x ‖ sin(2^k x) ‖ cos(2^k x)."""
    out = [x]
    for k in range(n_freqs):
        f = float(2 ** k)
        out.append(torch.sin(f * x))
        out.append(torch.cos(f * x))
    return torch.cat(out, dim=-1)
