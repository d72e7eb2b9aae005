"""Plain PyTorch reference of UPP's part-segmentation model and its PEFT
train step, as functions of a weight dict.

``Point_MAE_unify_seg`` (upstream ``models/Point_MAE_unify_segment.py``,
with ``cfgs/unify_shapenetpart_seg.yaml`` and ``tools/runner_unify_seg.py``):
the classifier's rectify and completion front end (``model.Net``, on the
64-group geometry whatever ``num_group`` says), then the downstream pass
over ``num_group`` groups with prompts and adapters and no prompt
propagation, tapping the tokens after blocks 3, 7 and 11; the taps
concatenated, their max and mean over the groups and a 128-d embedding of
the one-hot category form one row a cloud; the taps are interpolated onto
the query points from their 3 nearest group centres and joined to the
points' coordinates (``propagation_0``); the row a cloud is repeated over
the points and concatenated to them, as upstream writes it, before the seg
head (conv, BatchNorm, ReLU, dropout 0.5; conv, BatchNorm, ReLU; conv to
the 50 parts); log-softmax; NLL.

The train step's corruption follows ``runner_unify_seg.py``: scale-translate
of the whole cloud, then the raw crop (the points sorted by their distance
to a viewpoint, the nearest 25% cut, no resampling), 24 shell points, then
64 lidar points drawn from the cropped cloud with its shell points. The
network is queried at the augmented whole cloud.

Departures from upstream, each the port's behaviour kept as it is: the
inverse-distance weights of ``propagation_0`` are 1 / (d + 1e-4), where
upstream's PointNet++ propagation adds 1e-8 (the JAX package and the port
share the prompter's 1e-4); the shell noise is N(0, 0.1) pushed out to
radius 0.8 (the seg runner's ``--deviation`` and ``--noise_radius``
defaults); the visible-group count of the front end is 32, half of the
64-group anchor. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import ops
from .model import Draws, Net, param_shapes as core_shapes

TAPS = (3, 7, 11)           # blocks whose output the head reads
FRONT_GROUPS = 64           # the rectify and completion passes' group anchor
LABEL_CLASSES, LABEL_DIM = 16, 128
PROP_MLP = (1536, 1024)     # propagation_0's convs
HEAD = (512, 256)           # the seg head's hidden convs
INTERP_K, INTERP_EPS = 3, 1e-4
SHELL_NUM, LIDAR_NUM = 24, 64
SHELL_SCALE, SHELL_RADIUS = 0.1, 0.8


def front_cfg(cfg: dict) -> dict:
    """The model section as the front end reads it: the 64-group geometry,
    no classification head."""
    return {**{k: v for k, v in cfg.items() if k != "cls_dim"}, "num_group": FRONT_GROUPS}


class SegNet(Net):
    """The seg model's weights ``P`` and layout ``cfg`` (the config's model
    section); ``draws`` set means train mode."""

    def __init__(self, P: Dict[str, torch.Tensor], cfg: dict, draws=None):
        super().__init__(P, front_cfg(cfg), draws)
        self.groups = cfg["num_group"]

    def front(self, pts, point_num: int):
        """The rectify pass (the 5% noisiest dropped) and the completion
        pass with its re-sampling to ``point_num``."""
        vec = self.rectify_vectors(pts)
        order = torch.argsort(-torch.linalg.norm(vec, dim=-1), dim=1, stable=True)
        pts = ops.gather(pts + 0.2 * vec, order[:, -int(point_num * 0.95):])
        _, rebuild = self.complete(pts)
        pts = torch.cat([pts, ops.fps(rebuild, point_num // 4)[0]], 1)
        return ops.fps(pts, point_num)[0] if pts.shape[1] > point_num else pts

    def taps(self, pts):
        """(group centres [B, G, 3], the tokens after each block of ``TAPS``)."""
        nbr, center, _, _ = ops.group(pts, self.groups, self.cfg["group_size"])
        x, pos = self.encoder(nbr), self.mlp2(center, "pos_embed")
        prompt_depth = min(self.prompt_depth["downstream"], self.depth)
        out = []
        for i in range(self.depth):
            prompted = i < prompt_depth
            adapter = self.adapter_len["downstream"] >= (prompt_depth if prompted else self.depth)
            x = self.block(x, pos, f"blocks.blocks.{i}", self.rate * i / max(self.depth - 1, 1),
                           self.heads, "downstream", prompted, adapter)
            if i in TAPS:
                out.append(x)
        return center, out

    def label_embedding(self, one_hot):
        e = one_hot
        for lin, bn in ((0, 1), (3, 4)):
            e = F.leaky_relu(self.bn(self.linear(e, f"label_conv.{lin}"), f"label_conv.{bn}"),
                             0.2)
        return e

    def head(self, query, center, taps, one_hot):
        """Log-probabilities [B, N, parts] at the query points [B, N, 3]."""
        x = torch.cat(taps, -1)
        glob = torch.cat([x.amax(1), x.mean(1), self.label_embedding(one_hot)], -1)
        f = torch.cat([query, ops.interpolate(query, center, x, k=INTERP_K, eps=INTERP_EPS)], -1)
        for i in range(len(PROP_MLP)):
            f = F.relu(self.bn(self.linear(f, f"propagation_0.mlp_convs.{i}"),
                               f"propagation_0.mlp_bns.{i}"))
        h = torch.cat([f, glob[:, None, :].expand(-1, f.shape[1], -1)], -1)
        h = self.dropout(F.relu(self.bn(self.linear(h, "seg_head.0"), "seg_head.1")), 0.5)
        h = F.relu(self.bn(self.linear(h, "seg_head.4"), "seg_head.5"))
        return F.log_softmax(self.linear(h, "seg_head.7"), -1)

    def segment(self, pts, one_hot, query, point_num: int):
        center, taps = self.taps(self.front(pts, point_num))
        return self.head(query, center, taps, one_hot)


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Name -> shape of every weight and BatchNorm buffer of the seg model,
    in the released ``.pth`` layout."""
    out = core_shapes(front_cfg(cfg))
    C = cfg["transformer_config"]["trans_dim"]
    n_taps = sum(i < cfg["transformer_config"]["depth"] for i in TAPS)

    def conv(name, i, o):
        out[name + ".weight"] = (o, i, 1)
        out[name + ".bias"] = (o,)

    def bn(name, c):
        out.update({name + ".weight": (c,), name + ".bias": (c,), name + ".running_mean": (c,),
                    name + ".running_var": (c,), name + ".num_batches_tracked": ()})

    conv("label_conv.0", LABEL_CLASSES, 64)
    bn("label_conv.1", 64)
    conv("label_conv.3", 64, LABEL_DIM)
    bn("label_conv.4", LABEL_DIM)
    chans = (3 + n_taps * C,) + PROP_MLP
    for i, (a, b) in enumerate(zip(chans, chans[1:])):
        conv(f"propagation_0.mlp_convs.{i}", a, b)
        bn(f"propagation_0.mlp_bns.{i}", b)
    conv("seg_head.0", PROP_MLP[-1] + 2 * n_taps * C + LABEL_DIM, HEAD[0])
    bn("seg_head.1", HEAD[0])
    conv("seg_head.4", HEAD[0], HEAD[1])
    bn("seg_head.5", HEAD[1])
    conv("seg_head.7", HEAD[1], cfg["cls_dim"])
    return out


def corrupt(pts, draws: dict, num_crop: int) -> torch.Tensor:
    """The seg step's corruption of the augmented clouds: the raw crop, then
    the shell points, then the lidar points."""
    v = draws["viewpoints"]
    dx = pts[..., 0] - v[:, 0:1]
    dy = pts[..., 1] - v[:, 1:2]
    dz = pts[..., 2] - v[:, 2:3]
    order = torch.argsort(dx * dx + dy * dy + dz * dz, dim=1, stable=True)
    points = ops.gather(pts, order)[:, num_crop:]
    points = torch.cat([points, ops.shell_noise(draws["shell_normal"], SHELL_SCALE,
                                                SHELL_RADIUS)], 1)
    return torch.cat([points, ops.lidar_noise(points, draws["lidar_idx"],
                                              draws["lidar_factor"])], 1)


def nll(log_probs, parts) -> torch.Tensor:
    """Mean NLL of every query point's part."""
    return -log_probs.gather(-1, parts.long()[..., None]).mean()


def train_loss(P, cfg, pts, category, parts, draws, generator, num_crop: int):
    """Loss of one seg PEFT step (train mode, the rectify and completion
    passes over the crop, the head at the augmented whole cloud)."""
    pts = ops.scale_translate(pts, draws["aug_scale"], draws["aug_shift"])
    points = corrupt(pts, draws, num_crop)
    one_hot = F.one_hot(category.long(), LABEL_CLASSES).to(pts.dtype)
    log_probs = SegNet(P, cfg, Draws(generator)).segment(points, one_hot, pts,
                                                          pts.shape[1] - num_crop)
    return nll(log_probs, parts)
