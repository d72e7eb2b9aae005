"""Plain PyTorch reference of UPP's two models, as functions of a weight
dict.

``Point_MAE_unify`` (the classifier) and ``Point_MAE_pretask_dev`` (the
prompter-pretraining model) of the UPP paper (Ren et al., "Unified
Point-Cloud Prompting"), written out from the published architecture: a
12-block ViT over 64 groups of 32 points (Point-MAE), shared by three
passes. The rectify pass (blocks 0-2 with their prompts and adapters) gives
each point a rectification vector through a PointNet++-style head; the
completion pass (blocks 0-5) predicts the missing centres, propagates mask
tokens to them and decodes 32 points a centre through a 4-block decoder;
the downstream pass (12 blocks, prompts in 0-5 with geometry-aware prompt
propagation) classifies. Weight names follow the released ``.pth`` layout
(``param_shapes``), so one seeded weight dict serves both sides.

Departures from the paper's code, all of them its released behaviour kept
as it is: adapters are 32 wide whatever ``adapter_config.adapter_dim``
says; the prompt propagation gathers its neighbours from the flattened,
prompt-augmented batch with offsets of 64 rows a cloud ("quirk"); the
visible-group count is 32 (half of 64).

Train mode draws dropout and drop-path masks from ``Draws``, in the order
the forward meets them. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import ops

LN_EPS, BN_EPS, BN_MOMENTUM = 1e-6, 1e-5, 0.1
PATHS = ("rectify", "pretask", "downstream")
ADAPTER_WIDTH = 32                  # whatever adapter_config.adapter_dim says
PASS_GROUP = 16                     # points a group in the rectify and completion passes
HEAD_GROUPS, HEAD_GROUP = 32, 16    # the rectify head's abstraction


class Draws:
    """The model's Bernoulli masks in train mode, drawn in order from one
    generator as ``empty(shape, float32).bernoulli_(keep)``; ``None`` in
    eval mode."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def mask(self, shape, keep: float, like: torch.Tensor) -> torch.Tensor:
        m = torch.empty(shape, device=like.device, dtype=torch.float32)
        return m.bernoulli_(keep, generator=self.generator).to(like.dtype)


class Net:
    """One model's weights ``P`` (name -> tensor), its layout ``cfg`` (the
    config's ``model`` section) and its mode: ``draws`` set means train
    mode (batch statistics, dropout, drop-path)."""

    def __init__(self, P: Dict[str, torch.Tensor], cfg: dict,
                 draws: Optional[Draws] = None):
        self.P, self.cfg, self.draws = P, cfg, draws
        tc = cfg["transformer_config"]
        self.depth, self.dec_depth = tc["depth"], tc["decoder_depth"]
        self.heads, self.dec_heads = tc["num_heads"], tc["decoder_num_heads"]
        self.rate = tc["drop_path_rate"]
        self.vis = cfg["num_group"] - int(tc["mask_ratio"] * cfg["num_group"])
        pc = cfg["prompter_config"]
        self.run_depth = {p: pc.get(f"{p}_depth") or self.depth for p in PATHS}
        self.run_depth["downstream"] = self.depth
        self.prompt_depth = {p: pc[f"{p}_prompts_depth"] if pc.get(f"{p}_prompts") else 0
                             for p in PATHS}
        self.adapter_len = {"rectify": pc["rectify_depth"] if pc.get("rectify_adapter") else 0,
                            "pretask": pc["pretask_depth"] if pc.get("pretask_adapter") else 0,
                            "downstream": self.depth if pc.get("downstream_adapter") else 0}

    # -- layers ---------------------------------------------------------------
    @property
    def training(self) -> bool:
        return self.draws is not None

    def linear(self, x, name):
        w = self.P[name + ".weight"]
        return F.linear(x, w.reshape(w.shape[0], -1), self.P.get(name + ".bias"))

    def ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.P[name + ".weight"],
                            self.P[name + ".bias"], LN_EPS)

    def bn(self, x, name):
        """BatchNorm over every axis but the last."""
        flat = x.reshape(-1, x.shape[-1])
        y = F.batch_norm(flat, self.P[name + ".running_mean"], self.P[name + ".running_var"],
                         self.P[name + ".weight"], self.P[name + ".bias"], self.training,
                         BN_MOMENTUM, BN_EPS)
        return y.reshape(x.shape)

    def dropout(self, x, p):
        if not self.training:
            return x
        return x * self.draws.mask(x.shape, 1.0 - p, x) / (1.0 - p)

    def drop_path(self, x, rate):
        if rate == 0.0 or not self.training:
            return x
        keep = 1.0 - rate
        return x / keep * self.draws.mask((x.shape[0],) + (1,) * (x.dim() - 1), keep, x)

    def mlp2(self, x, name):
        """Linear -> GELU -> Linear (``name.0``, ``name.2``)."""
        return self.linear(F.gelu(self.linear(x, name + ".0")), name + ".2")

    # -- transformer ----------------------------------------------------------
    def attention(self, x, name, heads):
        B, N, C = x.shape
        hd = C // heads
        qkv = self.linear(x, name + ".qkv").reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax(q @ k.transpose(-2, -1) * hd ** -0.5, dim=-1)
        return self.linear((attn @ v).transpose(1, 2).reshape(B, N, C), name + ".proj")

    def adapter(self, x, name):
        h = self.dropout(F.gelu(self.linear(self.ln(x, name + ".layer_norm"), name + ".ln1")), 0.1)
        return self.linear(h, name + ".ln2") * 0.7

    def block(self, x, pos, name, rate, heads, path, prompted, adapter,
              cls=False, prop=None):
        x = x + pos
        n_prompts = 0
        if prompted:
            ptok = self.P[f"{name}.{path}_prompts"]
            n_prompts = ptok.shape[0]
            ptok = ptok[None].expand(x.shape[0], -1, -1)
            x = torch.cat([x[:, :1], ptok, x[:, 1:]], 1) if cls else torch.cat([ptok, x], 1)
        x = x + self.drop_path(self.attention(self.ln(x, name + ".norm1"), name + ".attn", heads),
                               rate)
        h = self.linear(F.gelu(self.linear(self.ln(x, name + ".norm2"), name + ".mlp.fc1")),
                        name + ".mlp.fc2")
        x = x + self.drop_path(h, rate)
        if prompted and prop is not None:
            x = self.propagate_prompts(x, name, rate, prop)
        if prompted:
            x = torch.cat([x[:, :1], x[:, n_prompts + 1:]], 1) if cls else x[:, n_prompts:]
        if adapter:
            x = x + self.adapter(x, f"{name}.{path}_adapter")
        return x

    def propagate_prompts(self, x, name, rate, prop):
        """Geometry-aware prompt propagation of the classifier: the released
        gather from the flattened prompt-augmented batch, offsets of g rows
        a cloud."""
        B, _, C = x.shape
        body = x[:, 1:]
        g = prop["center1"].shape[1]
        tokens, prefix = body[:, -g:], body[:, :-g]
        n_idx, c_idx = prop["center1_idx"], prop["center2_idx"]
        g2, k = n_idx.shape[1], n_idx.shape[2]
        flat = body.reshape(-1, C)
        off = (torch.arange(B, device=x.device) * g)[:, None, None]
        neigh = flat[(n_idx + off).reshape(-1)].reshape(B, g2, k, C)
        centers = flat[(c_idx + off[:, :, 0]).reshape(-1)].reshape(B, g2, C)
        neigh = self.drop_path(neigh, rate) + neigh
        pooled = self.bn(neigh, name + ".bnorm").amax(2)
        centers = pooled + 0.3 * centers
        tokens = tokens + 0.3 * ops.interpolate(prop["center1"], prop["center2"], centers,
                                                k=8, eps=1e-3)
        return torch.cat([x[:, :1], prefix, tokens], 1)

    def backbone(self, x, pos, path, cls=False, prop=None):
        depth = self.run_depth[path]
        prompt_depth = min(self.prompt_depth[path], depth)
        segments = [(0, prompt_depth, True), (prompt_depth, depth, False)] if prompt_depth \
            else [(0, depth, False)]
        for lo, hi, prompted in segments:
            adapter = self.adapter_len[path] >= hi
            for i in range(lo, hi):
                x = self.block(x, pos, f"blocks.blocks.{i}", self.rate * i / max(self.depth - 1, 1),
                               self.heads, path, prompted, adapter, cls, prop)
        return x

    def decoder(self, x, pos, n_last):
        for i in range(self.dec_depth):
            x = self.block(x, pos, f"MAE_decoder.blocks.{i}",
                           self.rate * i / max(self.dec_depth - 1, 1), self.dec_heads,
                           "pretask", False, True)
        return self.ln(x[:, -n_last:], "MAE_decoder.norm")

    def encoder(self, groups):
        """Mini-PointNet tokens [B, G, C] of neighbourhoods [B, G, n, 3]."""
        bs, g, n, _ = groups.shape
        x = self.linear(groups.reshape(bs * g * n, 3), "encoder.first_conv.0")
        x = F.relu(self.bn(x, "encoder.first_conv.1"))
        x = self.linear(x, "encoder.first_conv.3").reshape(bs * g, n, 256)
        x = torch.cat([x.amax(1, keepdim=True).expand(-1, n, -1), x], -1).reshape(bs * g * n, 512)
        x = self.bn(self.linear(x, "encoder.second_conv.0"), "encoder.second_conv.1")
        x = self.linear(F.relu(x), "encoder.second_conv.3")
        C = x.shape[-1]
        return x.reshape(bs * g, n, C).amax(1).reshape(bs, g, C)

    # -- the three passes ------------------------------------------------------
    def rectify_vectors(self, pts):
        nbr, center, _, _ = ops.group(pts, self.vis, PASS_GROUP)
        tokens = self.backbone(self.encoder(nbr), self.mlp2(center, "pos_embed"), "rectify")
        return self.rectify_head(pts, center, tokens)

    def rectify_head(self, x, center1, feats):
        name = "rectify_prompter"
        _, center2, idx, _ = ops.group(center1.float(), HEAD_GROUPS, HEAD_GROUP)
        h = ops.gather(feats, idx)
        for i in range(3):
            h = F.relu(self.bn(self.linear(h, f"{name}.abstraction.mlp_convs.{i}"),
                               f"{name}.abstraction.mlp_bns.{i}"))
        h = h.amax(2)
        c1 = ops.interpolate(center1, center2, h, k=16, eps=1e-4)
        for i in range(2):
            c1 = F.relu(self.bn(self.linear(c1, f"{name}.propagation2.mlp_convs.{i}"),
                                f"{name}.propagation2.mlp_bns.{i}"))
        f = torch.cat([ops.positional_embedding(x, 4),
                       ops.interpolate(x, center1, c1, k=16, eps=1e-4)], -1)
        for i in range(2):
            f = F.relu(self.bn(self.linear(f, f"{name}.propagation1.mlp_convs.{i}"),
                               f"{name}.propagation1.mlp_bns.{i}"))
        f = self.dropout(F.relu(self.linear(f, f"{name}.score_head.0")), 0.2)
        return self.linear(f, f"{name}.score_head.3")

    def complete(self, pts):
        """(predicted missing centres [B, M, 3], rebuilt points [B, M*S, 3])."""
        nbr, center, _, _ = ops.group(pts, self.vis, PASS_GROUP)
        x = self.backbone(self.encoder(nbr), self.mlp2(center, "pos_embed"), "pretask")
        x = self.ln(x, "norm")
        B = x.shape[0]
        shape_feature = self.mlp2(x, "shape_pred").reshape(B, -1)
        pred_center = self.mlp2(shape_feature, "coarse_pred").reshape(B, -1, 3)
        pred_token = self.mlp2(x, "predict_token_generator")
        M = pred_center.shape[1]
        mask_token = self.P["mask_token"].expand(B, M, -1)
        mask_token = mask_token + 0.3 * ops.interpolate(pred_center, center, pred_token,
                                                        k=6, eps=1e-8)
        x_full = torch.cat([x, mask_token], 1)
        pos = torch.cat([self.mlp2(center, "decoder_pos_embed"),
                         self.mlp2(pred_center, "decoder_pos_embed")], 1)
        x_rec = self.decoder(x_full, pos, M)
        S = self.cfg["group_size"]
        rel = self.linear(x_rec, "dense_pred.0").reshape(B, M, S, 3)
        return pred_center, (rel + pred_center[:, :, None, :]).reshape(B, -1, 3)

    def classify(self, pts, point_num: int, robust: bool = True):
        """Logits [B, cls_dim]; ``robust`` runs the rectify pass (dropping
        the 5% noisiest points) and the completion pass first."""
        if robust:
            vec = self.rectify_vectors(pts)
            order = torch.argsort(-torch.linalg.norm(vec, dim=-1), dim=1, stable=True)
            keep = order[:, -int(point_num * 0.95):]
            pts = ops.gather(pts + 0.2 * vec, keep)
            _, rebuild = self.complete(pts)
            pts = torch.cat([pts, ops.fps(rebuild, point_num // 4)[0]], 1)
            if pts.shape[1] > point_num:
                pts = ops.fps(pts, point_num)[0]
        G, S = self.cfg["num_group"], self.cfg["group_size"]
        nbr, center, _, _ = ops.group(pts, G, S)
        tokens = self.encoder(nbr)
        B = tokens.shape[0]
        pos = torch.cat([self.P["cls_pos"].expand(B, -1, -1), self.mlp2(center, "pos_embed")], 1)
        x = torch.cat([self.P["cls_token"].expand(B, -1, -1), tokens], 1)
        _, center2, idx2, cidx2 = ops.group(center, G // 2, 8)
        prop = {"center1": center, "center1_idx": idx2, "center2": center2,
                "center2_idx": cidx2}
        x = self.ln(self.backbone(x, pos, "downstream", cls=True, prop=prop), "norm")
        h = torch.cat([x[:, 0], x[:, 1:].amax(1)], -1)
        for lin, bn in ((0, 1), (4, 5)):
            h = self.dropout(F.relu(self.bn(self.linear(h, f"cls_head_finetune.{lin}"),
                                            f"cls_head_finetune.{bn}")), 0.5)
        return self.linear(h, "cls_head_finetune.8")


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Name -> shape of every weight and BatchNorm buffer of the model that
    ``cfg`` (a config's ``model`` section) describes, in the released
    ``.pth`` layout: the classifier (``Point_MAE_unify``) where it names
    ``cls_dim``, else the prompter-pretraining model."""
    tc, pc = cfg["transformer_config"], cfg["prompter_config"]
    C, depth, dec = tc["trans_dim"], tc["depth"], tc["decoder_depth"]
    G, S = cfg["num_group"], cfg["group_size"]
    vis = G - int(tc["mask_ratio"] * G)
    out: Dict[str, tuple] = {}

    def lin(name, i, o, bias=True, conv=0):
        out[name + ".weight"] = (o, i) + (1,) * conv
        if bias:
            out[name + ".bias"] = (o,)

    def bn(name, c):
        out.update({name + ".weight": (c,), name + ".bias": (c,), name + ".running_mean": (c,),
                    name + ".running_var": (c,), name + ".num_batches_tracked": ()})

    def head(name, i, h, o):
        lin(name + ".0", i, h)
        lin(name + ".2", h, o)

    def block(name, adapters, prompts):
        for p, n in prompts.items():
            out[f"{name}.{p}_prompts"] = (n, C)
        out[name + ".norm1.weight"] = out[name + ".norm1.bias"] = (C,)
        lin(name + ".attn.qkv", C, 3 * C, bias=False)
        lin(name + ".attn.proj", C, C)
        out[name + ".norm2.weight"] = out[name + ".norm2.bias"] = (C,)
        lin(name + ".mlp.fc1", C, 4 * C)
        lin(name + ".mlp.fc2", 4 * C, C)
        bn(name + ".bnorm", C)
        for p in adapters:
            a = f"{name}.{p}_adapter"
            out[a + ".layer_norm.weight"] = out[a + ".layer_norm.bias"] = (C,)
            lin(a + ".ln1", C, ADAPTER_WIDTH)
            lin(a + ".ln2", ADAPTER_WIDTH, C)

    out["mask_token"] = (1, 1, C)
    if "cls_dim" in cfg:                # the classifier
        out["cls_token"] = out["cls_pos"] = (1, 1, C)
    lin("encoder.first_conv.0", 3, 128, conv=1)
    bn("encoder.first_conv.1", 128)
    lin("encoder.first_conv.3", 128, 256, conv=1)
    lin("encoder.second_conv.0", 512, 512, conv=1)
    bn("encoder.second_conv.1", 512)
    lin("encoder.second_conv.3", 512, tc["encoder_dims"], conv=1)
    head("pos_embed", 3, 128, C)
    alen = {"rectify": pc["rectify_depth"] if pc.get("rectify_adapter") else 0,
            "pretask": pc["pretask_depth"] if pc.get("pretask_adapter") else 0,
            "downstream": depth if pc.get("downstream_adapter") else 0}
    plen = {p: pc[f"{p}_prompts_depth"] if pc.get(f"{p}_prompts") else 0 for p in PATHS}
    for i in range(depth):
        block(f"blocks.blocks.{i}", [p for p in PATHS if i < alen[p]],
              {p: pc[f"{p}_prompts_num"] for p in PATHS if i < plen[p]})
    out["norm.weight"] = out["norm.bias"] = (C,)
    head("shape_pred", C, C // 2, 16)
    head("coarse_pred", 16 * vis, C, 3 * (G - vis))
    head("predict_token_generator", C, 128, C)
    head("decoder_pos_embed", 3, 128, C)
    for i in range(dec):
        block(f"MAE_decoder.blocks.{i}", ["pretask"], {})
    out["MAE_decoder.norm.weight"] = out["MAE_decoder.norm.bias"] = (C,)
    lin("dense_pred.0", C, 3 * S, conv=1)
    r = "rectify_prompter"
    for i, (a, b) in enumerate(((C, 64), (64, 32), (32, 12))):
        lin(f"{r}.abstraction.mlp_convs.{i}", a, b, conv=2)
        bn(f"{r}.abstraction.mlp_bns.{i}", b)
    for i, (a, b) in enumerate(((12, 64), (64, 32))):
        lin(f"{r}.propagation2.mlp_convs.{i}", a, b, conv=1)
        bn(f"{r}.propagation2.mlp_bns.{i}", b)
    for i, (a, b) in enumerate(((27 + 32, 32), (32, 32))):
        lin(f"{r}.propagation1.mlp_convs.{i}", a, b, conv=1)
        bn(f"{r}.propagation1.mlp_bns.{i}", b)
    lin(f"{r}.score_head.0", 32, 64, conv=1)
    lin(f"{r}.score_head.3", 64, 3, conv=1)
    if "cls_dim" in cfg:                # the classifier
        lin("cls_head_finetune.0", 2 * C, 256)
        bn("cls_head_finetune.1", 256)
        lin("cls_head_finetune.4", 256, 256)
        bn("cls_head_finetune.5", 256)
        lin("cls_head_finetune.8", 256, cfg["cls_dim"])
    return out
