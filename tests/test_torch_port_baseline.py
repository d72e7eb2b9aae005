"""The port's baseline models (``upp_torch.models.baseline``: ``Point_MAE``
and ``PointTransformer``) against the JAX package on CPU, at a small size
(trans_dim 48, depth 3, decoder depth 2, 16 groups of 8, 128 points), with
weights moved by ``upp_torch.weights``; and the pretrain checkpoint's load
into ``PointTransformer``, the reference's fine-tune recipe. Inputs are
numpy draws from a seed; the JAX ``Point_MAE`` gets the port's group split
by a patch of its ``_rand_mask_idx``. Every comparison holds at rtol = atol
= 1e-4 (``test_torch_port_model.TOL``); train mode runs at batch 4,
drop-path and dropout off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_port_model import TOL, build_pair
from upp_tpu.models import baseline as j_baseline
from upp_tpu.train.ckpt_io import load_weights as j_load_weights
from upp_tpu.train.torch_export import export_torch_state_dict
from upp_torch.models import build_model_from_cfg
from upp_torch.train import checkpoint, ckpt_io, optim
from upp_torch.utils.config import ConfigDict
from upp_torch.weights import state_dict_from_jax

_TC = {"mask_ratio": 0.6, "mask_type": "rand", "trans_dim": 48, "encoder_dims": 48,
       "depth": 3, "drop_path_rate": 0.0, "num_heads": 4, "decoder_depth": 2,
       "decoder_num_heads": 4}
MAE_SMALL = {"NAME": "Point_MAE", "group_size": 8, "num_group": 16, "loss": "cdl2",
             "transformer_config": _TC}
PT_SMALL = {"NAME": "PointTransformer", "trans_dim": 48, "depth": 3, "drop_path_rate": 0.0,
            "cls_dim": 5, "num_heads": 4, "group_size": 8, "num_group": 16,
            "encoder_dims": 48}
N_PTS = 128
B = 4
NUM_MASK = int(0.6 * 16)
BACKBONE = ("encoder.", "pos_embed.", "blocks.", "norm.")


def mae_pair(cfg=MAE_SMALL, seed=41):
    return build_pair(cfg, None, N_PTS, seed=seed, deterministic=True)


@pytest.fixture(scope="module")
def pair():
    return mae_pair()


@pytest.fixture(scope="module")
def pt_pair():
    return build_pair(PT_SMALL, None, N_PTS, seed=42, deterministic=True)


def _pts(seed, b=B, n=N_PTS):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


def _masks(seed, b=B, g=16):
    """A per-sample random split of the groups: (visible, masked) int32."""
    perm = np.stack([np.random.default_rng(seed + i).permutation(g) for i in range(b)])
    return perm[:, :g - NUM_MASK].astype(np.int32), perm[:, g - NUM_MASK:].astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _jax_no_dropout(mp):
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


@pytest.mark.parametrize("which", ["Point_MAE", "PointTransformer"])
def test_weights_match_torch_export(pair, pt_pair, which):
    """``state_dict_from_jax`` equals the JAX package's template-driven
    exporter key for key and value for value, loads strictly, and the plain
    stacks carry no prompt, adapter or ``bnorm`` tensor."""
    _, variables, tm = pair if which == "Point_MAE" else pt_pair
    mine = state_dict_from_jax(variables, tm)
    theirs, report = export_torch_state_dict(variables, template=tm)
    assert report["missing"] == []
    assert all(k.endswith("num_batches_tracked") for k in report["synthesized"])
    assert set(mine) == set(theirs) == set(tm.state_dict())
    assert not [k for k in mine if "prompts" in k or "adapter" in k or "bnorm" in k]
    if which == "Point_MAE":
        assert {k.split(".")[0] for k in mine} == {
            "MAE_encoder", "MAE_decoder", "decoder_pos_embed", "increase_dim", "mask_token"}
        assert "increase_dim.0.weight" in mine and "MAE_encoder.blocks.blocks.2.mlp.fc2.bias" in mine
    for k, v in mine.items():
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
    tm.load_state_dict({k: torch.tensor(v) for k, v in theirs.items()}, strict=True)


def _running(model):
    return {k: v for k, v in model.state_dict().items() if k.endswith(("running_mean",
                                                                      "running_var"))}


@pytest.mark.parametrize("loss", ["cdl2", "cdl1"])
def test_point_mae_loss_and_bn_statistics_match_jax(loss, monkeypatch):
    """The train-mode loss on a given group split and the encoder's updated
    BatchNorm running statistics: every group enters both BatchNorms, the
    visible ones alone go on (the encoder-BN masked-group coupling)."""
    jm, variables, tm = mae_pair({**MAE_SMALL, "loss": loss}, seed=43)
    pts = _pts(5)
    vis, mask = _masks(6)
    monkeypatch.setattr(j_baseline.PointMAE, "_rand_mask_idx",
                        lambda self, b: (jnp.asarray(vis), jnp.asarray(mask)))
    want, mut = jm.apply(variables, jnp.asarray(pts), deterministic=False,
                         rngs={"dropout": jax.random.key(1), "droppath": jax.random.key(2)},
                         mutable=["batch_stats"])
    tm.train()
    got = tm(torch.tensor(pts), masks=(torch.tensor(vis).long(), torch.tensor(mask).long()))
    _close(got, want)
    want_stats = state_dict_from_jax({"params": variables["params"],
                                      "batch_stats": mut["batch_stats"]}, tm)
    running = _running(tm)
    assert len(running) == 4
    for k, v in running.items():
        _close(v, want_stats[k].numpy())
        assert not torch.equal(v, torch.tensor(
            state_dict_from_jax(variables, tm)[k].numpy())), k     # updated


def test_eval_features_match_jax(pair):
    """The SVM probe's features: all groups, running statistics, the max
    over ``norm(x)``."""
    jm, variables, tm = pair
    pts = _pts(7)
    want = jm.apply(variables, jnp.asarray(pts), eval_features=True, deterministic=True)
    with torch.no_grad():
        got = tm.eval()(torch.tensor(pts), eval_features=True)
    assert got.shape == (B, 48)
    _close(got, want)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_point_transformer_logits_match_jax(pt_pair, mode, monkeypatch):
    """``PointTransformer``'s logits (train mode: batch statistics, dropout
    off) and, in train mode, its updated BatchNorm statistics; the
    classifier runners' prompt keywords are ignored."""
    jm, variables, tm = pt_pair
    pts = _pts(8)
    train = mode == "train"
    _jax_no_dropout(monkeypatch)
    out = jm.apply(variables, jnp.asarray(pts), deterministic=not train,
                   rngs={"dropout": jax.random.key(1), "droppath": jax.random.key(2)},
                   mutable=["batch_stats"] if train else False,
                   completion_prompt=True, denoise=True, point_num=N_PTS)
    want = out[0] if train else out
    model = _no_dropout(build_model_from_cfg(PT_SMALL))
    model.load_state_dict(tm.state_dict())
    model.train(train)
    with torch.no_grad():
        got = model(torch.tensor(pts), completion_prompt=True, denoise=True, point_num=N_PTS)
    _close(got, want)
    if train:
        want_stats = state_dict_from_jax({"params": variables["params"],
                                          "batch_stats": out[1]["batch_stats"]}, tm)
        for k, v in _running(model).items():
            _close(v, want_stats[k].numpy())


def test_pretrain_pth_loads_into_point_transformer(pair, pt_pair, tmp_path):
    """A port ``Point_MAE`` checkpoint loads into the port's
    ``PointTransformer`` (``MAE_encoder.`` stripped) missing only the cls
    tokens and head, with only the decoder side unexpected; and into the
    JAX ``PointTransformer`` with the same backbone tensors."""
    _, _, mae = pair
    jpt, jvars, _ = pt_pair
    opt = optim.build_optimizer(ConfigDict.from_nested({
        "optimizer": {"type": "AdamW", "kwargs": {"lr": 1e-3, "weight_decay": 0.05}},
        "scheduler": {"type": "CosLR", "kwargs": {"epochs": 2, "initial_epochs": 1}}}),
        mae, steps_per_epoch=1)
    path = checkpoint.save_checkpoint(mae, opt, 0, "ckpt-last", str(tmp_path))
    model = build_model_from_cfg(PT_SMALL)
    missing, unexpected = ckpt_io.load_weights(model, path)
    assert {k.split(".")[0] for k in missing} == {"cls_token", "cls_pos", "cls_head_finetune"}
    assert {k.split(".")[0] for k in unexpected} == {
        "MAE_decoder", "decoder_pos_embed", "increase_dim", "mask_token"}
    src = {k.removeprefix("MAE_encoder."): v for k, v in mae.state_dict().items()}
    loaded = model.state_dict()
    backbone = [k for k in loaded if k.startswith(BACKBONE)]
    assert len(backbone) == len([k for k in src if k.startswith(BACKBONE)]) > 40
    j_vars, j_missing, _ = j_load_weights(jvars, path)
    assert {k.split("/")[0] for k in j_missing} == {"cls_token", "cls_pos", "cls_head_finetune"}
    j_state = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_vars), model)
    for k in backbone:
        assert torch.equal(loaded[k], src[k]), k
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(j_state[k].numpy(), src[k].numpy(), err_msg=k)


def test_mask_draw_and_drop_path_follow_the_generator():
    """The group split is a per-sample permutation, visible first (38 of 64
    masked at ratio 0.6), drawn from the generator, as drop-path is: the
    same seed gives the same train-mode loss, another seed another."""
    cfg = {**MAE_SMALL, "transformer_config": {**_TC, "drop_path_rate": 0.3}}
    torch.manual_seed(0)
    model = build_model_from_cfg(cfg).train()
    vis, mask = model.rand_mask_idx(B, torch.device("cpu"), torch.Generator().manual_seed(1))
    assert vis.shape == (B, 16 - NUM_MASK) and mask.shape == (B, NUM_MASK)
    assert (torch.sort(torch.cat([vis, mask], 1), 1).values == torch.arange(16)).all()
    pts = torch.tensor(_pts(9))
    with torch.no_grad():
        loss = [float(model(pts, generator=torch.Generator().manual_seed(s))) for s in (3, 3, 4)]
    assert loss[0] == loss[1] != loss[2]
    full = build_model_from_cfg({**MAE_SMALL, "num_group": 64})
    assert full.rand_mask_idx(2, torch.device("cpu"))[1].shape == (2, 38)
