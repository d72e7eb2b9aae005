"""The segmentation models' spans (``upp_torch/models/unify_seg.py``,
``upp_torch/train/runner_seg.py``) on the CPU, at a tiny width: the UPP seg
train step records ``train_step`` over ``rectify``, ``completion``,
``downstream``, ``segment``, ``backward`` and ``optimizer``;
``PointTransformer_seg`` records ``segment``; the recorder on changes no
loss, parameter or gradient; and the completion pass through
``_UnifyCore.complete_cloud`` gives the log-probabilities the former inline
completion and re-sampling gave, bit for bit. No JAX."""

import contextlib
import copy
import types

import numpy as np
import pytest
import torch

from upp_torch.models import build_model_from_cfg
from upp_torch.ops.fps import fps
from upp_torch.ops.group import group_points
from upp_torch.train import optim, runner_seg
from upp_torch.utils import profiling
from upp_torch.utils.config import ConfigDict

BLOCKS = {"mask_ratio": 0.5, "mask_type": "rand", "trans_dim": 48, "encoder_dims": 48,
          "depth": 4, "drop_path_rate": 0.1, "num_heads": 4, "decoder_depth": 2,
          "decoder_num_heads": 4}
SEG_MODEL = {
    "NAME": "Point_MAE_unify_seg", "transformer_config": BLOCKS, "trans_dim": 48,
    "depth": 4, "drop_path_rate": 0.1, "cls_dim": 50, "num_heads": 4, "group_size": 16,
    "num_group": 32, "encoder_dims": 48, "gather_idx": True,
    "prompt_propagation_after": False,
    "prompter_config": {
        "rectify_adapter": True, "rectify_prompts": True, "rectify_prompts_num": 2,
        "rectify_prompts_depth": 2, "rectify_depth": 2,
        "pretask_adapter": True, "pretask_prompts": True, "pretask_prompts_num": 2,
        "pretask_prompts_depth": 3, "pretask_depth": 3,
        "downstream_adapter": True, "downstream_prompts": True,
        "downstream_prompts_num": 1, "downstream_prompts_depth": 2,
        "downstream_depth": 4}}
PT_MODEL = {**SEG_MODEL, "NAME": "PointTransformer_seg"}
N = 128                                  # the dataset's points a cloud
CONFIG = {
    "optimizer": {"type": "AdamW", "kwargs": {"lr": 2e-4, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 4, "initial_epochs": 1}},
    "dataset": {"train": {"_base_": {"NAME": "SyntheticPart", "N_POINTS": N, "SIZE": 4},
                          "others": {"subset": "train"}}},
    "noisy_train": True, "data_augmentation": "scale-translate", "grad_norm_clip": 10,
}
TRAIN_SPANS = ["rectify", "completion", "downstream", "segment", "backward", "optimizer"]


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def model_of(cfg, seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_model_from_cfg(copy.deepcopy(cfg))


def batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.standard_normal((b, N, 3)).astype(np.float32))
    cls = torch.tensor([0, 3][:b])
    seg = torch.from_numpy(rng.integers(0, 4, (b, N)))
    return pts, cls, seg


def train_step():
    config = ConfigDict.from_nested(CONFIG)
    model = model_of(SEG_MODEL)
    optim.set_trainable(model, runner_seg.SEG_PEFT_LIST)
    opt = optim.build_optimizer(config, model, steps_per_epoch=1)
    return model, runner_seg.make_seg_train_step(model, opt, config,
                                                 types.SimpleNamespace(seed=0), unify=True)


def names(unit):
    return [s["name"] for s in unit["spans"]]


def test_seg_train_step_yields_its_spans():
    _, step = train_step()
    with profiling.tracing():
        step(*batch())
    (unit,) = profiling.units()
    assert unit["name"] == "train_step" and names(unit) == TRAIN_SPANS
    assert all(s["parent"] == "train_step" for s in unit["spans"])
    assert sum(s["host_ms"] for s in unit["spans"]) <= unit["host_ms"]


def test_point_transformer_seg_records_its_segment_span():
    model = model_of(PT_MODEL).eval()
    pts, cls, _ = batch()
    with profiling.tracing(), torch.no_grad():
        model(pts, runner_seg.to_categorical(cls))
    assert [u["name"] for u in profiling.units()] == ["segment"]


def test_losses_parameters_and_gradients_are_bit_equal_on_and_off():
    runs = []
    for on in (False, True):
        model, step = train_step()
        with profiling.tracing() if on else contextlib.nullcontext():
            losses = [float(step(*batch(seed=s))["loss"]) for s in (1, 2)]
        runs.append((losses, [p.detach().clone() for p in model.parameters()],
                     [p.grad.clone() for p in model.parameters() if p.grad is not None]))
    assert [u["name"] for u in profiling.units()] == ["train_step", "train_step"]
    (l0, p0, g0), (l1, p1, g1) = runs
    assert l0 == l1 and len(g0) == len(g1) > 0
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def inline_forward(model, pts, one_hot, query, point_num):
    """``PointMAEUnifySeg.forward`` with the completion and re-sampling
    written out as the model held them before it called ``complete_cloud``."""
    pts = model.denoise_pts(pts, point_num)
    _, rebuild = model.complete(pts)
    sample_rebuild, _ = fps(rebuild, point_num // 4)
    pts = torch.cat([pts, sample_rebuild], dim=1)
    if pts.shape[1] > point_num:
        pts, _ = fps(pts, point_num)
    g = group_points(pts, model.num_group, model.group_size)
    _, taps = model.blocks(model.encoder(g.neighborhood), model.pos_embed(g.center),
                           path="downstream", feature_blocks=(3, 7, 11))
    return model._segment(query, g.center, taps, one_hot)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_completion_through_complete_cloud_is_bit_equal(mode):
    model = model_of(SEG_MODEL).train(mode == "train")
    query, cls, _ = batch()
    pts = query[:, :N - N // 4]
    one_hot = runner_seg.to_categorical(cls)
    outs = []
    for fn in (lambda m: m(pts, one_hot, query, completion_prompt=True, denoise=True,
                           point_num=pts.shape[1]),
               lambda m: inline_forward(m, pts, one_hot, query, pts.shape[1])):
        torch.manual_seed(7)                    # the train mode's dropout and drop-path
        with torch.no_grad():
            outs.append(fn(copy.deepcopy(model)))
    assert outs[0].shape == (2, N, 50) and torch.equal(outs[0], outs[1])
