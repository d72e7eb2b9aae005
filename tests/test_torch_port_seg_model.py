"""The port's segmentation models (``upp_torch.models.unify_seg``) against
the JAX package on CPU, at a small size (trans_dim 48, depth 12 so that the
taps after blocks 3, 7 and 11 exist, at most 512 points), with weights moved
by ``upp_torch.weights``; the raw viewpoint crop; the seg loss and the mIoU
suite. Inputs are numpy draws from a seed. Every comparison holds at
rtol = atol = 1e-4 unless it says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_model import TOL, build_pair
from upp_tpu.data.partnormal import SEG_CLASSES
from upp_tpu.ops.corrupt import separate_point_cloud as j_separate
from upp_tpu.train.metrics import nll_seg_loss as j_nll
from upp_tpu.train.metrics import seg_miou_metrics as j_miou
from upp_tpu.train.torch_export import export_torch_state_dict
from upp_torch.data.partnormal import SEG_CLASSES as T_SEG_CLASSES
from upp_torch.ops.corrupt import separate_point_cloud
from upp_torch.train.metrics import nll_seg_loss, seg_miou_metrics
from upp_torch.weights import state_dict_from_jax

_TC = {"mask_ratio": 0.5, "mask_type": "rand", "trans_dim": 48, "encoder_dims": 48,
       "depth": 12, "drop_path_rate": 0.1, "num_heads": 4, "decoder_depth": 2,
       "decoder_num_heads": 4}
SEG_SMALL = {
    "NAME": "Point_MAE_unify_seg", "transformer_config": _TC,
    "trans_dim": 48, "depth": 12, "drop_path_rate": 0.1, "cls_dim": 50, "num_heads": 4,
    "group_size": 16, "num_group": 32, "encoder_dims": 48,
    "prompter_config": {
        "rectify_adapter": True, "rectify_prompts": True,
        "rectify_prompts_num": 2, "rectify_prompts_depth": 2, "rectify_depth": 2,
        "pretask_adapter": True, "pretask_prompts": True,
        "pretask_prompts_num": 2, "pretask_prompts_depth": 3, "pretask_depth": 3,
        "downstream_adapter": True, "downstream_prompts": True,
        "downstream_prompts_num": 1, "downstream_prompts_depth": 6,
        "downstream_depth": 12},
    "gather_idx": True, "prompt_propagation_after": False,
}
PT_SMALL = {**SEG_SMALL, "NAME": "PointTransformer_seg"}
N_FULL = 256                         # query points (the dataset's N_POINTS)
P_IN = N_FULL - N_FULL // 4 + 24 + 64  # cropped, + shell and lidar points


def seg_inputs(b=2, n=N_FULL, p=P_IN):
    """Zero inputs of the JAX seg models' init: clouds, one-hot, queries."""
    return (jnp.zeros((b, p, 3)), jnp.zeros((b, 16)), jnp.zeros((b, n, 3)))


def seg_pair(cfg, seed):
    kw = (dict(completion_prompt=True, denoise=True, deterministic=True)
          if cfg["NAME"] == "Point_MAE_unify_seg" else dict(deterministic=True))
    return build_pair(cfg, P_IN, P_IN, seed=seed, inputs=seg_inputs(), **kw)


@pytest.fixture(scope="module")
def pair():
    return seg_pair(SEG_SMALL, 21)


@pytest.fixture(scope="module")
def pt_pair():
    return seg_pair(PT_SMALL, 22)


def _pts(n, seed, b=2):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


def _one_hot(labels):
    return np.eye(16, dtype=np.float32)[np.asarray(labels)]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("which", ["unify_seg", "transformer_seg"])
def test_weights_match_torch_export(pair, pt_pair, which):
    """``state_dict_from_jax`` equals the JAX package's template-driven
    exporter key for key and value for value, and loads strictly."""
    _, variables, tm = pair if which == "unify_seg" else pt_pair
    mine = state_dict_from_jax(variables, tm)
    theirs, report = export_torch_state_dict(variables, template=tm)
    assert report["missing"] == []
    assert all(k.endswith("num_batches_tracked") for k in report["synthesized"])
    assert set(mine) == set(theirs) == set(tm.state_dict())
    for fam in ("label_conv.", "propagation_0.", "seg_head.0.weight"):
        assert any(k.startswith(fam) for k in mine), fam
    for k, v in mine.items():
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
    tm.load_state_dict({k: torch.tensor(v) for k, v in theirs.items()}, strict=True)


def test_block_taps_and_existing_passes(pair):
    """The downstream pass's taps after blocks 3, 7 and 11 equal JAX's
    ``feature_blocks``, and the pass without taps is bit-identical to the
    final output of the pass with them."""
    jm, variables, tm = pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 48)).astype(np.float32)
    pos = rng.standard_normal((2, 32, 48)).astype(np.float32)
    want_x, want_taps = jm.apply(variables, jnp.asarray(x), jnp.asarray(pos), method=lambda m, a, b: (
        m.core.blocks(a, b, path="downstream", deterministic=True, feature_blocks=(3, 7, 11))))
    with torch.no_grad():
        got_x, taps = tm.blocks(torch.tensor(x), torch.tensor(pos), path="downstream",
                                feature_blocks=(3, 7, 11))
        plain = tm.blocks(torch.tensor(x), torch.tensor(pos), path="downstream")
    assert len(taps) == len(want_taps) == 3
    for got, want in zip([got_x, *taps], [want_x, *want_taps]):
        _close(got, want)
    assert torch.equal(plain, got_x)


def test_none_path(pt_pair):
    """``path="none"``: every block, no prompts and no adapters (the
    PointTransformer_seg stack), with its taps, against JAX."""
    jm, variables, tm = pt_pair
    assert not any("prompts" in n or "adapter" in n for n, _ in tm.blocks.named_parameters())
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 48)).astype(np.float32)
    pos = rng.standard_normal((2, 32, 48)).astype(np.float32)
    want_x, want_taps = jm.apply(variables, jnp.asarray(x), jnp.asarray(pos), method=lambda m, a, b: (
        m.blocks(a, b, path="none", deterministic=True, feature_blocks=(3, 7, 11))))
    with torch.no_grad():
        got_x, taps = tm.blocks(torch.tensor(x), torch.tensor(pos), path="none",
                                feature_blocks=(3, 7, 11))
    for got, want in zip([got_x, *taps], [want_x, *want_taps]):
        _close(got, want)


def test_label_conv(pair):
    jm, variables, tm = pair
    one_hot = _one_hot([3, 0])
    want = jm.apply(variables, jnp.asarray(one_hot),
                    method=lambda m, a: m.label_conv(a, deterministic=True))
    with torch.no_grad():
        _close(tm.label_conv(torch.tensor(one_hot)), want)


def test_seg_head_split_product(pair):
    """``SegHead`` against JAX's (``_SplitDense``), and its split product
    against the reference's product over the per-cloud row repeated over
    every point (rtol 1e-5, atol 1e-5)."""
    jm, variables, tm = pair
    rng = np.random.default_rng(5)
    f0 = rng.standard_normal((2, 64, 1024)).astype(np.float32)
    glob = rng.standard_normal((2, 6 * 48 + 128)).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(f0), jnp.asarray(glob),
                    method=lambda m, a, b: m.seg_head(a, b, deterministic=True))
    conv = tm.seg_head[0]
    with torch.no_grad():
        got = tm.seg_head(torch.tensor(f0), torch.tensor(glob))
        split = conv(torch.tensor(f0), torch.tensor(glob))
        fused = torch.cat([torch.tensor(f0), torch.tensor(glob)[:, None].expand(-1, 64, -1)], -1)
        whole = torch.nn.functional.linear(fused, conv.weight[..., 0], conv.bias)
    _close(got, want)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.exp().sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("which,k", [("unify_seg", 3), ("transformer_seg", 5)])
def test_feature_propagation(pair, pt_pair, which, k):
    """``propagation_0``: k-nearest inverse-distance interpolation of 32
    group features onto 256 query points, concatenated with the queries'
    xyz, then two conv-BN-ReLU layers."""
    jm, variables, tm = pair if which == "unify_seg" else pt_pair
    assert tm.propagation_0.interpolate_neighbors == k
    query = _pts(N_FULL, 6)
    center = query[:, :32] * 0.9
    feats = np.random.default_rng(7).standard_normal((2, 32, 3 * 48)).astype(np.float32)
    want = jm.apply(variables, *map(jnp.asarray, (query, center, feats)),
                    method=lambda m, q, c, f: m.propagation_0(q, c, q, f,
                                                              use_running_average=True))
    with torch.no_grad():
        got = tm.propagation_0(*map(torch.tensor, (query, center, query, feats)))
    assert got.shape == (2, N_FULL, 1024)
    _close(got, want)


@pytest.mark.parametrize("mode", ["downstream", "three_pass", "propagation_after",
                                  "transformer_seg"])
def test_seg_forward_eval(pair, pt_pair, mode):
    """Both seg models' forward in eval mode on the same clouds, labels and
    query points: log-probabilities, and the argmax wherever the top two
    differ by more than 1e-3. The UPP model with its downstream pass alone,
    through the rectify and completion passes, and with the prompt
    propagation after the prompted blocks (the reference's per-sample
    gather into the prompt-augmented tokens)."""
    if mode == "propagation_after":
        jm, variables, tm = seg_pair({**SEG_SMALL, "prompt_propagation_after": True}, 23)
    else:
        jm, variables, tm = pt_pair if mode == "transformer_seg" else pair
    query = _pts(N_FULL, 8)
    one_hot = _one_hot([1, 3])
    if mode == "transformer_seg":
        pts, kw = query, {}
    else:
        three = mode != "downstream"
        pts = _pts(P_IN if three else N_FULL, 9)
        kw = dict(completion_prompt=three, denoise=three,
                  point_num=P_IN if three else N_FULL)
    want = np.asarray(jm.apply(variables, *map(jnp.asarray, (pts, one_hot, query)),
                               deterministic=True, **kw))
    with torch.no_grad():
        got = tm(*map(torch.tensor, (pts, one_hot, query)), **kw).numpy()
    assert got.shape == (2, N_FULL, 50)
    np.testing.assert_allclose(got, want, **TOL)
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3
    assert clear.mean() > 0.9
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()


def tie_grid(b, n, seed):
    """[b, n, 3] points of the grid of multiples of 1/4 in [-1, 1], half of
    them repeats: many repeated distances to any viewpoint."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-4, 5, (b, n // 2, 3)) / 4.0
    reps = np.take_along_axis(base, rng.integers(0, n // 2, (b, n - n // 2, 1)), 1)
    cloud = np.concatenate([base, reps], 1)
    return np.stack([c[rng.permutation(n)] for c in cloud]).astype(np.float32)


@pytest.mark.parametrize("clouds", ["random", "grid"])
def test_raw_crop_matches_jax(clouds):
    """``separate_point_cloud(resample=False)``: the points sorted by their
    distance to the viewpoint, ties in index order as JAX's stable argsort,
    split at ``num_crop``; exactly equal to JAX's on random clouds and on
    grid clouds full of repeated distances, with one viewpoint for the batch
    and with JAX's per-sample random viewpoints."""
    pts = _pts(N_FULL, 10, b=3) if clouds == "random" else tie_grid(3, N_FULL, 10)
    num_crop = N_FULL // 4
    vp = np.array([0.0, 0.0, 1.0], np.float32) if clouds == "grid" else \
        np.array([0.6, -0.8, 0.0], np.float32)
    want = j_separate(jax.random.key(0), jnp.asarray(pts), num_crop,
                      fixed_viewpoint=jnp.asarray(vp), resample=False)
    got = separate_point_cloud(torch.tensor(pts), num_crop, viewpoint=torch.tensor(vp),
                               resample=False)
    d = ((pts - vp) ** 2).sum(-1)
    assert clouds == "random" or len(np.unique(d[0])) < N_FULL // 4   # real ties
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (3, N_FULL - num_crop, 3) and got[1].shape == (3, num_crop, 3)

    key = jax.random.key(5)
    v = jnp.stack([jax.random.normal(k, (3,), jnp.float32)
                   for k in jax.random.split(key, 3)])
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    want = j_separate(key, jnp.asarray(pts), num_crop, resample=False)
    got = separate_point_cloud(torch.tensor(pts), num_crop,
                               viewpoint=torch.tensor(np.asarray(v)), resample=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nll_seg_loss_matches_jax():
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((3, 40, 50)).astype(np.float32) * 2
    logp = torch.log_softmax(torch.tensor(logits), -1)
    target = rng.integers(0, 50, (3, 40)).astype(np.int32)
    want = j_nll(jnp.asarray(logp.numpy()), jnp.asarray(target))
    got = nll_seg_loss(logp, torch.tensor(target))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_seg_miou_metrics_match_jax():
    """The mIoU suite on predictions that are partly right, over several
    categories, some of whose parts appear in neither prediction nor target
    (IoU 1 by the reference's rule): equal dicts."""
    assert T_SEG_CLASSES == SEG_CLASSES
    rng = np.random.default_rng(12)
    cats = ["Airplane", "Bag", "Cap", "Car", "Chair", "Airplane"]
    names = list(SEG_CLASSES)
    targets, preds = [], []
    for c in cats:
        parts = np.array(SEG_CLASSES[c])
        t = parts[rng.integers(0, len(parts) - (c == "Car"), 64)]
        p = np.where(rng.random(64) < 0.7, t, parts[rng.integers(0, len(parts), 64)])
        targets.append(t)
        preds.append(p)
    cls = np.array([names.index(c) for c in cats])
    want = j_miou(np.stack(preds), np.stack(targets), cls, SEG_CLASSES)
    got = seg_miou_metrics(np.stack(preds), np.stack(targets), cls, T_SEG_CLASSES)
    assert got == want and 0.0 < got["instance_avg_iou"] < 1.0
