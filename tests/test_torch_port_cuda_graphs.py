"""CUDA graphs of the inference passes and of the training steps
(``upp_torch/utils/cuda_graphs.py``): when ``run`` and ``GraphedStep`` graph
and when they run eager, on the CPU; on a card (the ``card`` tests, which
skip without one; this file imports no JAX, so on the card's machine it
runs alone: ``python -m pytest --noconftest -m card
tests/test_torch_port_cuda_graphs.py``), the graphed eval and train steps
against the same steps run eager.

On the CPU every call runs eager, so the eval steps' answers there are the
passes composed by hand, as the steps computed them before any graph, and
the train steps' are the closures' without their ``GraphedStep``."""

import copy
import pickle
import types

import numpy as np
import pytest
import torch

from upp_torch.models import build_model_from_cfg
from upp_torch.ops.chamfer import chamfer_l1_per_sample, chamfer_l2_per_sample
from upp_torch.ops.corrupt import partial_point_cloud
from upp_torch.ops.fps import fps
from upp_torch.train import optim, runner_cls, runner_pretask, runner_seg
from upp_torch.train.metrics import completion_metrics
from upp_torch.utils import cuda_graphs, profiling
from upp_torch.utils.config import ConfigDict

BLOCKS = {"mask_ratio": 0.5, "mask_type": "rand", "trans_dim": 48, "encoder_dims": 48,
          "depth": 3, "drop_path_rate": 0.1, "num_heads": 4, "decoder_depth": 2,
          "decoder_num_heads": 4}
PROMPTS = {"rectify_adapter": True, "rectify_prompts": True, "rectify_prompts_num": 2,
           "rectify_prompts_depth": 2, "rectify_depth": 2,
           "pretask_adapter": True, "pretask_prompts": True, "pretask_prompts_num": 2,
           "pretask_prompts_depth": 3, "pretask_depth": 3}
CLS_MODEL = {"NAME": "Point_MAE_unify", "transformer_config": BLOCKS, "cls_dim": 5,
             "group_size": 16, "num_group": 32, "gather_idx": False,
             "prompt_propagation_after": True,
             "prompter_config": {**PROMPTS, "downstream_adapter": True,
                                 "downstream_prompts": True, "downstream_prompts_num": 3,
                                 "downstream_prompts_depth": 2, "downstream_depth": 3}}
PRETASK_MODEL = {"NAME": "Point_MAE_pretask_dev", "transformer_config": BLOCKS,
                 "group_size": 8, "num_group": 32, "gather_idx": True,
                 "prompt_propagation_after": True, "prompter_config": PROMPTS}
SEG_MODEL = {"NAME": "Point_MAE_unify_seg", "transformer_config": {**BLOCKS, "depth": 4},
             "trans_dim": 48, "depth": 4, "drop_path_rate": 0.1, "cls_dim": 50,
             "num_heads": 4, "group_size": 16, "num_group": 32, "encoder_dims": 48,
             "gather_idx": True, "prompt_propagation_after": False,
             "prompter_config": {**PROMPTS, "downstream_adapter": True,
                                 "downstream_prompts": True, "downstream_prompts_num": 1,
                                 "downstream_prompts_depth": 2, "downstream_depth": 4}}
N_DATASET = 512
N_SEG = 128
CONFIG = ConfigDict.from_nested({
    "dataset": {"val": {"_base_": {"N_POINTS": N_DATASET}}},
    "npoints": 128, "noisy_validate": True})
ARGS = types.SimpleNamespace(normalize=False)
VIEWPOINT = (1.0, -1.0, 1.0)
TRAIN = {"optimizer": {"type": "AdamW", "kwargs": {"lr": 5e-4, "weight_decay": 0.05}},
         "scheduler": {"type": "CosLR", "kwargs": {"epochs": 4, "initial_epochs": 1}},
         "data_augmentation": "scale-translate", "grad_norm_clip": 10, "noisy_train": True}
CLS_TRAIN = ConfigDict.from_nested({**TRAIN, "npoints": 128, "dataset": {
    "train": {"_base_": {"N_POINTS": N_DATASET}}}})
SEG_TRAIN = ConfigDict.from_nested({**TRAIN, "dataset": {"train": {"_base_": {"N_POINTS": N_SEG}}}})
TRAIN_ARGS = types.SimpleNamespace(noise=True, noise_type=["gaussian_noise", "lidar_noise"],
                                   incomplete_cropping=True, normalize=False, seed=0)


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def model_of(cfg, device="cpu", **change):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return build_model_from_cfg(copy.deepcopy({**cfg, **change})).to(device).eval()


def clouds(b, n, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32)).to(device)


# -- on the CPU ----------------------------------------------------------------

@pytest.mark.parametrize("reason", ["grad", "training", "ranks", "device"])
def test_the_helper_runs_eager_and_counts_it(reason, monkeypatch):
    """Grad on, a training module, two ranks or a host tensor: ``run`` calls
    ``fn`` as it is, counts ``cuda_graph.eager`` and keeps no graph."""
    owner = torch.nn.Linear(3, 2).train(reason == "training")
    if reason == "ranks":
        monkeypatch.setattr(cuda_graphs, "get_dist_info", lambda: (0, 2))
    x = torch.randn(4, 3)
    with torch.set_grad_enabled(reason == "grad"):
        assert cuda_graphs.eager_reason(owner, (x,)) == reason
        for _ in range(3):
            out = cuda_graphs.run(owner, "site", owner, x)
            assert torch.equal(out, owner(x))
    assert profiling.counts() == {"cuda_graph.eager": 3}
    assert "_cuda_graphs" not in vars(owner)


def test_a_key_runs_eager_then_captures_then_replays(monkeypatch):
    """The control flow past the conditions: a key's first call eager, its
    second captured, later ones replayed; at most ``MAX_KEYS`` keys a site,
    the least recently used dropped; a moved parameter recaptures."""
    owner = torch.nn.Linear(3, 2).eval()
    made = []

    def capture(graphs, owner, fn, args):
        made.append(args[0].shape[0])
        if graphs.places is None:
            graphs.places = cuda_graphs._Places(owner)
        return types.SimpleNamespace(rows=args[0].shape[0])

    monkeypatch.setattr(cuda_graphs, "eager_reason", lambda owner, args: None)
    monkeypatch.setattr(cuda_graphs, "_capture", capture)
    monkeypatch.setattr(cuda_graphs, "_replay", lambda entry, args: ("replay", entry.rows))

    def call(rows):
        return cuda_graphs.run(owner, "site", lambda x: ("eager", x.shape[0]),
                               torch.zeros(rows, 3))

    assert [call(1), call(1), call(1)] == [("eager", 1), ("replay", 1), ("replay", 1)]
    assert made == [1]
    for rows in range(2, 2 + cuda_graphs.MAX_KEYS):     # 1 is the least recent: dropped
        call(rows)
    assert call(2) == ("replay", 2) and call(1) == ("eager", 1) and made == [1, 2]
    with torch.no_grad():
        owner.weight.add_(1.0)                          # in place: the graphs stay
    assert call(2) == ("replay", 2) and made == [1, 2]
    owner.weight = torch.nn.Parameter(owner.weight.detach().clone())
    assert call(2) == ("replay", 2) and made == [1, 2, 2]
    assert profiling.counts()["cuda_graph.eager"] == 2 + cuda_graphs.MAX_KEYS


def test_parameters_moved_or_in_place_are_told_apart():
    owner = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4)).eval()
    graphs = cuda_graphs.Graphs()
    assert not graphs.moved(owner)                      # nothing captured yet
    graphs.places = cuda_graphs._Places(owner)
    with torch.no_grad():
        owner[0].weight.mul_(2.0)
        owner[1].running_mean.add_(1.0)
    assert not graphs.moved(owner)
    owner[0].bias.data = owner[0].bias.data.clone()     # as ``.to()`` moves it
    assert graphs.moved(owner)
    graphs.places = cuda_graphs._Places(owner)
    state = {k: v.clone() for k, v in owner.state_dict().items()}
    owner.load_state_dict(state, assign=True)
    assert graphs.moved(owner)
    graphs.places = cuda_graphs._Places(owner)
    owner[1]._buffers["running_var"] = owner[1].running_var.clone()   # resharding's way
    assert graphs.moved(owner)


def test_a_copy_or_a_pickle_of_a_model_holds_no_graphs():
    model = model_of(CLS_MODEL)
    graphs = cuda_graphs.graphs_of(model)
    graphs.sites["downstream"] = {"key": None}
    for other in (copy.deepcopy(model), pickle.loads(pickle.dumps(model))):
        assert cuda_graphs.graphs_of(other).sites == {}
    assert cuda_graphs.graphs_of(model) is graphs
    cuda_graphs.clear(model)
    assert "_cuda_graphs" not in vars(model)


def test_cls_eval_step_answers_as_its_passes_composed():
    model = model_of(CLS_MODEL)
    seen = []
    model.register_forward_hook(lambda module, args, out: seen.append(out))
    step = runner_cls.make_eval_step(model, CONFIG, ARGS)
    for seed in range(2):
        pts = clouds(3, 256, seed)
        labels = step(pts)
        with torch.inference_mode():
            p = fps(pts, 128)[0]
            p = model.denoise_pts(p, 128)
            p = model.complete_and_resample(p, 128)[0]
            logits = model.classify(p)
        assert torch.equal(seen[-1], logits) and torch.equal(labels, logits.argmax(-1))
    assert len(seen) == 2 and profiling.counts() == {"cuda_graph.eager": 6}


def test_pretask_eval_step_answers_as_its_passes_composed():
    model = model_of(PRETASK_MODEL)
    step = runner_pretask.make_pretask_eval_step(model, CONFIG, "easy")
    num_crop = int(N_DATASET * runner_pretask.CROP_RATIOS["easy"])
    vp = torch.tensor(VIEWPOINT)
    for seed in range(2):
        gt = clouds(2, N_DATASET, seed)
        got = step(gt, vp)
        with torch.no_grad():
            partial = partial_point_cloud(gt, num_crop, sample_points=128, viewpoint=vp)
            partial_center, _ = fps(partial, 128)
            predict_center, rebuild = model.complete(partial)
            coarse = torch.cat([partial_center, predict_center], dim=1)
            dense = torch.cat([partial, rebuild], dim=1)
            want = {"sparse_l1": chamfer_l1_per_sample(coarse, gt) * 1000,
                    "sparse_l2": chamfer_l2_per_sample(coarse, gt) * 1000,
                    "dense_l1": chamfer_l1_per_sample(dense, gt) * 1000,
                    "dense_l2": chamfer_l2_per_sample(dense, gt) * 1000,
                    **completion_metrics(dense, gt)}
        assert list(got) == list(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert profiling.counts() == {"cuda_graph.eager": 6}


# -- the training step's graph, on the CPU ------------------------------------

def tiny_step():
    """A BatchNorm'd linear model and its step: noise from the generator,
    a squared loss, its backward; returns [loss, a default-generator draw]."""
    owner = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))

    def fn(x, generator=None, draws=None):
        noise = torch.randn(x.shape, generator=generator, device=x.device)
        loss = owner(x + noise).square().mean()
        loss.backward()
        return torch.stack([loss.detach(), torch.rand((), device=x.device)])
    return owner, fn


@pytest.mark.parametrize("reason", ["device", "draws", "accumulate", "ranks", "capturing"])
def test_the_step_runs_eager_and_counts_it(reason, monkeypatch):
    """A host tensor, the draws given, an accumulating optimizer, two ranks
    or a capture under way: the step runs ``fn`` as it is, counts
    ``cuda_graph.eager`` and keeps no key."""
    owner, fn = tiny_step()
    step = cuda_graphs.GraphedStep(owner, fn)
    kw = {"accumulate": 2 if reason == "accumulate" else 1,
          "draws": "given" if reason == "draws" else None}
    if reason == "ranks":
        monkeypatch.setattr(cuda_graphs, "get_dist_info", lambda: (0, 2))
    if reason == "capturing":
        monkeypatch.setattr(profiling, "capturing", lambda: True)
    x = torch.randn(4, 3)
    assert cuda_graphs.step_eager_reason((x,), **kw) == reason
    gen = torch.Generator()
    with torch.random.fork_rng(devices=[]):
        for i in range(3):
            torch.manual_seed(i)
            got = step(x, generator=gen.manual_seed(i), **kw)
            torch.manual_seed(i)
            assert torch.equal(got, fn(x, generator=gen.manual_seed(i)))
    assert profiling.counts() == {"cuda_graph.eager": 3}
    assert not step.keys and step.graphs.places is None


def test_a_step_key_runs_eager_then_captures_then_replays(monkeypatch):
    """The control flow past the conditions: a key's first call eager, its
    second captured, later ones replayed; a new shape or trainable set is a
    new key; at most ``MAX_KEYS``; a moved parameter recaptures; a capture
    that raises leaves its key eager."""
    owner = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    made = []

    def capture(self, args, generator):
        rows = args[0].shape[0]
        made.append(rows)
        if rows == 3:
            raise RuntimeError("operation not permitted when stream is capturing")
        if self.graphs.places is None:
            self.graphs.places = cuda_graphs._Places(self.owner)
        return types.SimpleNamespace(rows=rows)

    monkeypatch.setattr(cuda_graphs, "step_eager_reason", lambda *a: None)
    monkeypatch.setattr(cuda_graphs.GraphedStep, "_capture", capture)
    monkeypatch.setattr(cuda_graphs.GraphedStep, "_replay",
                        lambda self, entry, args: ("replay", entry.rows))
    step = cuda_graphs.GraphedStep(owner, lambda x, generator, draws: ("eager", x.shape[0]))

    def call(rows):
        return step(torch.zeros(rows, 3))

    assert [call(1), call(1), call(1)] == [("eager", 1), ("replay", 1), ("replay", 1)]
    x1, x2 = torch.zeros(1, 3), torch.zeros(2, 3)
    key = step.key((x1,))
    assert step.key((x1.clone(),)) == key and step.key((x2,)) != key
    owner[0].weight.requires_grad_(False)               # the trainable set flips
    assert step.key((x1,)) != key
    assert [call(1), call(1)] == [("eager", 1), ("replay", 1)] and made == [1, 1]
    assert [call(3), call(3), call(3)] == [("eager", 3)] * 3 and made == [1, 1, 3]
    for rows in range(4, 4 + cuda_graphs.MAX_KEYS):     # the oldest keys dropped
        call(rows)
    assert call(1) == ("eager", 1) and len(step.keys) == cuda_graphs.MAX_KEYS
    call(5)
    with torch.no_grad():
        owner[1].weight.add_(1.0)                       # in place: the graphs stay
    assert call(5) == ("replay", 5) and made[-1] == 5 and len(made) == 4
    owner[1].weight = torch.nn.Parameter(owner[1].weight.detach().clone())
    assert call(5) == ("replay", 5) and made[-2:] == [5, 5]
    counts = profiling.counts()
    assert counts["cuda_graph.captures"] == len(made) - 1        # the failed one not
    assert counts["cuda_graph.replays"] == 2        # a capturing call is no replay


def unwrapped(monkeypatch):
    """Make the closures built from here on call their ``fn`` directly."""
    class Direct:
        def __init__(self, owner, fn):
            self.fn = fn

        def __call__(self, *args, generator=None, accumulate=1, draws=None):
            return self.fn(*args, generator=generator, draws=draws)
    monkeypatch.setattr(cuda_graphs, "GraphedStep", Direct)


def train_setup(kind, device="cpu"):
    model = model_of(SEG_MODEL if kind == "seg" else CLS_MODEL, device)
    config = SEG_TRAIN if kind == "seg" else CLS_TRAIN
    optim.set_trainable(model, runner_seg.SEG_PEFT_LIST if kind == "seg"
                        else runner_cls.PEFT_LIST)
    opt = optim.build_optimizer(config, model, steps_per_epoch=2)
    if kind == "seg":
        step = runner_seg.make_seg_train_step(model, opt, config, TRAIN_ARGS, unify=True)
    else:
        step = runner_cls.make_train_step(model, opt, config, TRAIN_ARGS)
    return model, opt, step


def train_batch(kind, i, device="cpu"):
    if kind != "seg":
        return clouds(4, N_DATASET, i, device), torch.tensor([0, 1, 4, 2], device=device)
    rng = np.random.default_rng(100 + i)
    target = torch.from_numpy(rng.integers(0, 50, (4, N_SEG))).to(device)
    return clouds(4, N_SEG, i, device), torch.tensor([0, 3, 15, 7], device=device), target


def state_of(model, opt):
    """Every parameter and buffer, and each AdamW state tensor, cloned."""
    adam = [t for p in model.parameters() for t in opt.optimizer.state.get(p, {}).values()]
    return [t.detach().clone() for t in (*model.parameters(), *model.buffers(), *adam)]


def train(kind, steps, device="cpu", switch=None):
    """``steps`` train steps from the seed; the trainable set becomes the
    joint one before step ``switch``. Returns (losses, ``state_of``)."""
    model, opt, step = train_setup(kind, device)
    losses = []
    for i in range(steps):
        if i == switch:
            optim.set_trainable(model, runner_cls.JOINT_PEFT_LIST)
        losses.append(step(*train_batch(kind, i, device)))
    return [torch.stack([m["loss"], m["acc"]]) for m in losses], state_of(model, opt)


def same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kind", ["cls", "seg"])
def test_wrapped_train_steps_equal_the_unwrapped_ones(kind, monkeypatch):
    """Three steps: losses, parameters, BatchNorm buffers and AdamW state
    bit-equal with and without the step's ``GraphedStep`` (on the CPU it
    runs eager, one count a step)."""
    wrapped = train(kind, 3)
    # a step each, and in cls its three passes (grad on)
    assert profiling.counts()["cuda_graph.eager"] == 3 * (4 if kind == "cls" else 1)
    unwrapped(monkeypatch)
    direct = train(kind, 3)
    assert same(wrapped[0], direct[0]) and same(wrapped[1], direct[1])


# -- on a card -----------------------------------------------------------------

def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def cls_setup(half=False):
    model = model_of(CLS_MODEL, "cuda", if_half=half)
    seen = []
    model.register_forward_hook(lambda module, args, out: seen.append(out))
    return model, runner_cls.make_eval_step(model, CONFIG, ARGS), seen


def pretask_setup():
    model = model_of(PRETASK_MODEL, "cuda")
    return model, runner_pretask.make_pretask_eval_step(model, CONFIG, "easy")


def batches(kind):
    """Three batches of 6 and three of 4 (a second key), each other clouds."""
    n = 256 if kind == "cls" else N_DATASET
    return [clouds(b, n, seed, "cuda") for seed, b in enumerate((6, 6, 6, 4, 4, 4))]


def eager(model, step, *args):
    """The step run eager: its model's graphs dropped before the call."""
    cuda_graphs.clear(model)
    return step(*args)


@pytest.mark.card
@pytest.mark.parametrize("half", [False, True])
def test_graphed_cls_eval_step_equals_eager(half):
    need_card()
    model, step, seen = cls_setup(half)
    got = []
    for pts in batches("cls"):
        got.append((step(pts), seen[-1]))
    want = []
    for pts in batches("cls"):
        want.append((eager(model, step, pts), seen[-1]))
    for (labels, logits), (labels_e, logits_e) in zip(got, want):
        assert torch.equal(logits, logits_e) and torch.equal(labels, labels_e)
    assert len({id(z) for z in seen}) == len(seen) == 12     # the hook: a fresh tensor a call


@pytest.mark.card
def test_graphed_pretask_eval_step_equals_eager():
    need_card()
    model, step = pretask_setup()
    vp = torch.tensor(VIEWPOINT)
    got = [step(gt, vp) for gt in batches("pretask")]
    kept = [{k: v.clone() for k, v in out.items()} for out in got]
    want = [eager(model, step, gt, vp) for gt in batches("pretask")]
    for out, before, ref in zip(got, kept, want):
        assert all(torch.equal(out[k], before[k]) for k in ref)   # later calls left it alone
        assert all(torch.equal(out[k], ref[k]) for k in ref)


@pytest.mark.card
def test_parameters_updated_in_place_show_and_replaced_ones_recapture():
    need_card()
    model, step, seen = cls_setup()
    pts = batches("cls")[:3]
    for p in pts:
        step(p)
    captures = profiling.counts()["cuda_graph.captures"]
    with torch.no_grad():
        model.cls_head_finetune[-1].bias.add_(0.5)
        model.norm.weight.mul_(1.5)
    step(pts[0])
    got = seen[-1]
    assert profiling.counts()["cuda_graph.captures"] == captures
    assert torch.equal(got, (eager(model, step, pts[0]), seen[-1])[1])
    for p in pts[:2]:
        step(p)                                          # captured again
    captures = profiling.counts()["cuda_graph.captures"]
    state = {k: v.clone() + (0.25 if k.endswith("cls_head_finetune.8.bias") else 0)
             for k, v in model.state_dict().items()}
    model.load_state_dict(state, assign=True)
    step(pts[1])
    got = seen[-1]
    assert profiling.counts()["cuda_graph.captures"] == captures + 3
    assert torch.equal(got, (eager(model, step, pts[1]), seen[-1])[1])


def unit_of(step, *args):
    """The recorder's unit of one call of ``step``."""
    profiling.reset()
    with profiling.tracing():
        step(*args)
    (unit,) = profiling.units()
    return unit


@pytest.mark.card
@pytest.mark.parametrize("kind", ["cls", "pretask"])
def test_a_replayed_step_counts_its_launches_and_three_replays(kind):
    """A replayed step adds the same ``launches.*`` as the step run eager,
    three replays, and no host sync."""
    need_card()
    if kind == "cls":
        model, step, _ = cls_setup()
        args = batches("cls")[:1]
    else:
        model, step = pretask_setup()
        args = (batches("pretask")[0], torch.tensor(VIEWPOINT))
    eager_unit = unit_of(lambda *a: eager(model, step, *a), *args)
    for _ in range(2):
        step(*args)
    unit = unit_of(step, *args)

    def launches(u):
        return {k: v for k, v in u["counts"].items() if k.startswith("launches.")}

    assert launches(unit) == launches(eager_unit) and launches(unit)
    assert unit["counts"]["cuda_graph.replays"] == 3
    assert "cuda_graph.eager" not in unit["counts"]
    assert unit["counts"].get("host_syncs", 0) == 0


def gaps(a, b):
    """(tensors that differ, the largest absolute gap among them)."""
    differ = [(x.double() - y.double()).abs().max().item() for x, y in zip(a, b)
              if not torch.equal(x, y)]
    return len(differ), max(differ, default=0.0)


@pytest.fixture
def deterministic():
    """torch's deterministic kernels for the test. Without them the
    backward's atomic adds (the index and scatter backwards) sum in another
    order each run, so two eager runs part already in the first step's
    gradients, and a graphed run parts from an eager one no more than that."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(was[0], warn_only=was[1])


@pytest.mark.card
@pytest.mark.parametrize("kind, switch", [("cls", None), ("cls", 4), ("seg", None)],
                         ids=["cls", "cls_joint", "seg"])
def test_graphed_train_steps_equal_eager(kind, switch, monkeypatch, deterministic):
    """Eight graphed steps against eight eager ones from the same seed (the
    joint switch before step 5 makes a second key), both with deterministic
    kernels: losses and accuracies, every parameter, the BatchNorm buffers
    and the AdamW moments and step counts bit-equal; each key replays from
    its third step on."""
    need_card()
    steps, keys = 8, 1 if switch is None else 2
    graphed = train(kind, steps, "cuda", switch)
    counts = profiling.counts()
    assert counts["cuda_graph.captures"] == keys
    assert counts["cuda_graph.replays"] == steps - 2 * keys
    monkeypatch.setattr(cuda_graphs, "step_eager_reason", lambda *a: "forced")
    eager = train(kind, steps, "cuda", switch)
    assert same(graphed[0], eager[0]), (graphed[0], eager[0])
    assert same(graphed[1], eager[1]), gaps(graphed[1], eager[1])


@pytest.mark.card
def test_a_replayed_train_step_counts_one_replay_and_its_launches():
    """A replayed cls step adds the launches of the eager step, one replay
    and no host sync, and keeps the spans the host still runs: the root's
    and the optimizer's."""
    need_card()
    _, _, step = train_setup("cls", "cuda")
    batch = train_batch("cls", 0, "cuda")
    eager_unit = unit_of(step, *batch)
    step(*batch)
    unit = unit_of(step, *batch)

    def launches(u):
        return {k: v for k, v in u["counts"].items() if k.startswith("launches.")}

    assert launches(unit) == launches(eager_unit) and launches(unit)
    assert unit["counts"]["cuda_graph.replays"] == 1
    assert "cuda_graph.eager" not in unit["counts"]
    assert unit["counts"].get("host_syncs", 0) == 0
    assert [s["name"] for s in unit["spans"]] == ["optimizer"]


@pytest.mark.card
def test_a_step_whose_capture_fails_stays_eager():
    """A step with a synchronising call cannot be captured: its key runs
    eager from then on, and every call answers as ``fn`` run eager, the
    step's generator and the default one drawing on as before."""
    need_card()
    owner, fn = tiny_step()
    owner.cuda()

    def synced(x, generator=None, draws=None):
        out = fn(x, generator=generator)
        assert out[0].item() >= 0.0
        return out

    x = torch.randn(8, 3, device="cuda")
    gen = torch.Generator("cuda")
    runs = []
    for step in (cuda_graphs.GraphedStep(owner, synced), synced):
        with torch.random.fork_rng(devices=[0]):
            torch.cuda.manual_seed(7)
            outs = []
            for i in range(4):
                owner.zero_grad(set_to_none=True)
                outs.append(step(x, generator=gen.manual_seed(i)))
            outs.append(torch.rand(3, device="cuda"))
        runs.append(outs)
    assert profiling.counts() == {"cuda_graph.eager": 4}
    assert same(*runs)
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.cuda.current_stream() == torch.cuda.default_stream()


@pytest.mark.card
def test_a_failed_capture_leaves_the_other_keys_drawing_as_eager():
    """One key replays, then another key's capture fails (a synchronising
    call at its shape): the first key's replays still draw what ``fn`` run
    eager draws from both generators, and so does every later draw."""
    need_card()
    owner, fn = tiny_step()
    owner.cuda()

    def synced_at_5(x, generator=None, draws=None):
        out = fn(x, generator=generator)
        if x.shape[0] == 5:
            assert out[0].item() >= 0.0
        return out

    a, b = torch.randn(8, 3, device="cuda"), torch.randn(5, 3, device="cuda")
    gen = torch.Generator("cuda")
    runs = []
    for step in (cuda_graphs.GraphedStep(owner, synced_at_5), synced_at_5):
        with torch.random.fork_rng(devices=[0]):
            torch.cuda.manual_seed(11)
            outs = []
            for i, x in enumerate([a, a, a, b, b, a, a, b, a]):
                owner.zero_grad(set_to_none=True)
                outs.append(step(x, generator=gen.manual_seed(i)))
            outs.append(torch.rand(3, device="cuda"))
            outs.append(torch.rand(3, device="cuda", generator=gen))
        runs.append(outs)
    assert profiling.counts() == {"cuda_graph.captures": 1, "cuda_graph.replays": 4,
                                  "cuda_graph.eager": 4}
    assert same(*runs)
