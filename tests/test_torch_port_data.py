"""The port's dataset copies, native host library and metrics writer against
the JAX package's, on tiny fixture files written under ``tmp_path`` (the
formats of ``tests/test_datasets.py``): every item equal, with the same
numpy and ``random`` seeds before each read (the readers shuffle and
resample with the global generators). Also the CLI's forwarding of
``--way/--shot/--fold`` to ``ModelNetFewShot``."""

import json
import pickle
import random
import shutil
import types

import numpy as np
import pytest
import yaml

import upp_tpu.data as jdata
import upp_torch.data as tdata
from upp_tpu import native as j_native
from upp_tpu.utils.config import ConfigDict
from upp_torch import native as t_native
from upp_torch.utils.writer import MetricsWriter, make_writers

_rng = np.random.default_rng(0)


def _cloud(n=64, c=3):
    return _rng.standard_normal((n, c)).astype(np.float32)


def _equal(a, b, where=""):
    """Items equal all the way down (tuples, arrays, numbers, strings)."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def _same_items(name, cfg, n=None, seed=0):
    """Build dataset ``name`` from ``cfg`` in both packages and compare
    every item, each read after seeding numpy's and ``random``'s global
    generators alike."""
    j_ds = jdata.DATASETS.build(ConfigDict.from_nested({"NAME": name, **cfg}))
    t_ds = tdata.DATASETS.build(ConfigDict.from_nested({"NAME": name, **cfg}))
    assert type(t_ds).__module__.startswith("upp_torch.")
    assert len(j_ds) == len(t_ds) > 0
    for i in range(len(j_ds) if n is None else n):
        items = []
        for ds in (j_ds, t_ds):
            np.random.seed(seed + i)
            random.seed(seed + i)
            items.append(ds[i])
        _equal(*items, where=f"{name}[{i}]")
    return j_ds, t_ds


@pytest.fixture()
def modelnet_root(tmp_path):
    root = tmp_path / "modelnet"
    root.mkdir()
    (root / "modelnet40_shape_names.txt").write_text("airplane\nchair\n")
    ids = {"train": ["airplane_0001", "chair_0001", "chair_0002"],
           "test": ["airplane_0002", "chair_0003"]}
    for subset, id_list in ids.items():
        (root / f"modelnet40_{subset}.txt").write_text("\n".join(id_list) + "\n")
        for sid in id_list:
            d = root / "_".join(sid.split("_")[:-1])
            d.mkdir(exist_ok=True)
            np.savetxt(d / f"{sid}.txt", _cloud(40, 6), delimiter=",")
    return root


@pytest.mark.parametrize("subset", ["train", "test"])
def test_modelnet_cache_and_items(modelnet_root, tmp_path, subset):
    """Each package builds the FPS cache from the txt clouds in a copy of
    the root (equal pickles), and reads equal items from it."""
    other = tmp_path / "modelnet_port"
    shutil.copytree(modelnet_root, other)
    cfg = {"N_POINTS": 16, "NUM_CATEGORY": 40, "subset": subset}
    caches = []
    for pkg, root in ((jdata, modelnet_root), (tdata, other)):
        np.random.seed(3)
        pkg.DATASETS.build(ConfigDict.from_nested({"NAME": "ModelNet", "DATA_PATH": str(root),
                                                   **cfg}))
        with open(root / f"modelnet40_{subset}_16pts_fps.dat", "rb") as f:
            caches.append(pickle.load(f))
    for a, b in zip(*caches):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    _same_items("ModelNet", {"DATA_PATH": str(modelnet_root), **cfg})


def test_few_shot_generator_and_items(modelnet_root, tmp_path):
    """``generate_few_shot.generate`` writes the same way/shot/fold pickles
    in both packages; ``ModelNetFewShot`` reads equal items from them."""
    from upp_tpu.data.generate_few_shot import generate as j_generate
    from upp_torch.data.generate_few_shot import generate as t_generate
    for subset in ("train", "test"):          # the FPS caches both read
        jdata.DATASETS.build(ConfigDict.from_nested({
            "NAME": "ModelNet", "DATA_PATH": str(modelnet_root), "N_POINTS": 16,
            "NUM_CATEGORY": 40, "subset": subset}))
    outs = []
    for gen, name in ((j_generate, "fs_jax"), (t_generate, "fs_port")):
        np.random.seed(4)
        gen(str(modelnet_root), str(tmp_path / name), way=2, shot=1, folds=2, npoints=16)
        with open(tmp_path / name / "2way_1shot" / "1.pkl", "rb") as f:
            outs.append(pickle.load(f))
    for subset in ("train", "test"):
        assert len(outs[0][subset]) == len(outs[1][subset]) > 0
        for a, b in zip(outs[0][subset], outs[1][subset]):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:] == b[1:]
    for subset in ("train", "test"):
        _same_items("ModelNetFewShot", {"DATA_PATH": str(tmp_path / "fs_jax"), "N_POINTS": 16,
                                        "subset": subset, "way": 2, "shot": 1, "fold": 1})


def test_shapenet55_items_and_native_batches(tmp_path):
    root, pc = tmp_path / "sn", tmp_path / "sn_pc"
    root.mkdir()
    pc.mkdir()
    lines = []
    for tax, model in (("02691156", "m1"), ("02691156", "m2"), ("03001627", "m3")):
        np.save(pc / f"{tax}-{model}.npy", _cloud(32))
        lines.append(f"{tax}-{model}.npy")
    lines.append("02691156-missing.npy")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    j_ds, t_ds = _same_items("ShapeNet", {"DATA_PATH": str(root), "PC_PATH": str(pc),
                                          "N_POINTS": 32, "subset": "train"})
    _equal(j_ds.get_batch([0, 1, 2]), t_ds.get_batch([0, 1, 2]))


@pytest.mark.parametrize("name", ["ScanObjectNN", "ScanObjectNN_hardest"])
@pytest.mark.parametrize("subset", ["train", "test"])
def test_scanobjectnn_items(tmp_path, name, subset):
    h5py = pytest.importorskip("h5py")
    data = _cloud(5 * 24).reshape(5, 24, 3)
    labels = np.array([0, 1, 2, 1, 0])
    stem = "training" if subset == "train" else "test"
    for fname in (f"{stem}_objectdataset.h5", f"{stem}_objectdataset_augmentedrot_scale75.h5"):
        with h5py.File(tmp_path / fname, "w") as f:
            f["data"] = data
            f["label"] = labels
    _same_items(name, {"ROOT": str(tmp_path), "subset": subset})


def _partnormal_root(tmp_path):
    root = tmp_path / "part"
    for syn in ("02691156", "02773838"):
        (root / syn).mkdir(parents=True)
    (root / "train_test_split").mkdir()
    (root / "synsetoffset2category.txt").write_text("Airplane\t02691156\nBag\t02773838\n")
    lists = {"train": [], "val": [], "test": []}
    for i, (syn, parts) in enumerate((("02691156", 4), ("02773838", 2)) * 3):
        split = ("train", "val", "test")[i // 2]
        mid = f"model{i}"
        data = np.concatenate([_cloud(30, 3), _cloud(30, 3),
                               _rng.integers(0, parts, (30, 1)).astype(np.float32)], 1)
        np.savetxt(root / syn / f"{mid}.txt", data)
        lists[split].append(f"shape_data/{syn}/{mid}")
    for split, items in lists.items():
        (root / "train_test_split" / f"shuffled_{split}_file_list.json").write_text(
            json.dumps(items))
    return root


@pytest.mark.parametrize("subset", ["trainval", "test"])
def test_partnormal_items(tmp_path, subset):
    """ShapeNetPart txt/JSON splits: equal (points, category, part labels)
    items, resampled with replacement from the same seed."""
    j_ds, _ = _same_items("PartNormalDataset", {"DATA_PATH": str(_partnormal_root(tmp_path)),
                                                "N_POINTS": 16, "subset": subset})
    assert len(j_ds) == (4 if subset == "trainval" else 2)


def test_synthetic_part_and_synthetic_items():
    for subset in ("train", "test"):
        _same_items("SyntheticPart", {"N_POINTS": 128, "SIZE": 8, "subset": subset})
    _same_items("Synthetic", {"N_POINTS": 128, "NUM_CATEGORY": 6, "SIZE": 6, "subset": "test",
                              "NOISE_OUTLIERS": 8, "NOISE_JITTER": 0.01})


@pytest.mark.parametrize("task", ["classification", "completion"])
def test_projected_shapenet_items(tmp_path, task):
    root = tmp_path / "proj"
    comp, part = root / "complete", root / "partial"
    comp.mkdir(parents=True)
    part.mkdir()
    (root / "test.txt").write_text("02691156-m1.npy\n03001627-m2.npy\n")
    for tax, mid in (("02691156", "m1"), ("03001627", "m2")):
        np.save(comp / f"{tax}-{mid}.npy", _cloud(48))
        np.save(part / f"{tax}-{mid}-0.npy", _cloud(24))
    _same_items("Projected_ShapeNet", {
        "DATA_PATH": str(root), "PARTIAL_POINTS_PATH": str(part / "%s-%s-%d.npy"),
        "COMPLETE_POINTS_ROOT": str(comp), "N_POINTS": 48, "subset": "test", "TASK": task})


def _write_pcd(path, pts):
    head = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {len(pts)}\n"
            "DATA ascii\n")
    path.write_text(head + "".join(f"{p[0]} {p[1]} {p[2]}\n" for p in pts))


def test_realsensor_items_and_ascii_io(tmp_path):
    root = tmp_path / "scans"
    (root / "airplane").mkdir(parents=True)
    (root / "chair").mkdir()
    _write_pcd(root / "airplane" / "a.pcd", _cloud(20))
    _write_pcd(root / "chair" / "c.pcd", _cloud(4))       # fewer than N_POINTS: padded
    names = tmp_path / "names.txt"
    names.write_text("airplane\nchair\n")
    _same_items("RealSensorDataset", {"DATA_PATH": str(root), "N_POINTS": 8,
                                      "CLASS_NAMES": str(names)})
    from upp_tpu.data.io import IO as JIO
    from upp_torch.data.io import IO as TIO
    ply = tmp_path / "c.ply"
    ply.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                   "property float y\nproperty float z\nend_header\n0 0 0\n1 0 0\n0 1 0\n")
    for path in (ply, root / "airplane" / "a.pcd"):
        _equal(JIO.get(str(path)), TIO.get(str(path)))


def test_native_library_matches_jax(tmp_path):
    """The port's copy of the native library builds under ``build/`` (not
    in the package) and gives the JAX package's FPS indices and npy batches;
    its numpy fallbacks give the same."""
    lib = t_native.get_lib()
    assert lib is not None
    assert t_native._target().parent == t_native.BUILD_DIR
    assert t_native._target().exists()
    assert not list(t_native._SRC.parent.glob("*.so"))
    pts = np.random.default_rng(1).standard_normal((3, 300, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_native.fps_host(pts[0], 64, start=7),
                                  j_native.fps_host(pts[0], 64, start=7))
    np.testing.assert_array_equal(t_native.fps_host_batch(pts, 32),
                                  j_native.fps_host_batch(pts, 32))
    np.testing.assert_array_equal(t_native._fps_numpy(pts[1], 64, 5),
                                  j_native.fps_host(pts[1], 64, start=5))
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"c{i}.npy"))
        np.save(paths[-1], _cloud(90 + 5 * i))
    np.testing.assert_array_equal(t_native.read_npy_batch(paths, 96),
                                  j_native.read_npy_batch(paths, 96))


def test_metrics_writer_jsonl(tmp_path):
    """``MetricsWriter`` appends one JSON line per scalar; ``make_writers``
    gives a train and a test writer under ``tfboard_path``, none without."""
    train, val = make_writers(types.SimpleNamespace(tfboard_path=str(tmp_path / "tb")))
    train.add_scalar("Loss/Epoch/Loss", np.float32(1.5), 0)
    train.add_scalar("Loss/Epoch/Loss", 1.25, 1)
    val.add_scalar("Metric/ACC", 50, 1)
    for w in (train, val):
        w.close()
    rows = [json.loads(line) for line in open(tmp_path / "tb" / "train_metrics.jsonl")]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [
        ("Loss/Epoch/Loss", 1.5, 0), ("Loss/Epoch/Loss", 1.25, 1)]
    (row,) = [json.loads(line) for line in open(tmp_path / "tb" / "test_metrics.jsonl")]
    assert row["value"] == 50.0 and row["step"] == 1
    assert make_writers(types.SimpleNamespace(tfboard_path=None)) == (None, None)
    again = MetricsWriter(str(tmp_path / "tb"), "train")
    again.add_scalar("x", 2.0, 3)
    again.close()
    assert len(open(tmp_path / "tb" / "train_metrics.jsonl").readlines()) == 3


def test_cli_forwards_few_shot_flags(modelnet_root, tmp_path, monkeypatch):
    """``--way/--shot/--fold`` reach ``ModelNetFewShot`` through
    ``upp_torch.main``: a 0-epoch classification run on the 2-way 1-shot
    fold 0 split trains on its 2 clouds, writes ``ckpt-last.pth`` and the
    JSONL metrics."""
    from upp_torch.data.generate_few_shot import generate
    from upp_torch.main import main
    out = tmp_path / "fewshot"
    generate(str(modelnet_root), str(out), way=2, shot=1, folds=1, npoints=64)
    base = {"NAME": "ModelNetFewShot", "DATA_PATH": str(out), "N_POINTS": 64}
    cfg = {
        "optimizer": {"type": "AdamW", "kwargs": {"lr": 5e-4, "weight_decay": 0.05}},
        "scheduler": {"type": "CosLR", "kwargs": {"epochs": 2, "initial_epochs": 0}},
        "dataset": {s: {"_base_": dict(base),
                        "others": {"subset": "train" if s == "train" else "test"}}
                    for s in ("train", "val", "test")},
        "model": {"NAME": "Point_MAE_unify", "cls_dim": 2, "group_size": 8, "num_group": 16,
                  "transformer_config": {"mask_ratio": 0.5, "trans_dim": 32, "encoder_dims": 32,
                                         "depth": 2, "drop_path_rate": 0.0, "num_heads": 4,
                                         "decoder_depth": 1, "decoder_num_heads": 4}},
        "npoints": 32, "total_bs": 2, "max_epoch": 0, "task": "classification",
        "grad_norm_clip": 10,
    }
    path = tmp_path / "fewshot_cls.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    main(["--finetune_model", "--config", str(path), "--device", "cpu", "--exp_name", "fs",
          "--way", "2", "--shot", "1", "--fold", "0"])
    (run,) = tmp_path.glob("experiments/fewshot_cls/plain-network/finetune-fs/*")
    assert (run / "ckpt-last.pth").exists()
    log = (run / "fewshot_cls.log").read_text()
    assert "way" in log and "[Training] EPOCH: 0" in log
    (jsonl,) = tmp_path.glob("experiments/TFBoard/fewshot_cls/**/train_metrics.jsonl")
    tags = {json.loads(line)["tag"] for line in open(jsonl)}
    assert {"Loss/Batch/Loss", "Loss/Epoch/Loss"} <= tags
