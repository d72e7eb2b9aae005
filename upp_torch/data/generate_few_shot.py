"""Offline few-shot split generator (reference
``datasets/generate_few_shot_data.py``): builds way/shot/fold pickles from the
ModelNet cache for the ``ModelNetFewShot`` dataset.

Usage: python -m upp_torch.data.generate_few_shot --root data/ModelNet/... \
           --out data/ModelNetFewshot --ways 5 10 --shots 10 20 --folds 10
"""

from __future__ import annotations

import argparse
import os
import pickle
import random

import numpy as np


def generate(root: str, out: str, way: int, shot: int, folds: int,
             npoints: int = 8192) -> None:
    from ..utils.config import ConfigDict
    from .modelnet import ModelNet

    os.makedirs(os.path.join(out, f"{way}way_{shot}shot"), exist_ok=True)
    splits = {}
    for subset in ("train", "test"):
        cfg = ConfigDict.from_nested({
            "DATA_PATH": root, "N_POINTS": npoints, "NUM_CATEGORY": 40,
            "USE_NORMALS": False, "subset": subset})
        ds = ModelNet(cfg)
        per_class = {}
        for i in range(len(ds)):
            _, _, (pts, label) = ds[i]
            per_class.setdefault(label, []).append(pts)
        splits[subset] = per_class

    for fold in range(folds):
        rng = random.Random(fold)
        classes = rng.sample(sorted(splits["train"].keys()), way)
        data = {"train": [], "test": []}
        for new_label, cls in enumerate(classes):
            train_pool = splits["train"][cls]
            picks = rng.sample(range(len(train_pool)), min(shot, len(train_pool)))
            for p in picks:
                data["train"].append((train_pool[p], new_label, cls))
            for pts in splits["test"][cls][:20]:
                data["test"].append((pts, new_label, cls))
        path = os.path.join(out, f"{way}way_{shot}shot", f"{fold}.pkl")
        with open(path, "wb") as f:
            pickle.dump(data, f)
        print(f"wrote {path}: {len(data['train'])} train / {len(data['test'])} test")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", default="data/ModelNetFewshot")
    ap.add_argument("--ways", nargs="+", type=int, default=[5, 10])
    ap.add_argument("--shots", nargs="+", type=int, default=[10, 20])
    ap.add_argument("--folds", type=int, default=10)
    args = ap.parse_args()
    for way in args.ways:
        for shot in args.shots:
            generate(args.root, args.out, way, shot, args.folds)


if __name__ == "__main__":
    main()
