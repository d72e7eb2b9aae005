#!/usr/bin/env bash
# Checkpoint evaluation recipes for the PyTorch port (the counterpart of the
# root test.sh). Expected reference OA: noisy ModelNet40 92.99, noisy
# ShapeNet55 90.40, ScanObjectNN OBJ_ONLY 91.39. Run from the repository's
# root: test.sh [CKPT.pth] [more arguments].
set -e

python -m upp_torch.main --test --peft_model --config cfgs/unify_modelnet_cls.yaml \
    --ckpts "${1:-experiments/unify_modelnet_cls/ckpt-best.pth}" "${@:2}"
# python -m upp_torch.main --test --peft_model --config cfgs/unify_shapenet55_cls.yaml --ckpts <ckpt>
# python -m upp_torch.main --test --peft_model --config cfgs/unify_scan_objonly_cls.yaml --ckpts <ckpt>
