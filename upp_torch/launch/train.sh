#!/usr/bin/env bash
# Reproduction recipes for the PyTorch port (the counterpart of the root
# train.sh): prompter pretraining per backbone and dataset, then the
# unify / PEFT phase on the resulting prompter base. Run from the
# repository's root; extra arguments go to the PEFT command (--device cpu,
# --launcher pytorch under torchrun, ...).
set -e

# ---- phase 1: prompter pretraining (pretask) ------------------------------
# ModelNet40 prompters
# python -m upp_torch.main --config cfgs/pretask_modelnet.yaml --ckpts pretrained_bases/mae_base.pth
# python -m upp_torch.main --config cfgs/pretask_modelnet.yaml --ckpts pretrained_bases/recon_base.pth
# python -m upp_torch.main --config cfgs/pretask_modelnet.yaml --ckpts pretrained_bases/femae_base.pth
# ShapeNet55 prompters
# python -m upp_torch.main --config cfgs/pretask_shapenet.yaml --ckpts pretrained_bases/mae_base.pth
# ScanObjectNN prompters
# python -m upp_torch.main --config cfgs/pretask_scan_objonly.yaml --ckpts pretrained_bases/femae_base.pth

# ---- phase 2: unify / PEFT -------------------------------------------------
python -m upp_torch.main --peft_model --config cfgs/unify_modelnet_cls.yaml \
    --ckpts prompter_bases/mae-modelnet-2.349.pth "$@"
# python -m upp_torch.main --peft_model --config cfgs/unify_shapenet55_cls.yaml \
#     --ckpts prompter_bases/mae-shapenet-1.521.pth
# python -m upp_torch.main --peft_model --config cfgs/unify_scan_objonly_cls.yaml \
#     --ckpts prompter_bases/femae-objonly-2.963.pth
# python -m upp_torch.main --peft_model --config cfgs/unify_shapenetpart_seg.yaml \
#     --ckpts prompter_bases/mae-shapenetpart.pth

# ---- data parallel over N cards (one process each) -------------------------
# python -m torch.distributed.run --standalone --nproc_per_node N -m upp_torch.main \
#     --launcher pytorch --peft_model --config cfgs/unify_modelnet_cls.yaml \
#     --ckpts prompter_bases/mae-modelnet-2.349.pth
