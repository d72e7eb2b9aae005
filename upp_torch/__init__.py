"""UPP in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of the JAX package ``upp_tpu`` (which stays the reference): the same
module layout and names, the reference ``.pth`` key names, and the same
numerics up to float32 rounding. It runs UPP's two-phase workflow (prompter
pretraining, then PEFT classification training loading the prompters with
``--ckpts``) and robust classification inference. Its kernels
(``upp_torch/csrc``) run on a CUDA device; a tensor on the CPU takes each
kernel's plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when CUDA is wanted and absent — an entry point never falls back
    to the CPU on its own. On CUDA, TF32 is turned off for matmuls and
    convolutions: the JAX reference computes in full float32
    (``Precision.HIGHEST`` for the distance math); and bf16 products
    (``if_half``) reduce in float32 throughout, split-K partial sums
    included, before their one rounding."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "upp_torch: no CUDA device available; pass device='cpu' to "
                "run the plain PyTorch versions of the kernels")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
