"""The port's driver entry points on the CPU (``upp_torch/dryrun.py``, the
counterpart of ``__graft_entry__.py``): ``dryrun_multichip(2,
device="cpu")`` starts two gloo ranks and prints its three ``OK`` lines
(data parallel, dp1 x tp2, fsdp2; each loss within 1e-3 of the data
parallel one); ``entry`` at the tiny sizes gives finite logits; without a
card, neither runs unless told the CPU."""

import re

import pytest
import torch

from upp_torch import dryrun


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    losses = dryrun.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "2 ranks over gloo on cpu" in out
    for label in ("n_devices=2", "dp1xtp2", "fsdp2"):
        assert re.search(rf"\[dryrun_multichip\] {label} OK, loss=\d+\.\d+", out), label
    assert losses.keys() == {"dp", "tp", "fsdp"}
    assert max(abs(v - losses["dp"]) for v in losses.values()) < 1e-3
    print(out)


def test_entry_forward_at_tiny_sizes():
    fn, args = dryrun.entry(device="cpu", tiny=True)
    logits = fn(*args)
    assert logits.shape == (8, 6) and torch.isfinite(logits).all()
    assert dryrun._flagship_cfg().transformer_config.trans_dim == 384


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_no_silent_cpu_fallback():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
