"""The port's asynchronous checkpoint writer (``upp_torch/train/checkpoint.py``):
the five cases of ``tests/test_ckpt_async.py`` (the JAX package's writer),
with ``torch.save`` replaced by a slow stub, and a failure joined after its
writer ended. A save returns at once, writes on a writer thread per path,
keeps only the newest snapshot queued while a write is in flight, and
``wait_for_pending_saves`` re-raises a failed write."""

import threading
import time

import pytest
import torch
from torch import nn

from upp_torch.train import checkpoint as ckpt


class _SlowStubSave:
    """``torch.save`` that sleeps, fails at the epochs in ``fail_on``, else
    writes an empty file and logs (path, epoch)."""

    def __init__(self, log, delay, fail_on=()):
        self.log, self.delay, self.fail_on = log, delay, set(fail_on)

    def __call__(self, payload, f):
        time.sleep(self.delay)
        if payload["epoch"] in self.fail_on:
            raise IOError(f"stub failure at epoch {payload['epoch']}")
        open(f, "wb").close()
        self.log.append((str(f).split(".pth.")[0] + ".pth", payload["epoch"]))


def _state(step):
    model = nn.Linear(2, 2)
    with torch.no_grad():
        model.weight.fill_(float(step))
    return model, torch.optim.SGD(model.parameters(), lr=0.1)


@pytest.fixture
def stub(monkeypatch):
    log = []
    holder = {"save": _SlowStubSave(log, delay=0.15)}
    monkeypatch.setattr(ckpt.torch, "save", lambda *a, **kw: holder["save"](*a, **kw))
    yield log, holder
    ckpt.wait_for_pending_saves()


def _save(step, tmp_path, prefix="ckpt-last", state=None, **kw):
    ckpt.save_checkpoint(*(state or _state(step)), epoch=step, prefix=prefix,
                         experiment_path=str(tmp_path), logger="silent", **kw)


def test_rapid_saves_do_not_block_and_coalesce_latest_wins(stub, tmp_path):
    log, _ = stub
    states = [_state(step) for step in range(6)]
    t0 = time.perf_counter()
    for step in range(6):
        _save(step, tmp_path, state=states[step])
    issue_time = time.perf_counter() - t0
    # 6 saves x 0.15 s of writing: the training thread must not wait on them
    assert issue_time < 0.4, f"save_checkpoint blocked the caller: {issue_time:.2f}s"
    ckpt.wait_for_pending_saves()
    steps = [s for _, s in log]
    assert steps[0] == 0 and steps[-1] == 5   # the first and the newest land
    assert len(steps) < 6                      # superseded snapshots were dropped
    assert steps == sorted(steps)              # never out of order on one path
    assert (tmp_path / "ckpt-last.pth").exists()


def test_distinct_paths_do_not_coalesce(stub, tmp_path):
    log, _ = stub
    _save(1, tmp_path, prefix="ckpt-best")
    _save(2, tmp_path, prefix="ckpt-last")
    ckpt.wait_for_pending_saves()
    assert sorted(s for _, s in log) == [1, 2]
    assert len({p for p, _ in log}) == 2


def test_block_save_drains_chain_and_writes_synchronously(stub, tmp_path):
    log, _ = stub
    _save(1, tmp_path)
    _save(2, tmp_path)
    _save(3, tmp_path, block=True)
    # block=True returns only after its own write landed, superseding the queue
    assert log[-1][1] == 3
    ckpt.wait_for_pending_saves()
    assert log[-1][1] == 3


def test_queued_write_failure_surfaces_on_join(stub, tmp_path):
    log, holder = stub
    holder["save"] = _SlowStubSave(log, delay=0.15, fail_on={2})
    _save(1, tmp_path)
    _save(2, tmp_path)    # queued while epoch 1 is written; its failure must not vanish
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ckpt.wait_for_pending_saves()


def test_first_write_failure_surfaces_on_join(stub, tmp_path):
    log, holder = stub
    holder["save"] = _SlowStubSave(log, delay=0.01, fail_on={7})
    _save(7, tmp_path)
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ckpt.wait_for_pending_saves()


def test_a_failure_surfaces_on_join_after_its_writer_ended(stub, tmp_path):
    """The chain's one write fails and its writer thread ends before the
    join: the join still re-raises."""
    log, holder = stub
    holder["save"] = _SlowStubSave(log, delay=0.0, fail_on={7})
    _save(7, tmp_path)
    path = ckpt.checkpoint_path(str(tmp_path), "ckpt-last")
    writers = [t for t in threading.enumerate() if t.name == f"ckpt-writer {path}"]
    for t in writers:
        t.join(timeout=10)
        assert not t.is_alive()
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ckpt.wait_for_pending_saves()
