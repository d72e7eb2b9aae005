"""Completion metrics and meters (counterpart of the pretask half of
``upp_tpu/train/metrics.py``): ``CD_Metric``
(``tools/runner_pretask.py:49-66``), F-Score / CDL1 / CDL2
(``utils/metrics.py``; EMD is not ported) and ``AverageMeter``."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.chamfer import chamfer_l1, chamfer_l2, nn_distance


class CDMetric:
    """Lower-is-better Chamfer metric holder."""

    def __init__(self, cd: float = float("inf")):
        self.cd = float(cd)

    def better_than(self, other: "CDMetric") -> bool:
        return self.cd < other.cd

    def state_dict(self) -> Dict[str, float]:
        return {"cd": self.cd}


def fscore(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 0.01) -> torch.Tensor:
    """Per-sample [B] F-Score@threshold (``utils/metrics.py:70-101``)."""
    d1, _, d2, _ = nn_distance(pred, gt)
    recall = (d2.sqrt() < threshold).float().mean(-1)
    precision = (d1.sqrt() < threshold).float().mean(-1)
    f = 2 * recall * precision / (recall + precision + 1e-12)
    return torch.where(recall + precision > 0, f, 0.0)


def completion_metrics(pred: torch.Tensor, gt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The F-Score / CDL1*1000 / CDL2*1000 table entries
    (``utils/metrics.py:37-44``)."""
    return {"F-Score": fscore(pred, gt).mean(),
            "CDL1": chamfer_l1(pred, gt) * 1000.0,
            "CDL2": chamfer_l2(pred, gt) * 1000.0}


class Metrics:
    """The completion-metric table: F-Score@0.01 (higher is better), CDL1
    and CDL2 x1000 (lower is better)."""

    ITEMS = [{"name": "F-Score", "higher_better": True},
             {"name": "CDL1", "higher_better": False},
             {"name": "CDL2", "higher_better": False}]

    @classmethod
    def names(cls):
        return [item["name"] for item in cls.ITEMS]


class AverageMeter:
    """Multi-item running averages (``utils/AverageMeter.py``)."""

    def __init__(self, items=None):
        self.items = items
        self.n = 1 if items is None else len(items)
        self.reset()

    def reset(self):
        self._sum = [0.0] * self.n
        self._count = [0] * self.n

    def update(self, values):
        if not isinstance(values, (list, tuple)):
            values = [values]
        for i, v in enumerate(values):
            self._sum[i] += float(v)
            self._count[i] += 1

    def update_vectors(self, vectors):
        """Batched update: each entry is a per-sample vector; the averages
        weigh a partial trailing batch by its size (the same as updating one
        sample at a time)."""
        for i, v in enumerate(vectors):
            v = np.asarray(v).reshape(-1)
            self._sum[i] += float(v.sum())
            self._count[i] += int(v.size)

    def count(self, idx=None):
        return self._count if idx is None else self._count[idx]

    def avg(self, idx=None):
        avgs = [self._sum[i] / max(self._count[i], 1) for i in range(self.n)]
        return avgs if idx is None else avgs[idx]
