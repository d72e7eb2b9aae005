"""Classification, segmentation and completion metrics and meters
(counterpart of ``upp_tpu/train/metrics.py``): the cross-entropy loss and
accuracy (``get_loss_acc``), the per-point NLL of segmentation and the
ShapeNetPart mIoU suite (``tools/runner_unify_seg.py:301-368``; numpy, a
copy of the JAX package's), ``Acc_Metric``, ``CD_Metric``
(``tools/runner_pretask.py:32-66``), F-Score / CDL1 / CDL2
(``utils/metrics.py``, with the EMD entry of ``Metrics.get``) and
``AverageMeter``."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.chamfer import chamfer_l1, chamfer_l2, nn_distance
from ..ops.emd import earth_mover_distance


def cross_entropy_loss_acc(logits: torch.Tensor, labels: torch.Tensor):
    """(mean cross-entropy, accuracy x100) of ``logits`` [B, C] against
    integer ``labels`` [B] (``Point_MAE_unify.py:499-503``)."""
    labels = labels.long()
    logp = F.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean() * 100.0
    return loss, acc


def nll_seg_loss(log_probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean NLL of per-point log-probabilities [B, N, C] at the integer
    part labels [B, N] (``Point_MAE_unify_segment.py:619-625``)."""
    return -log_probs.gather(-1, target.long()[..., None]).mean()


def seg_miou_metrics(preds: np.ndarray, targets: np.ndarray,
                     cls_labels: np.ndarray,
                     seg_classes: Dict[str, Sequence[int]]) -> Dict[str, float]:
    """ShapeNetPart mIoU suite (``tools/runner_unify_seg.py:301-368``):
    accuracy, class-avg accuracy, class-avg mIoU, instance-avg mIoU.

    Args:
      preds/targets: [num_samples, N] int part labels (preds already argmaxed
        *within* each object's category part range, as the reference does).
      cls_labels: [num_samples] int category index.
    """
    cat_names = list(seg_classes.keys())
    shape_ious: Dict[str, list] = {c: [] for c in cat_names}
    label_to_cat = {}
    for cat, parts in seg_classes.items():
        for p in parts:
            label_to_cat[p] = cat

    total_correct = 0
    total_seen = 0
    seen_per_cat = np.zeros(len(cat_names))
    correct_per_cat = np.zeros(len(cat_names))

    for i in range(preds.shape[0]):
        seg_pred, seg_gt = preds[i], targets[i]
        cat = label_to_cat[int(seg_gt[0])]
        total_correct += int((seg_pred == seg_gt).sum())
        total_seen += seg_gt.size
        ci = cat_names.index(cat)
        seen_per_cat[ci] += seg_gt.size
        correct_per_cat[ci] += int((seg_pred == seg_gt).sum())

        part_ious = []
        for part in seg_classes[cat]:
            p_and = np.sum((seg_gt == part) & (seg_pred == part))
            p_or = np.sum((seg_gt == part) | (seg_pred == part))
            part_ious.append(1.0 if p_or == 0 else p_and / float(p_or))
        shape_ious[cat].append(np.mean(part_ious))

    all_ious = [iou for vals in shape_ious.values() for iou in vals]
    cat_ious = {c: np.mean(v) for c, v in shape_ious.items() if v}
    return {
        "accuracy": total_correct / max(total_seen, 1),
        "class_avg_accuracy": float(np.mean(
            correct_per_cat[seen_per_cat > 0] / seen_per_cat[seen_per_cat > 0])),
        "class_avg_iou": float(np.mean(list(cat_ious.values()))) if cat_ious else 0.0,
        "instance_avg_iou": float(np.mean(all_ious)) if all_ious else 0.0,
        "per_category_iou": {c: float(v) for c, v in cat_ious.items()},
    }


class AccMetric:
    """Higher-is-better accuracy holder (``tools/runner.py:13-31``)."""

    def __init__(self, acc: float = 0.0):
        self.acc = float(acc)

    def better_than(self, other: "AccMetric") -> bool:
        return self.acc > other.acc

    def state_dict(self) -> Dict[str, float]:
        return {"acc": self.acc}


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
    and CDL2 x1000 (lower is better). The reference defines and disables an
    EMD entry (``metrics.py:37-44``); ``get(..., require_emd=True)``
    appends it, x1000, as the JAX package does."""

    ITEMS = [{"name": "F-Score", "higher_better": True},
             {"name": "CDL1", "higher_better": False},
             {"name": "CDL2", "higher_better": False}]

    @classmethod
    def names(cls):
        return [item["name"] for item in cls.ITEMS]

    @classmethod
    def get(cls, pred: torch.Tensor, gt: torch.Tensor, require_emd: bool = False):
        """[F-Score, CDL1, CDL2] (then EMD x1000 with ``require_emd``) of
        ``pred`` [B, N, 3] against ``gt`` [B, M, 3] as floats, batch-meaned."""
        with torch.no_grad():
            vals = completion_metrics(pred, gt)
            out = [float(vals[n]) for n in cls.names()]
            if require_emd:
                out.append(float(earth_mover_distance(pred, gt)) * 1000.0)
        return out

    @classmethod
    def better_than(cls, name: str, a: float, b: float) -> bool:
        """Whether value ``a`` of metric ``name`` beats ``b``."""
        spec = next(i for i in cls.ITEMS if i["name"] == name)
        return a > b if spec["higher_better"] else a < b


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
