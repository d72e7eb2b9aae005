"""TensorBoard scalar writers (a copy of ``upp_tpu/utils/writer.py``;
reference observability layer: tensorboardX train/val writers created in
``main.py:41-42``, per-batch Loss/TrainAcc/LR and per-epoch scalars in the
runners). Always writes a JSONL metrics file; TensorBoard event files too
when tensorboardX imports."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsWriter:
    """add_scalar-compatible writer: tensorboardX when present, JSONL always."""

    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, f"{name}_metrics.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(os.path.join(log_dir, name))
        except Exception:
            pass

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        self._jsonl.write(json.dumps({"t": time.time(), "tag": tag,
                                      "value": float(value), "step": int(step)})
                          + "\n")

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def make_writers(args) -> tuple:
    """(train_writer, val_writer) under args.tfboard_path (main.py:41-42)."""
    if not getattr(args, "tfboard_path", None):
        return None, None
    return (MetricsWriter(args.tfboard_path, "train"),
            MetricsWriter(args.tfboard_path, "test"))
