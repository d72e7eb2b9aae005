"""Process-aware logging (reference ``utils/logger.py:72-127``).

Rank-0 gets an optional FileHandler; non-zero ranks are silenced to ERROR.
The rank is ``torch.distributed``'s when a process group is up, else 0."""

from __future__ import annotations

import logging
from typing import Optional

_LOGGERS = set()


def _process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_logger(name: str = "upp_torch", log_file: Optional[str] = None,
               log_level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if name in _LOGGERS:
        return logger
    for h in logger.handlers:
        if isinstance(h, logging.StreamHandler):
            _LOGGERS.add(name)
            return logger

    stream = logging.StreamHandler()
    handlers = [stream]
    rank = _process_index()
    if rank == 0 and log_file is not None:
        handlers.append(logging.FileHandler(log_file, "w"))

    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    for h in handlers:
        h.setFormatter(fmt)
        h.setLevel(log_level if rank == 0 else logging.ERROR)
        logger.addHandler(h)
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    _LOGGERS.add(name)
    return logger


def get_root_logger(log_file: Optional[str] = None, log_level: int = logging.INFO,
                    name: str = "upp_torch"):
    return get_logger(name=name, log_file=log_file, log_level=log_level)


def print_log(msg: str, logger=None, level: int = logging.INFO) -> None:
    """Print to stdout (logger=None), a named/real logger, or swallow ('silent')."""
    if logger is None:
        print(msg)
    elif isinstance(logger, logging.Logger):
        logger.log(level, msg)
    elif logger == "silent":
        pass
    elif isinstance(logger, str):
        get_logger(logger).log(level, msg)
    else:
        raise TypeError(f"logger should be a Logger, str, 'silent' or None, got {type(logger)}")
