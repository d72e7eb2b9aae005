"""YAML config system with recursive ``_base_`` file inclusion.

API-compatible with the reference's config layer
(reference ``utils/config.py:18-63``): a config file may reference other
YAML files through a ``_base_`` key; the included file is loaded and stored
*under* the ``_base_`` key (so e.g. ``config.dataset.train._base_.N_POINTS``
resolves). All nodes support attribute access."""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict

import yaml


class ConfigDict(dict):
    """dict with attribute access (drop-in for easydict.EasyDict)."""

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        import copy
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @classmethod
    def from_nested(cls, d: Dict) -> "ConfigDict":
        out = cls()
        for k, v in d.items():
            out[k] = cls.from_nested(v) if isinstance(v, dict) else v
        return out

    def to_plain(self) -> Dict:
        return {k: (v.to_plain() if isinstance(v, ConfigDict) else v)
                for k, v in self.items()}


def to_config(obj) -> "ConfigDict":
    """Coerce any nested mapping (dict / ConfigDict) into an
    attribute-accessible ConfigDict."""
    from collections.abc import Mapping
    if isinstance(obj, ConfigDict):
        return obj
    if isinstance(obj, Mapping):
        out = ConfigDict()
        for k, v in obj.items():
            out[k] = to_config(v) if isinstance(v, Mapping) else v
        return out
    raise TypeError(f"cannot coerce {type(obj)} to ConfigDict")


def _load_yaml(path: str) -> Dict:
    with open(path, "r") as f:
        return yaml.load(f, Loader=yaml.FullLoader)


def merge_new_config(config: ConfigDict, new_config: Dict, base_dir: str = ".") -> ConfigDict:
    """Recursively merge ``new_config`` into ``config``.

    ``_base_: <path>`` entries load ``<path>`` (relative paths are tried both
    as-is and relative to ``base_dir``) and nest its contents under the
    ``_base_`` key, exactly like the reference (``utils/config.py:18-35``)."""
    for key, val in new_config.items():
        if not isinstance(val, dict):
            if key == "_base_":
                base_path = val
                if not os.path.exists(base_path):
                    candidate = os.path.join(base_dir, val)
                    if os.path.exists(candidate):
                        base_path = candidate
                config[key] = ConfigDict()
                merge_new_config(config[key], _load_yaml(base_path), base_dir=base_dir)
            else:
                config[key] = val
            continue
        if key not in config or not isinstance(config.get(key), ConfigDict):
            config[key] = ConfigDict()
        merge_new_config(config[key], val, base_dir=base_dir)
    return config


def cfg_from_yaml_file(cfg_file: str) -> ConfigDict:
    config = ConfigDict()
    # _base_ paths in the shipped cfgs are repo-root-relative ("cfgs/...");
    # resolve them relative to the directory *containing* cfgs/ as a fallback
    # so configs work regardless of the CWD.
    base_dir = os.path.dirname(os.path.dirname(os.path.abspath(cfg_file)))
    merge_new_config(config, _load_yaml(cfg_file), base_dir=base_dir)
    return config


def get_config(args, logger=None) -> ConfigDict:
    """Load config for a run; on ``--resume`` re-read the saved snapshot
    (reference ``utils/config.py:47-58``)."""
    if getattr(args, "resume", False):
        cfg_path = os.path.join(args.experiment_path, "config.yaml")
        if not os.path.exists(cfg_path):
            raise FileNotFoundError(f"cannot resume: no saved config at {cfg_path}")
        args.config = cfg_path
    config = cfg_from_yaml_file(args.config)
    if not getattr(args, "resume", False) and getattr(args, "experiment_path", None):
        save_experiment_config(args)
    return config


def save_experiment_config(args) -> None:
    dst = os.path.join(args.experiment_path, "config.yaml")
    os.makedirs(args.experiment_path, exist_ok=True)
    if os.path.abspath(args.config) != os.path.abspath(dst):
        shutil.copy(args.config, dst)


def log_args_to_file(args, pre="args", logger=None):
    from .logger import print_log
    for key, val in vars(args).items():
        print_log(f"{pre}.{key} : {val}", logger=logger)


def log_config_to_file(cfg, pre="cfg", logger=None):
    from .logger import print_log
    for key, val in cfg.items():
        if isinstance(val, dict):
            log_config_to_file(val, pre=f"{pre}.{key}", logger=logger)
        else:
            print_log(f"{pre}.{key} : {val}", logger=logger)
