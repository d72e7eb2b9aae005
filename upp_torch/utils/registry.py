"""Name → class registry used by the model and dataset factories.

Plays the role of the reference's mmcv-style registry
(reference ``utils/registry.py:246-288``): objects are constructed from a
config dict by its ``NAME`` field. We keep only the surface actually used by
the reference (``register_module`` decorator + ``build_from_cfg``)."""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def get(self, key: str):
        return self._module_dict.get(key)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def register_module(self, name: Optional[str] = None, module: Any = None,
                        force: bool = False) -> Callable:
        """Register a class/function, usable as a decorator.

        ``@REG.register_module()`` registers under the class name;
        ``@REG.register_module('Alias')`` under an explicit name.
        """
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return _decorator

    def _register(self, module: Any, name: Optional[str], force: bool) -> None:
        if not (inspect.isclass(module) or inspect.isfunction(module)):
            raise TypeError(f"module must be a class or function, got {type(module)}")
        key = name if name is not None else module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f"{key} is already registered in {self._name}")
        self._module_dict[key] = module

    def build(self, cfg, **kwargs):
        return build_from_cfg(cfg, self, **kwargs)


def build_from_cfg(cfg, registry: Registry, **extra_kwargs):
    """Build an object from a config with a ``NAME`` field.

    Mirrors the dispatch of the reference's ``build_from_cfg``
    (``utils/registry.py:246-288``): ``cfg.NAME`` selects the class; the whole
    config node is passed as the first positional ``config`` argument, plus any
    extra kwargs (the dataset path uses ``others``)."""
    if cfg is None or "NAME" not in cfg:
        raise KeyError(f"config for registry {registry.name} needs a NAME field: {cfg}")
    name = cfg["NAME"]
    cls = registry.get(name)
    if cls is None:
        raise KeyError(f"{name} is not registered in {registry.name} "
                       f"(have: {sorted(registry.module_dict)})")
    return cls(cfg, **extra_kwargs)
