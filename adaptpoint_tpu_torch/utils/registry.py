"""String -> class registry with cfg-driven construction.

Parity with the reference registry (openpoints/utils/registry.py:8-294):
``Registry.register_module()`` decorator, ``build(cfg, default_args)`` where
``cfg['NAME']`` selects the class and the remaining keys are kwargs.
"""
from __future__ import annotations

import copy
import inspect
from typing import Any, Callable, Dict, Optional

__all__ = ["Registry", "build_from_cfg"]


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Callable]:
        return self._module_dict

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def _register(self, module: Callable, name: Optional[str] = None, force: bool = False):
        key = name or module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f"{key} is already registered in {self._name}")
        self._module_dict[key] = module

    def register_module(self, name: Optional[str] = None, module: Optional[Callable] = None,
                        force: bool = False):
        """Use as ``@REG.register_module()`` or ``REG.register_module(name=..., module=...)``."""
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(mod: Callable):
            self._register(mod, name=name, force=force)
            return mod

        return _decorator

    def build(self, cfg: dict, default_args: Optional[dict] = None) -> Any:
        return build_from_cfg(cfg, self, default_args)


def build_from_cfg(cfg: dict, registry: Registry, default_args: Optional[dict] = None) -> Any:
    """Build an object from ``cfg['NAME']`` with remaining keys as kwargs.

    Accepts any Mapping (an ``EasyConfig`` node or a plain dict)."""
    from collections.abc import Mapping
    if not isinstance(cfg, Mapping) or "NAME" not in cfg:
        raise ValueError(f"cfg must be a mapping containing 'NAME', got {cfg!r}")
    args = {k: copy.deepcopy(v) if not isinstance(v, Mapping) else dict(v)
            for k, v in dict(cfg).items()}
    name = args.pop("NAME")
    cls = registry.get(name)
    if cls is None:
        raise KeyError(f"{name} is not registered in {registry.name}; "
                       f"available: {sorted(registry.module_dict)}")
    if default_args:
        for k, v in default_args.items():
            args.setdefault(k, v)
    # drop kwargs the constructor doesn't accept unless it takes **kwargs
    try:
        sig = inspect.signature(cls.__init__ if inspect.isclass(cls) else cls)
        params = sig.parameters
        if not any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
            args = {k: v for k, v in args.items() if k in params}
    except (TypeError, ValueError):
        pass
    return cls(**args)
