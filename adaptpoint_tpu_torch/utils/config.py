"""Hierarchical YAML config with recursive `default.yaml` inheritance and CLI overrides.

Behavioral parity with the reference EasyConfig
(reference: openpoints/utils/config.py:18-113): a config file is merged on top of
every `default.yaml` found while walking from the repo root down to the config's
directory; CLI overrides are `key=value` / `key.sub=value` strings whose values
are parsed with ``ast.literal_eval`` (falling back to raw strings).
"""
from __future__ import annotations

import ast
import hashlib
import os
from typing import Any, Iterable, Optional

import yaml

__all__ = ["EasyConfig"]


class EasyConfig(dict):
    """A dict with attribute access and recursive-default YAML loading."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:  # attribute protocol requires AttributeError
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    # ------------------------------------------------------------------ load
    def load(self, fname: str, *, recursive: bool = False) -> None:
        """Load a YAML file into this config.

        If ``recursive`` is True, first merge every ``default.yaml`` found in
        the ancestor directories of ``fname`` (top-most first), then the file
        itself — matching the reference's recursive default inheritance.
        """
        fname = os.path.abspath(os.path.expanduser(fname))
        if recursive:
            defaults = []
            d = os.path.dirname(fname)
            # walk upward collecting default.yaml files
            while True:
                cand = os.path.join(d, "default.yaml")
                if os.path.isfile(cand) and cand != fname:
                    defaults.append(cand)
                parent = os.path.dirname(d)
                if parent == d or os.path.basename(d) in ("", "cfgs"):
                    break
                d = parent
            for cand in reversed(defaults):  # top-most (most generic) first
                self._merge_file(cand)
        self._merge_file(fname)

    def _merge_file(self, fname: str) -> None:
        with open(fname, "r") as f:
            cfg = yaml.safe_load(f) or {}
        _merge_into(self, cfg)

    # --------------------------------------------------------------- update
    def update(self, other=None, **kwargs) -> None:  # type: ignore[override]
        if other is not None:
            if isinstance(other, str):
                # CLI "key=value" override
                self._apply_override(other)
                return
            if isinstance(other, dict):
                _merge_into(self, other)
            else:
                for item in other:
                    self.update(item)
        if kwargs:
            _merge_into(self, kwargs)

    def update_opts(self, opts: Optional[Iterable[str]]) -> None:
        """Apply a list of ``key=value`` CLI overrides (dot-paths allowed)."""
        for opt in opts or []:
            self._apply_override(opt)

    def _apply_override(self, opt: str) -> None:
        if "=" not in opt:
            raise ValueError(f"override must be key=value, got {opt!r}")
        key, value = opt.split("=", 1)
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass  # keep raw string
        node: dict = self
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = EasyConfig()
                node[p] = nxt
            node = nxt
        node[parts[-1]] = value

    # ----------------------------------------------------------------- misc
    def get(self, key: str, default: Any = None) -> Any:  # type: ignore[override]
        return super().get(key, default)

    def hash(self) -> str:
        return hashlib.md5(repr(sorted(_flatten(self))).encode()).hexdigest()[:8]

    def to_dict(self) -> dict:
        return _to_plain(self)

    def dump(self, fname: str) -> None:
        with open(fname, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


def _merge_into(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            cur = dst.get(k)
            if isinstance(cur, dict):
                _merge_into(cur, v)
            else:
                node = EasyConfig()
                _merge_into(node, v)
                dst[k] = node
        else:
            dst[k] = v


def _to_plain(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _to_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_plain(v) for v in x]
    return x


def _flatten(d: dict, prefix: str = ""):
    out = []
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(_flatten(v, key))
        else:
            out.append((key, repr(v)))
    return out
