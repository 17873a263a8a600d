"""Python-file config system (the port's copy of
``scenesplat_tpu/utils/config.py``, which reads the repo's config files as
they are).

Configs are plain Python files whose module-level variables become config
entries. Supports the same user surface as the reference
(reference: pointcept/utils/config.py:70-695):

  - ``_base_ = ["../_base_/default_runtime.py"]`` list inheritance with deep
    dict merge (child overrides base; ``_delete_=True`` in a child dict
    replaces instead of merging),
  - CLI overrides via dotted keys, e.g. ``--options model.backbone.depth=4``,
  - attribute-style access (``cfg.model.backbone``) and ``dump()``.
"""

from __future__ import annotations

import ast
import copy
import os
import pprint
import sys
import types
import uuid
from typing import Any, Dict, List, Optional

_DELETE_KEY = "_delete_"
_RESERVED = ("_base_",)


class ConfigDict(dict):
    """dict with attribute access that recursively wraps nested dicts."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = _wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def __deepcopy__(self, memo):
        out = ConfigDict()
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return out

    def get(self, key, default=None):
        return super().get(key, default)


def _wrap(value):
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, dict):
        return ConfigDict({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value


def _merge_dict(base: dict, override: dict) -> dict:
    """Deep-merge ``override`` into ``base`` (returns a new dict)."""
    merged = copy.deepcopy(dict(base))
    for key, val in override.items():
        if (
            key in merged
            and isinstance(merged[key], dict)
            and isinstance(val, dict)
            and not val.get(_DELETE_KEY, False)
        ):
            merged[key] = _merge_dict(merged[key], val)
        else:
            if isinstance(val, dict):
                val = {k: v for k, v in val.items() if k != _DELETE_KEY}
            merged[key] = copy.deepcopy(val)
    return merged


def _exec_py_file(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    if not os.path.isfile(filename):
        raise FileNotFoundError(f"config file not found: {filename}")
    module_name = f"_cfg_{uuid.uuid4().hex}"
    module = types.ModuleType(module_name)
    module.__file__ = filename
    with open(filename, "r") as f:
        code = f.read()
    sys.modules[module_name] = module
    try:
        exec(compile(code, filename, "exec"), module.__dict__)
        cfg = {
            k: v
            for k, v in module.__dict__.items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)
        }
    finally:
        del sys.modules[module_name]
    return cfg


def _load_with_bases(filename: str) -> Dict[str, Any]:
    cfg = _exec_py_file(filename)
    bases = cfg.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for base in bases:
        base_path = os.path.join(os.path.dirname(os.path.abspath(filename)), base)
        merged = _merge_dict(merged, _load_with_bases(base_path))
    return _merge_dict(merged, cfg)


def _parse_value(text: str):
    """Parse a CLI override value: python literal if possible, else string."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


class Config:
    """A loaded config; behaves like a ConfigDict with helpers."""

    def __init__(self, cfg_dict: Optional[dict] = None, filename: Optional[str] = None):
        object.__setattr__(self, "_cfg", _wrap(cfg_dict or {}))
        object.__setattr__(self, "_filename", filename)

    # ---- loading -------------------------------------------------------
    @staticmethod
    def fromfile(filename: str) -> "Config":
        return Config(_load_with_bases(filename), filename=filename)

    # ---- mapping / attribute protocol ----------------------------------
    @property
    def filename(self):
        return self._filename

    def __getattr__(self, name):
        try:
            return self._cfg[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self._cfg[name] = value

    def __getitem__(self, key):
        return self._cfg[key]

    def __setitem__(self, key, value):
        self._cfg[key] = value

    def __contains__(self, key):
        return key in self._cfg

    def __iter__(self):
        return iter(self._cfg)

    def get(self, key, default=None):
        return self._cfg.get(key, default)

    def keys(self):
        return self._cfg.keys()

    def items(self):
        return self._cfg.items()

    def pop(self, key, *default):
        return self._cfg.pop(key, *default)

    def setdefault(self, key, default=None):
        if key not in self._cfg:
            self._cfg[key] = default
        return self._cfg[key]

    def to_dict(self) -> dict:
        return copy.deepcopy(dict(self._cfg))

    def __repr__(self):
        return f"Config(file={self._filename}):\n{pprint.pformat(dict(self._cfg))}"

    # ---- CLI overrides ---------------------------------------------------
    def merge_from_options(self, options: Optional[List[str] or dict]):
        """Apply ``a.b.c=value`` overrides (list of strings or dict)."""
        if not options:
            return self
        if isinstance(options, dict):
            items = options.items()
        else:
            items = []
            for opt in options:
                if "=" not in opt:
                    raise ValueError(f"option must look like key=value: {opt}")
                k, v = opt.split("=", 1)
                items.append((k, _parse_value(v)))
        for dotted, value in items:
            keys = dotted.split(".")
            node = self._cfg
            for k in keys[:-1]:
                if k not in node or not isinstance(node[k], dict):
                    node[k] = ConfigDict()
                node = node[k]
            node[keys[-1]] = value
        return self

    # ---- persistence -----------------------------------------------------
    def dump(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for key, value in self._cfg.items():
                f.write(f"{key} = {pprint.pformat(value, sort_dicts=False)}\n")
