"""YAML-chain config system (the port's own copy of
envgs_tpu/engine/config.py; `yaml` is imported by the functions that parse
or write YAML, so a config built in code needs no yaml):

- `configs: [parent1.yaml, parent2.yaml]` multi-parent inheritance, merged in
  order, child recursively overwrites parents;
- `_delete_: True` severs inheritance for a subtree;
- `_append_: [..]` extends an inherited list;
- numeric string keys index into inherited lists;
- `{{fileBasenameNoExtension}}` substitution;
- CLI `a.b.c=value` dotted overrides with YAML-parsed values.

"""
from __future__ import annotations

import copy
import os
import re
from typing import Any

DELETE_KEY = "_delete_"
APPEND_KEY = "_append_"


class Config(dict):
    """dict with attribute access, recursively (a functional dotdict)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict) and not isinstance(obj, Config):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, Config):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_dict(self):
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)

    def dump(self, path: str):
        import yaml

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


def _merge(base: Any, child: Any) -> Any:
    """Recursively merge `child` onto `base` (child wins)."""
    if isinstance(child, dict):
        if child.get(DELETE_KEY, False):
            child = {k: v for k, v in child.items() if k != DELETE_KEY}
            return _merge({}, child)
        if not isinstance(base, dict):
            # numeric keys may index into an inherited list
            if isinstance(base, list) and all(
                isinstance(k, (int,)) or (isinstance(k, str) and k.isdigit())
                for k in child.keys() if k != APPEND_KEY
            ) and len(child):
                out = list(base)
                for k, v in child.items():
                    if k == APPEND_KEY:
                        out.extend(v if isinstance(v, list) else [v])
                    else:
                        out[int(k)] = _merge(base[int(k)], v)
                return out
            base = {}
        out = dict(base)
        for k, v in child.items():
            if k == APPEND_KEY:
                continue
            out[k] = _merge(base.get(k), v)
        return out
    if isinstance(child, list) and isinstance(base, list):
        return copy.deepcopy(child)
    return copy.deepcopy(child)


def _substitute(text: str, path: str) -> str:
    base = os.path.splitext(os.path.basename(path))[0]
    return text.replace("{{fileBasenameNoExtension}}", base)


def _load_file(path: str, root: str | None = None) -> dict:
    import yaml

    with open(path) as f:
        text = _substitute(f.read(), path)
    cfg = yaml.safe_load(text) or {}
    parents = cfg.pop("configs", [])
    if isinstance(parents, str):
        parents = [parents]
    merged: dict = {}
    for p in parents:
        if not os.path.isabs(p):
            # parents are repo-root-relative (the configs' convention), falling
            # back to sibling-relative
            cand = os.path.join(root, p) if root else p
            if not os.path.exists(cand):
                cand = os.path.join(os.path.dirname(path), p)
            p = cand
        merged = _merge(merged, _load_file(p, root=root))
    return _merge(merged, cfg)


def _parse_value(v: str) -> Any:
    import yaml

    try:
        return yaml.safe_load(v)
    except yaml.YAMLError:
        return v


def merge_dotted(cfg: dict, overrides: list[str] | dict) -> dict:
    """Apply `a.b.c=value` CLI overrides (DictAction semantics)."""
    if isinstance(overrides, dict):
        items = overrides.items()
    else:
        items = []
        for ov in overrides:
            k, _, v = ov.partition("=")
            items.append((k, _parse_value(v)))
    for k, v in items:
        node = cfg
        parts = k.split(".")
        for p in parts[:-1]:
            if isinstance(node, list):
                node = node[int(p)]
            else:
                node = node.setdefault(p, {})
        last = parts[-1]
        if isinstance(node, list):
            node[int(last)] = v
        else:
            node[last] = v
    return cfg


def load_config(paths: str | list[str], overrides: list[str] | None = None,
                root: str | None = None) -> Config:
    """Load a comma-separated / list config chain + dotted CLI overrides."""
    if isinstance(paths, str):
        paths = [p for p in paths.split(",") if p]
    merged: dict = {}
    for p in paths:
        merged = _merge(merged, _load_file(p, root=root))
    if overrides:
        merged = merge_dotted(merged, overrides)
    return Config.wrap(merged)
