"""Name -> constructor registries with config-driven build (the port's own
copy of envgs_tpu/engine/registry.py): `build` pops `type`, filters the
keyword arguments by the constructor's signature (warning on, not
rejecting, unknown keys), and `type=None` builds to None.
`register_lazy(name, "module:attr")` registers a name whose object is
imported at its first `get` (models/__init__.py registers the model zoo so,
without importing every model module with the package)."""
from __future__ import annotations

import importlib
import inspect
import warnings
from typing import Any, Callable


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._modules: dict[str, Callable] = {}

    def register(self, cls=None, *, name: str | None = None):
        def _do(c):
            key = name or c.__name__
            if key in self._modules and self._modules[key] is not c:
                warnings.warn(f"{self.name}: overriding registration of {key}")
            self._modules[key] = c
            return c

        return _do(cls) if cls is not None else _do

    def register_lazy(self, name: str, target: str):
        """`name` -> the attribute `target` = "package.module:attr",
        imported when first asked for."""
        self._modules[name] = target

    def get(self, key: str) -> Callable:
        if key not in self._modules:
            raise KeyError(
                f"{key!r} not registered in {self.name} "
                f"(available: {sorted(self._modules)})")
        obj = self._modules[key]
        if isinstance(obj, str):
            module, attr = obj.split(":")
            obj = self._modules[key] = getattr(
                importlib.import_module(module), attr)
        return obj

    def __contains__(self, key):
        return key in self._modules

    def build(self, cfg: dict | None, **extra) -> Any:
        if cfg is None:
            return None
        cfg = dict(cfg)
        typ = cfg.pop("type", None)
        if typ is None:
            return None
        ctor = self.get(typ) if isinstance(typ, str) else typ
        return call_filtered(ctor, {**cfg, **extra},
                             context=f"{self.name}.{typ}")


def call_filtered(fn: Callable, kwargs: dict, context: str = "") -> Any:
    """Call fn with kwargs filtered to its signature (warn on extras)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return fn(**kwargs)
    if any(p.kind == inspect.Parameter.VAR_KEYWORD
           for p in sig.parameters.values()):
        return fn(**kwargs)
    valid = set(sig.parameters)
    unused = [k for k in kwargs if k not in valid]
    if unused:
        warnings.warn(f"{context}: ignoring unused config keys {unused}")
    return fn(**{k: v for k, v in kwargs.items() if k in valid})
