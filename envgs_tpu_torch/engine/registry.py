"""Config-driven calls (the port's own copy of `call_filtered` of
envgs_tpu/engine/registry.py; the name -> constructor registries are not
ported, the port builds its few components directly)."""
from __future__ import annotations

import inspect
import warnings
from typing import Any, Callable


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
