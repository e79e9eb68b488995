"""Gates read on the host, as the port's eager route reads them.

Frozen from the port's ``ops/control.py`` with everything that captures a
CUDA graph taken out: a gate's predicate is read on the host and one
branch runs; a constant is a new tensor."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


def host_bool(pred) -> bool:
    return bool(pred)


def card(device) -> torch.device:
    return torch.device(device)


def if_(pred, body: Callable[[], Any]) -> Optional[bool]:
    """Run ``body()`` (in-place writes) when ``pred`` holds; returns
    ``pred`` as read."""
    taken = host_bool(pred)
    if taken:
        body()
    return taken


def cond(pred, true_fn: Callable, false_fn: Callable,
         operands: tuple = ()):
    return true_fn(*operands) if host_bool(pred) else false_fn(*operands)


def leaves(obj) -> list:
    """The tensors of ``obj`` in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in leaves(o)]
    if isinstance(obj, dict):
        return [t for k in obj for t in leaves(obj[k])]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in leaves(getattr(obj, f.name))]
    if obj is None:
        return []
    raise TypeError(f"not a tensor or a structure of tensors: {type(obj)}")


def tree_map(fn: Callable, obj):
    """``obj`` with every tensor ``t`` replaced by ``fn(t)``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_map(fn, o) for o in obj)
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    raise TypeError(f"not a tensor or a structure of tensors: {type(obj)}")


def cached(key, build: Callable[[], torch.Tensor]) -> torch.Tensor:
    return build()


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)
