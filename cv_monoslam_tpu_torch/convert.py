"""Carry a filter state across as plain numpy arrays.

``state_from_arrays`` builds the port's :class:`FilterState` from a dict of
dotted field paths (``"x"``, ``"S"``, ``"lm.active"``, ...,
``"stored.sr"``), and ``state_to_arrays`` is its inverse. Any engine whose
state has the same fields (the JAX package's ``FilterState`` does) can be
flattened into that dict; this module sees only numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .filter.state import FilterState, LandmarkTable, StoredTable

_TABLES = {"lm": LandmarkTable, "stored": StoredTable}


def state_from_arrays(arrays: Dict[str, np.ndarray], device) -> FilterState:
    """dotted-path dict of arrays -> FilterState on ``device``; dtypes are
    kept (bool, int32, float32/float64). Raises on a missing or unknown
    field."""
    def t(key):
        return torch.as_tensor(np.array(arrays[key]), device=device)

    known = set()
    kw = {}
    for f in dataclasses.fields(FilterState):
        if f.name in _TABLES:
            sub = {}
            for g in dataclasses.fields(_TABLES[f.name]):
                key = f"{f.name}.{g.name}"
                sub[g.name] = t(key)
                known.add(key)
            kw[f.name] = _TABLES[f.name](**sub)
        else:
            kw[f.name] = t(f.name)
            known.add(f.name)
    extra = set(arrays) - known
    if extra:
        raise KeyError(f"unknown state fields {sorted(extra)}")
    return FilterState(**kw)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
    return np.array(v)              # a writable copy, never a view


def state_to_arrays(state) -> Dict[str, np.ndarray]:
    """FilterState -> dotted-path dict of numpy arrays (host copies).

    Reads fields by name, so any state object with the same dataclass
    fields and array-like leaves flattens the same way."""
    out = {}
    for f in dataclasses.fields(FilterState):
        v = getattr(state, f.name)
        if f.name in _TABLES:
            for g in dataclasses.fields(_TABLES[f.name]):
                out[f"{f.name}.{g.name}"] = _host(getattr(v, g.name))
        else:
            out[f.name] = _host(v)
    return out
