"""Checkpoint / resume.

Saves the complete run state — every leaf of the :class:`FilterState`, the
frame counter, the config as JSON — as a single NPZ written under a
temporary name and renamed into place, so a reader never sees a torn file.
Every leaf round-trips exactly.

File layout: ``leaf_0`` .. ``leaf_{n-1}`` are the state's leaves in the
order ``convert.state_to_arrays`` yields them (dataclass field order: ``x``,
``S``, the landmark table, the stored table, the counters), ``counter`` is an
int64 scalar and ``meta`` the UTF-8 bytes of ``{"config": ..., "n_leaves":
n, "extra": ...}``. That is the layout the JAX package writes (its pytree
flattens in the same field order and its config has the same fields), so the
two packages' checkpoint files are interchangeable: each loads what the other
saved (``tests/test_torch_runtime.py`` holds both directions).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import SlamConfig
from ..convert import state_from_arrays, state_to_arrays
from ..filter.state import FilterState, init_state, resolve_device


def save_checkpoint(path: str, state: FilterState, counter: int,
                    cfg: SlamConfig, extra: Optional[dict] = None) -> None:
    leaves = list(state_to_arrays(state).values())
    payload = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    payload["counter"] = np.asarray(counter, np.int64)
    meta = {"config": cfg.to_json(), "n_leaves": len(leaves)}
    if extra:
        meta["extra"] = extra
    payload["meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)                      # atomic: no torn checkpoints


def load_checkpoint(path: str,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Tuple[FilterState, int, SlamConfig, dict]:
    """Returns (state, counter, cfg, extra). The state is placed on ``cuda``
    unless ``device`` names another device; raises when no device is named
    and CUDA is absent (the rule of ``init_state``)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        cfg = SlamConfig.from_json(meta["config"])
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
        counter = int(z["counter"])
    # field names (and the expected leaf count, shapes and dtypes) come from
    # a fresh state of the same config
    template = state_to_arrays(init_state(cfg, device="cpu"))
    if len(leaves) != len(template):
        raise ValueError(
            f"{path}: {len(leaves)} leaves, this state has {len(template)}")
    arrays = {}
    for (key, ref), leaf in zip(template.items(), leaves):
        if leaf.dtype != ref.dtype or leaf.shape[1:] != ref.shape[1:]:
            raise ValueError(
                f"{path}: leaf {key} is {leaf.dtype}{leaf.shape}, expected "
                f"{ref.dtype}{ref.shape}")
        arrays[key] = leaf
    return (state_from_arrays(arrays, device=dev), counter, cfg,
            meta.get("extra", {}))


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best, best_n = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".npz"):
            try:
                n = int(name[len(prefix):-4])
            except ValueError:
                continue
            if n > best_n:
                best, best_n = os.path.join(directory, name), n
    return best
