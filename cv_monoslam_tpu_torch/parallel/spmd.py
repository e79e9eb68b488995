"""The sharded filter step: one frame of ``filter/srukf.slam_step`` across a
mesh (the counterpart of ``jax.jit(slam_step, in_shardings=
state_shardings(...))`` in ``tests/test_spmd_filter.py`` and
``scripts/bench_scaling.py``; SURVEY.md §2.3).

The port shards the WORK and keeps the filter state replicated: every rank
holds the whole state, calls :func:`sharded_slam_step` with the same inputs
and ends the frame with the same state. The JAX package shards memory as
well, but at M = 512 the landmark table is ~1 MB, so splitting it buys
nothing, and the sqrt factor is rebuilt from the replicated joint factor on
every rank either way.

* **Landmark layout** (``state_shardings(mesh, cfg)``). Rank r runs the
  per-landmark stages on its slots ``[r M / n, (r + 1) M / n)``: measurement
  prediction (``measurement.prediction_rows``) and data association up to
  the NCC peak (``matching.association_rows``) — so on ``cuda`` both vision
  kernels launch at M / n slots per rank. One ``all_gather`` of one packed
  per-landmark buffer then hands every rank every slot's results. What spans
  landmarks runs replicated: the 1-point RANSAC consensus, the Kalman
  update, the lifecycle, detection and integration, and the redirect
  branch.
* **shard_sqrt layout** (``state_shardings(mesh, cfg, shard_sqrt=True)``).
  Every Gram over S's rows in the step (``ops.linalg.gram_rows``: the
  joint update's G = S^T S, the motion and integration structured Grams,
  the integration fold, the deletion fold) is each rank's row-block product
  summed by one ``all_reduce``. With ``cfg.dist_chol_panel > 0`` the joint
  factorization runs row-sharded across the mesh (``parallel/dist_chol.py``).

Both layouts make the mesh ambient for the step (``set_mesh``, with
``shard_sqrt`` in the second), as the JAX tests do for the shard_sqrt step.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import torch

from ..config import SlamConfig
from ..filter.measurement import apply_prediction, prediction_rows
from ..filter.srukf import slam_step, step_with
from ..filter.state import FilterState, LandmarkTable, replace
from ..frontend.matching import accept_matches, association_rows
from .mesh import Layout, Mesh, set_mesh


def sharded_slam_step(state: FilterState, image: torch.Tensor,
                      odo_prev: torch.Tensor, odo_cur: torch.Tensor,
                      redirect: bool, cfg: SlamConfig, mesh: Mesh,
                      layout: Layout, *, allow_detect: bool = True):
    """One frame of ``slam_step`` split over ``mesh`` as ``layout`` says
    (see the module docstring). Every rank calls it with the same
    arguments; returns (new_state, outputs), the same on every rank."""
    with set_mesh(mesh, shard_sqrt=layout.shard_sqrt):
        if layout.shard_sqrt:
            return slam_step(state, image, odo_prev, odo_cur, redirect, cfg,
                             allow_detect=allow_detect)
        return step_with(partial(_predict_and_associate_sharded, mesh=mesh),
                         state, image, odo_prev, odo_cur, redirect, cfg,
                         allow_detect=allow_detect)


def run_frames(state: FilterState, images: torch.Tensor, odo: torch.Tensor,
               redirect: torch.Tensor, cfg: SlamConfig, mesh: Mesh,
               layout: Layout):
    """Frames 1 .. T - 1 of a track through :func:`sharded_slam_step`, as
    ``SlamSession.step`` drives ``slam_step`` on one device: ``images``
    (T, H, W) in the filter dtype, ``odo`` (T, 3) odometry poses,
    ``redirect`` (T,) flags; ``state`` has seen frame 0. Returns (state,
    the frames' pose, n_map, n_matched, lm_active, lm_matched and lm_lid
    stacked)."""
    keys = ("pose", "n_map", "n_matched", "lm_active", "lm_matched",
            "lm_lid")
    outs = {k: [] for k in keys}
    for k in range(1, images.shape[0]):
        state, out = sharded_slam_step(state, images[k], odo[k - 1], odo[k],
                                       bool(redirect[k]), cfg, mesh, layout)
        for key in keys:
            outs[key].append(out[key])
    return state, {k: torch.stack(v) for k, v in outs.items()}


def _predict_and_associate_sharded(state: FilterState, cache, image, cfg,
                                   *, mesh: Mesh):
    lo, hi = mesh.block(cfg.max_landmarks)
    pred = prediction_rows(state, cache, cfg, lo, hi)
    mine = apply_prediction(replace(state, lm=_slots(state.lm, lo, hi)),
                            cache, pred)[0]
    accepted, match_px, patches = association_rows(mine, image, cfg)
    rows = dict(pred, accepted=accepted, match_px=match_px, patches=patches)
    every = _unpack(mesh.all_gather(_pack(rows, state.x.dtype)), rows)
    state, cache = apply_prediction(state, cache,
                                    {k: every[k] for k in pred})
    return accept_matches(state, every["accepted"], every["match_px"],
                          every["patches"], cfg), cache


def _slots(lm: LandmarkTable, lo: int, hi: int) -> LandmarkTable:
    return replace(lm, **{f.name: getattr(lm, f.name)[lo:hi]
                          for f in dataclasses.fields(lm)})


def _memory_order(v: torch.Tensor) -> list:
    """Dim 0, then the other dims from the outermost in memory."""
    return [0] + sorted(range(1, v.dim()), key=lambda d: -v.stride(d))


def _pack(rows: dict, dtype: torch.dtype) -> torch.Tensor:
    """(slots, K) buffer of every per-slot field, each flattened in its own
    memory order and cast to ``dtype`` (exact for the booleans)."""
    return torch.cat([v.permute(_memory_order(v)).reshape(v.shape[0], -1)
                      .to(dtype) for v in rows.values()], dim=1)


def _unpack(buf: torch.Tensor, like: dict) -> dict:
    """Inverse of :func:`_pack` for all slots: each field gets back its
    dtype and the memory layout of its counterpart in ``like`` — a layout
    changes which kernels later products take, and so their rounding."""
    out, c0 = {}, 0
    for k, v in like.items():
        order = _memory_order(v)
        shape = [v.shape[d] for d in order[1:]]
        width = math.prod(shape)
        f = buf[:, c0:c0 + width].reshape(buf.shape[0], *shape).contiguous()
        out[k] = f.permute([order.index(d) for d in range(v.dim())]) \
            .to(v.dtype)
        c0 += width
    return out
