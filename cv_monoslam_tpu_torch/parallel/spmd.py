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

import numpy as np
import torch

from ..config import SlamConfig
from ..filter.measurement import apply_prediction, prediction_rows
from ..filter.srukf import slam_step, step_with
from ..filter.state import FilterState, LandmarkTable, replace
from ..frontend.matching import accept_matches, association_rows
from ..ops import control, vision
from .mesh import Layout, Mesh, set_mesh


#: private switch: False sends every frame of :func:`run_frames` to the
#: eager route (the chip smoke compares the two routes with it)
_GRAPHS = True


def sharded_slam_step(state: FilterState, image: torch.Tensor,
                      odo_prev: torch.Tensor, odo_cur: torch.Tensor,
                      redirect: bool, cfg: SlamConfig, mesh: Mesh,
                      layout: Layout, *, allow_detect: bool = True):
    """One frame of ``slam_step`` split over ``mesh`` as ``layout`` says
    (see the module docstring). Every rank calls it with the same
    arguments; returns (new_state, outputs), the same on every rank. A
    ``start`` stage mark opens it (``ops.vision.stage_mark``), as it opens
    each replay of a session's graph."""
    vision.stage_mark(image.device, "start")
    with set_mesh(mesh, shard_sqrt=layout.shard_sqrt):
        if layout.shard_sqrt:
            return slam_step(state, image, odo_prev, odo_cur, redirect, cfg,
                             allow_detect=allow_detect)
        return step_with(partial(_predict_and_associate_sharded, mesh=mesh),
                         state, image, odo_prev, odo_cur, redirect, cfg,
                         allow_detect=allow_detect)


def run_frames(state: FilterState, images: torch.Tensor, odo: torch.Tensor,
               redirect, cfg: SlamConfig, mesh: Mesh, layout: Layout):
    """Frames 1 .. T - 1 of a track through :func:`sharded_slam_step`, as
    ``SlamSession.step`` drives ``slam_step`` on one device: ``images``
    (T, H, W) in the filter dtype, ``odo`` (T, 3) odometry poses,
    ``redirect`` (T,) host flags (numpy or a CPU tensor; read once);
    ``state`` has seen frame 0. Returns (state, the frames' pose, n_map,
    n_matched, lm_active, lm_matched and lm_lid stacked).

    On a mesh whose collectives can be captured (NCCL, ``Mesh.captures``)
    each non-redirect frame is one replay of a CUDA graph of the step, one
    per layout (kept in ``mesh.graphs``), captured at its first use with the
    collectives and the filter's gates inside: the counterpart of the JAX
    package's one ``jax.jit`` of the sharded step. Redirect frames, and
    every frame on a ``gloo`` mesh, run eagerly."""
    flags = np.asarray(redirect.cpu() if isinstance(redirect, torch.Tensor)
                       else redirect, dtype=bool)
    keys = ("pose", "n_map", "n_matched", "lm_active", "lm_matched",
            "lm_lid")
    outs = {k: [] for k in keys}
    step = (_frame_graph(state, images[0], odo[0], cfg, mesh, layout)
            if mesh.captures and _GRAPHS else None)
    for k in range(1, images.shape[0]):
        if step is None or flags[k]:
            state, out = sharded_slam_step(state, images[k], odo[k - 1],
                                           odo[k], bool(flags[k]), cfg, mesh,
                                           layout)
        else:
            state, out = step(state, images[k], odo[k - 1], odo[k])
            out = {key: out[key].clone() for key in keys}
        for key in keys:
            outs[key].append(out[key])
    if step is not None:
        state = control.tree_map(torch.clone, state)
    return state, {k: torch.stack(v) for k, v in outs.items()}


def _frame_graph(state: FilterState, image: torch.Tensor, odo: torch.Tensor,
                 cfg: SlamConfig, mesh: Mesh, layout: Layout):
    """``step(state, image, odo_prev, odo_cur) -> (state, outputs)``: one
    replay of the captured non-redirect :func:`sharded_slam_step` (kept in
    ``mesh.graphs``). The inputs are copied into the graph's static
    buffers; the state it returns IS its buffers, and the outputs hold the
    latest replay's values."""
    key = ("sharded_slam_step", layout, cfg, tuple(image.shape), image.dtype,
           odo.dtype)
    if key not in mesh.graphs:
        pool = mesh.graphs.setdefault("pool", torch.cuda.graph_pool_handle())
        body_pool = mesh.graphs.setdefault("body_pool", torch.cuda.MemPool())
        static = (control.tree_map(torch.clone, state), image.clone(),
                  odo.clone(), odo.clone())

        def frame(st, im, op, oc):
            new, out = sharded_slam_step(st, im, op, oc, False, cfg, mesh,
                                         layout)
            control.write_back(st, new)
            return out

        mesh.graphs[key] = (static,) + control.capture_graph(
            frame, static, pool, body_pool)
    static, graph, out = mesh.graphs[key]

    def step(st, im, op, oc):
        for buf, t in zip(static, (st, im, op, oc)):
            if t is not buf:
                control.write_back(buf, t)
        graph.replay()
        return static[0], out

    return step


def _predict_and_associate_sharded(state: FilterState, cache, image, cfg,
                                   *, mesh: Mesh):
    lo, hi = mesh.block(cfg.max_landmarks)
    pred = prediction_rows(state, cache, cfg, lo, hi)
    mine = apply_prediction(replace(state, lm=_slots(state.lm, lo, hi)),
                            cache, pred)[0]
    vision.stage_mark(image.device, "measure")
    accepted, match_px, patches = association_rows(mine, image, cfg)
    rows = dict(pred, accepted=accepted, match_px=match_px, patches=patches)
    every = _unpack(mesh.all_gather(_pack(rows, state.x.dtype)), rows)
    state, cache = apply_prediction(state, cache,
                                    {k: every[k] for k in pred})
    state = accept_matches(state, every["accepted"], every["match_px"],
                           every["patches"], cfg)
    vision.stage_mark(image.device, "associate")
    return state, cache


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
