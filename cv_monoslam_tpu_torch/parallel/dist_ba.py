"""Distributed bundle adjustment: landmark blocks sharded over the mesh, the
Schur complement reduced with one collective per iteration (the counterpart
of ``cv_monoslam_tpu/parallel/dist_ba.py``; BASELINE config 5; SURVEY.md §2.3
"Schur-complement reduction").

Per Gauss-Newton iteration:

  local (this rank's L / n landmarks, no communication):
      residuals, Jacobians, V_l^{-1}, W_wl, b_l   (``backend.ba._obs_blocks``)
  one ``all_reduce`` of one packed buffer of pose-shaped terms:
      U (W,3,3), Hred (W,W,3,3), bp (W,3), cost_obs ()
  replicated on every rank (3W x 3W):
      odometry factors, gauge prior, dense solve  (``_pose_system``)
  local again:
      landmark back-substitution                  (``back_substitute``)

The payload is (9W + 9W^2 + 3W + 1) elements per iteration whatever L is.

Nothing in an iteration reads the device from the host or uploads host
data (``backend.ba``'s solves are the ``_ex`` forms, its constants cached),
so on an NCCL mesh the iterations run as ONE captured CUDA graph per
problem shape, collectives included (the JAX package's ``jax.jit`` of its
``lax.scan``), kept in ``mesh.graphs`` and replayed on every call. ``gloo``
collectives cannot be captured: a ``gloo`` mesh runs them eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..backend.ba import BAProblem, _obs_blocks, _pose_system, back_substitute
from ..config import SlamConfig
from ..ops import control
from .mesh import Mesh


def ba_solve_sharded(prob: BAProblem, cfg: SlamConfig, mesh: Mesh, *,
                     iters: Optional[int] = None,
                     pix_sigma: Optional[float] = None,
                     odo_sigma: Tuple[float, float, float] = (0.02, 0.02,
                                                              0.01),
                     damping: float = 1e-4,
                     prior_pose: Tuple[float, float, float] = (1e6, 1e6,
                                                               1e6)):
    """``backend.ba.ba_solve`` with the landmark axis sharded: the same
    math, called on every rank with the same (replicated) problem.

    ``L`` must divide by the mesh size (pad the problem if needed). Returns
    (poses (W, 3) replicated, this rank's landmarks (L / n, 3) — rows
    ``mesh.block(L)``; :func:`gather_landmarks` assembles them — and the
    costs (iters,) replicated)."""
    W, L = prob.obs.shape[:2]
    if L % mesh.size:
        raise ValueError(f"L={L} landmarks must divide by devices="
                         f"{mesh.size} (pad the problem)")
    iters = cfg.ba_iters if iters is None else iters
    pix_sigma = cfg.sigma_measure if pix_sigma is None else pix_sigma
    args = (cfg, mesh, iters, pix_sigma, tuple(odo_sigma), damping,
            tuple(prior_pose))
    if not (mesh.device.type == "cuda"
            and dist.get_backend(mesh.group) == "nccl"):
        return _iterations(prob, *args)
    key = ("ba_solve_sharded", args[2:], cfg, tuple(
        None if t is None else (tuple(t.shape), t.dtype)
        for t in (getattr(prob, f.name) for f in dataclasses.fields(prob))))
    if key not in mesh.graphs:
        pool = mesh.graphs.setdefault("pool", torch.cuda.graph_pool_handle())
        static = control.tree_map(torch.clone, prob)
        mesh.graphs[key] = (static,) + control.capture_graph(
            lambda p: _iterations(p, *args), (static,), pool)
    static, graph, out = mesh.graphs[key]
    for s, t in zip(control.leaves(static), control.leaves(prob)):
        s.copy_(t)
    graph.replay()
    return tuple(t.clone() for t in out)


def _iterations(prob: BAProblem, cfg: SlamConfig, mesh: Mesh, iters: int,
                pix_sigma: float, odo_sigma: tuple, damping: float,
                prior_pose: tuple):
    """The Gauss-Newton iterations of :func:`ba_solve_sharded`."""
    W, L = prob.obs.shape[:2]
    dtype, dev = prob.poses.dtype, prob.poses.device
    odo_s = control.constant(odo_sigma, dtype, dev)
    prior = control.constant(prior_pose, dtype, dev)

    lo, hi = mesh.block(L)
    lms = prob.landmarks[lo:hi]
    obs, obs_mask = prob.obs[:, lo:hi], prob.obs_mask[:, lo:hi]
    lm_mask = prob.lm_mask[lo:hi]
    sizes = (9 * W, 9 * W * W, 3 * W, 1)
    poses, costs = prob.poses, []
    for _ in range(iters):
        U, Hred, bp, Vinv, Wc, bl, cost_obs = _obs_blocks(
            poses, lms, obs, obs_mask, prob.kf_mask, lm_mask, cfg,
            pix_sigma, damping)
        red = mesh.all_reduce(torch.cat([U.reshape(-1), Hred.reshape(-1),
                                         bp.reshape(-1),
                                         cost_obs.reshape(1)]))
        U, Hred, bp, cost_obs = torch.split(red, sizes)
        # the pose solve reads only pose-shaped fields of the problem
        dxp, cost_odo = _pose_system(
            poses, U.reshape(W, 3, 3), Hred.reshape(W, W, 3, 3),
            bp.reshape(W, 3), prob, cfg, odo_s, damping, prior)
        dxl = back_substitute(dxp, Vinv, Wc, bl, lm_mask)
        poses, lms = poses + dxp, lms + dxl
        costs.append(cost_obs[0] + cost_odo)
    costs = (torch.stack(costs) if costs
             else torch.zeros(0, dtype=dtype, device=dev))
    return poses, lms, costs


def gather_landmarks(lms_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All landmarks (L, 3), replicated, from each rank's block."""
    return mesh.all_gather(lms_local)
