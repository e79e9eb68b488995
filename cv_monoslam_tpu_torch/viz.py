"""Offline visualization — the engine's replacement for the reference's GUI
renderers (C21 OpenGL 3D viewer, C22 GDI blitter, C23 2D overlay;
OpenGlDisplay.cpp:384-583, SLAM.cpp:3009-3083).

Host-side matplotlib (imported lazily inside the three plot functions, so
importing this module needs no matplotlib): nothing here touches the filter.
Three products:

  * :func:`plot_trajectory` — estimated path (green) vs odometry (red) with
    pose-covariance ellipses, the 2D analogue of the GL path view
    (OpenGlDisplay.cpp:429-446);
  * :func:`draw_overlay` — camera image + predicted crosses (blue), matched
    crosses (red), landmark IDs, chi^2 innovation ellipses
    (display2DFeatureModel, SLAM.cpp:3009-3051);
  * :func:`plot_map3d` — landmark cloud with 1-sigma covariance ellipsoids
    colored by status (red = active, green = loop, blue = stored history),
    matching the GL viewer's color scheme (OpenGlDisplay.cpp:449-583).

:func:`landmark_display_info` is the C14 math (SLAM.cpp:2721-2948): marginal
3x3 Cartesian covariance via the analytic inverse-depth Jacobian, eigen
axes + orientation quaternion per landmark.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import SlamConfig
from .filter.state import FilterState
from .geometry import transforms as tf


def landmark_display_info(state: FilterState, cfg: SlamConfig):
    """Per-slot Cartesian xyz, 3x3 covariance, 1-sigma axes, quaternion.

    getFeatureCartesianInformation / get3DdisplayInformation
    (SLAM.cpp:2721-2802): cov_xyz = J P66 J^T with the analytic Jacobian of
    the inverse-depth->Cartesian map; P66 is the marginal block of
    P = S^T S. Computed on the state's device (one marginal Gram per slot);
    returns a dict of (M, ...) host NumPy arrays.
    """
    M = cfg.max_landmarks
    feats = state.x[: 6 * M].reshape(M, 6)
    # marginal cov of slot i: (S[:, cols_i])^T S[:, cols_i]
    sc = state.S[:, : 6 * M].reshape(-1, M, 6)                 # (D, M, 6)
    p66 = torch.einsum("dmi,dmj->mij", sc, sc)                 # (M, 6, 6)
    J = tf.cartesian_jacobian(feats)                           # (M, 3, 6)
    cov3 = torch.einsum("mij,mjk,mlk->mil", J, p66, J)         # (M, 3, 3)
    xyz = tf.inverse_depth_to_cartesian(feats)
    sigma, quat = tf.covariance_ellipsoid(cov3)
    return dict(xyz=_np(xyz), cov3=_np(cov3), sigma=_np(sigma),
                quat=_np(quat), active=_np(state.lm.active),
                is_loop=_np(state.lm.is_loop), lid=_np(state.lm.lid))


def _np(t) -> np.ndarray:
    """Tensor (any device) or array -> host NumPy array."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _cov_ellipse_pts(cov2: np.ndarray, n: int = 40,
                     k: float = 1.0) -> np.ndarray:
    w, v = np.linalg.eigh(cov2)
    w = np.sqrt(np.maximum(w, 0.0))
    t = np.linspace(0, 2 * np.pi, n)
    circ = np.stack([np.cos(t), np.sin(t)])
    return (v @ (k * w[:, None] * circ)).T                     # (n, 2)


def plot_trajectory(est_xy: np.ndarray, odo_xy: np.ndarray,
                    pose_covs: Optional[np.ndarray] = None,
                    gt_xy: Optional[np.ndarray] = None,
                    landmarks: Optional[np.ndarray] = None,
                    path: Optional[str] = None, ellipse_every: int = 5):
    """Estimated (green) vs odometry (red) vs optional ground-truth paths."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 7))
    ax.plot(odo_xy[:, 0], odo_xy[:, 1], "r--", lw=1, label="odometry")
    ax.plot(est_xy[:, 0], est_xy[:, 1], "g-", lw=1.5, label="SLAM estimate")
    if gt_xy is not None:
        ax.plot(gt_xy[:, 0], gt_xy[:, 1], "k:", lw=1, label="ground truth")
    if pose_covs is not None:
        for i in range(0, len(est_xy), ellipse_every):
            pts = _cov_ellipse_pts(pose_covs[i][:2, :2], k=2.0) + est_xy[i]
            ax.plot(pts[:, 0], pts[:, 1], "g-", lw=0.5, alpha=0.4)
    if landmarks is not None and len(landmarks):
        ax.scatter(landmarks[:, 0], landmarks[:, 1], s=6, c="tab:blue",
                   alpha=0.6, label="landmarks")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="best", fontsize=8)
    ax.grid(True, alpha=0.3)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def draw_overlay(image: np.ndarray, state: FilterState, cfg: SlamConfig,
                 path: Optional[str] = None,
                 frame: Optional[int] = None):
    """Camera view + prediction/match markers + innovation ellipses
    (display2DFeatureModel, SLAM.cpp:3009-3051).

    ``frame`` overrides the title's frame index (pass the session counter
    so titles match FrameRecord numbering; defaults to the in-state
    counter)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lm = state.lm
    active = _np(lm.active)
    visible = _np(lm.visible) & active
    matched = _np(lm.matched) & active
    pred = _np(lm.pred)
    match_px = _np(lm.match_px)
    si = _np(lm.si)
    lid = _np(lm.lid)

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(np.asarray(image), cmap="gray", vmin=0, vmax=255)
    for i in np.flatnonzero(visible):
        u, v = pred[i]
        ax.plot(u, v, "b+", ms=10, mew=1.5)
        ax.annotate(str(int(lid[i])), (u + 4, v - 4), color="cyan",
                    fontsize=7)
        pyy = si[i].T @ si[i]
        pts = _cov_ellipse_pts(pyy, k=2.0) + np.array([u, v])
        ax.plot(pts[:, 0], pts[:, 1], "b-", lw=0.6, alpha=0.6)
    for i in np.flatnonzero(matched):
        u, v = match_px[i]
        ax.plot(u, v, "r+", ms=10, mew=1.5)
    ax.set_xlim(0, image.shape[1])
    ax.set_ylim(image.shape[0], 0)
    ax.set_title(f"frame {int(state.frame) if frame is None else frame}: "
                 f"{int(visible.sum())} predicted, "
                 f"{int(matched.sum())} matched")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_map3d(state: FilterState, cfg: SlamConfig,
               est_path: Optional[np.ndarray] = None,
               path: Optional[str] = None):
    """3D landmark cloud + 1-sigma ellipsoid axes, GL-viewer color scheme."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    info = landmark_display_info(state, cfg)
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(111, projection="3d")
    act = info["active"]
    loop = info["is_loop"] & act
    plain = act & ~loop
    for mask, color, label in ((plain, "red", "active"),
                               (loop, "green", "loop")):
        if mask.any():
            p = info["xyz"][mask]
            ax.scatter(p[:, 0], p[:, 1], p[:, 2], c=color, s=12, label=label)
    sd = state.stored
    sv = _np(sd.valid)
    if sv.any():
        p = _np(sd.xyz)[sv]
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], c="blue", s=8, alpha=0.5,
                   label="stored")
    if est_path is not None and len(est_path):
        ax.plot(est_path[:, 0], est_path[:, 1],
                np.zeros(len(est_path)), "g-", lw=1, label="trajectory")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.legend(fontsize=8)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig
