"""SRUKF measurement prediction — batched over sigma points x slots.

Reference semantics (SLAM.cpp:1604-1795): push every propagated sigma point
through state->world->camera->image->distort for EVERY landmark (reusing the
motion-propagated augmented sigma set), weighted-mean the pixels, mark
landmarks visible when the mean pixel is non-sentinel, and form each
feature's 2x2 sqrt innovation from the sqrt(wi)-scaled pixel deviations.
One (M, n_sigma) broadcast replaces the reference's per-landmark per-point
double loop; the 2x2 QR per feature (SLAM.cpp:1775-1795) becomes a
closed-form 2x2 Cholesky of the Gram matrix.
"""

from __future__ import annotations

import torch

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import transforms as tf
from .sigma import ut_weights
from .state import FilterState, PredictCache, replace


def chol2x2_upper(g: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Batched upper-triangular S with S^T S = G for PSD 2x2 G (..., 2, 2)."""
    g00 = torch.clamp(g[..., 0, 0], min=eps)
    a = torch.sqrt(g00)
    safe_a = torch.where(a == 0, torch.ones_like(a), a)
    b = g[..., 0, 1] / safe_a
    c = torch.sqrt(torch.clamp(g[..., 1, 1] - b * b, min=eps))
    z = torch.zeros_like(a)
    return torch.stack([
        torch.stack([a, b], dim=-1),
        torch.stack([z, c], dim=-1),
    ], dim=-2)


def project_all(sigma: torch.Tensor, cfg: SlamConfig) -> torch.Tensor:
    """Project every slot through every sigma point.

    sigma: (Na, n_sigma) augmented motion-propagated points.
    Returns pixels (M, 2, n_sigma) with the (0, 0) invisible sentinel.
    """
    M = cfg.max_landmarks
    D = cfg.state_dim
    feats = sigma[: 6 * M].reshape(M, 6, -1).permute(0, 2, 1)   # (M, ns, 6)
    pos = sigma[D - 4: D - 1].T                                  # (ns, 3)
    theta = sigma[D - 1]                                         # (ns,)
    err = sigma[D + 3: D + 5].T                                  # (ns, 2)
    rcw = tf.yaw_matrix(theta).transpose(-1, -2)                 # (ns, 3, 3)
    hlw = tf.state_to_world(feats, pos[None, :, :])              # (M, ns, 3)
    hlr = torch.einsum("sij,msj->msi", rcw, hlw)
    pix = cam_mod.project(cfg.camera, hlr, err[None, :, :])      # (M, ns, 2)
    return pix.permute(0, 2, 1)                                  # (M, 2, ns)


def measurement_predict(state: FilterState, cache: PredictCache,
                        cfg: SlamConfig):
    """Returns (new_state, cache with sigma_pix/pred filled)."""
    if cfg.sigma_mode == "implicit":
        raise NotImplementedError(
            "sigma_mode='implicit' is not ported yet (ROADMAP.md, Queue 1: "
            "the implicit large-state path)")
    dtype = state.x.dtype
    dev = state.x.device
    D = cfg.state_dim
    w = ut_weights(D + 5, cfg)

    pix = project_all(cache.sigma, cfg)                 # (M, 2, ns)
    mean = pix @ w.mean_weights(dtype, dev)             # (M, 2)

    lm = state.lm
    visible = lm.active & (mean[:, 0] != 0) & (mean[:, 1] != 0)

    dev_pix = w.wi_sr * (pix[:, :, 1:] - pix[:, :, :1])  # (M, 2, 2Na)
    gram = torch.einsum("mis,mjs->mij", dev_pix, dev_pix)
    # independent per-landmark measurement noise: Pyy = geo + sigma^2 I
    gram = gram + (cfg.sigma_measure ** 2) * torch.eye(
        2, dtype=dtype, device=dev)
    si = chol2x2_upper(gram)

    pred = torch.where(visible[:, None], mean, lm.pred)
    lm_new = replace(
        lm,
        visible=visible,
        matched=torch.zeros_like(lm.matched),
        n_predict=lm.n_predict + visible.to(torch.int32),
        pred=pred,
        si=torch.where(visible[:, None, None], si, lm.si),
    )
    return (
        replace(state, lm=lm_new),
        replace(cache, sigma_pix=pix, pred=pred),
    )
