"""Compute kernels: dense linear algebra (torch.linalg) and the hand-written
CUDA vision kernels (:mod:`.vision`)."""

from __future__ import annotations

import torch

from .linalg import chol_psd_flagged, cholqr, gram, tri_solve


def qr_r(a: torch.Tensor, mode: str = "householder") -> torch.Tensor:
    """R factor of tall-skinny ``a``: R^T R = A^T A, R upper triangular.

    mode "householder": Householder QR (reference-faithful to GSL QR,
    SLAM.cpp:2330-2353). mode "gram": single-pass equilibrated CholeskyQR;
    structured Gram shortcuts in motion/lifecycle also key off this mode.
    """
    if mode == "gram":
        return cholqr(a)
    if mode == "householder":
        return torch.linalg.qr(a, mode="r")[1]
    if mode == "cholqr2":
        raise NotImplementedError(
            "qr_mode='cholqr2' is not ported yet (ROADMAP.md, Queue 1: "
            "remaining linear algebra)")
    raise ValueError(f"unknown qr mode {mode!r}")


__all__ = ["chol_psd_flagged", "cholqr", "gram", "tri_solve", "qr_r"]
