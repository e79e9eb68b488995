"""Dense linear algebra (torch.linalg) and the vision kernels' plain
versions (:mod:`.vision`), frozen from the port's ``ops``."""

from __future__ import annotations

import torch

from .linalg import (chol_downdate, chol_psd_flagged, chol_update, cholqr,
                     cholqr2, gmw_chol, gram, tri_solve)


def qr_r(a: torch.Tensor, mode: str = "householder") -> torch.Tensor:
    """R factor of tall-skinny ``a``: R^T R = A^T A, R upper triangular.

    mode "householder": Householder QR (reference-faithful to GSL QR,
    SLAM.cpp:2330-2353). mode "cholqr2": matmul-dominant CholeskyQR2. mode
    "gram": single-pass equilibrated CholeskyQR; structured Gram shortcuts
    in motion/lifecycle also key off this mode.
    """
    if mode == "cholqr2":
        return cholqr2(a)
    if mode == "gram":
        return cholqr(a)
    if mode == "householder":
        return torch.linalg.qr(a, mode="r")[1]
    raise ValueError(f"unknown qr mode {mode!r}")


__all__ = ["chol_downdate", "chol_psd_flagged", "chol_update", "cholqr",
           "cholqr2", "gmw_chol", "gram", "tri_solve", "qr_r"]
