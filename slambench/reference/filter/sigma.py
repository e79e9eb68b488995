"""Unscented-transform weights + sigma point generation (torch).

Implements the reference's three weight schemes (SLAM.cpp:1050-1103):
0 = Murray SRUKF (default), 1 = UKF-2000, 2 = UKF-2004, and the sigma rule
chi = [mu, mu + gamma*S_row_i^T, mu - gamma*S_row_i^T] (SLAM.cpp:1148-1162)
where S is the upper-triangular sqrt factor with P = S^T S — sigma offsets
come from the *rows* of S.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..config import SlamConfig
from ..ops import control


@dataclasses.dataclass(frozen=True)
class UTWeights:
    na: int
    wm0: float
    wc0: float
    wi: float
    wi_sr: float
    gamma: float

    @property
    def n_sigma(self) -> int:
        return 2 * self.na + 1

    def mean_weights(self, dtype, device) -> torch.Tensor:
        """(2na+1,) mean weights [wm0, wi, ..., wi], built once per device
        and dtype with two fills (no upload; never written into)."""
        def build():
            w = torch.full((self.n_sigma,), self.wi, dtype=dtype,
                           device=device)
            w[:1].fill_(self.wm0)
            return w

        return control.cached(("mean_weights", self.n_sigma, self.wm0,
                               self.wi, dtype, torch.device(device)), build)


def ut_weights(na: int, cfg: SlamConfig) -> UTWeights:
    if cfg.weight_type == 0:      # Murray SRUKF (SLAM.cpp:1066-1078)
        wm0 = 1.0 - na / 3.0
        wc0 = wm0
        wi = (1.0 - wc0) / (2 * na)
        gamma = math.sqrt(na / (1.0 - wm0))     # = sqrt(3)
    elif cfg.weight_type == 1:    # UKF-2000 (SLAM.cpp:1080-1091)
        lam = cfg.alpha ** 2 * (na + cfg.kappa) - na
        gamma = math.sqrt(na + lam)
        wm0 = lam / (na + lam)
        wc0 = wm0 + (1 - cfg.alpha ** 2 + cfg.beta)
        wi = 1.0 / (2 * (na + lam))
    elif cfg.weight_type == 2:    # UKF-2004 (SLAM.cpp:1093-1102)
        gamma = math.sqrt(3.0 * na / 2.0)
        wm0 = wc0 = 1.0 / 3.0
        wi = 1.0 / (3.0 * na)
    else:
        raise ValueError(f"unknown weight_type {cfg.weight_type}")
    return UTWeights(na=na, wm0=wm0, wc0=wc0, wi=wi,
                     wi_sr=math.sqrt(abs(wi)), gamma=gamma)


def generate_sigma(mu: torch.Tensor, sr: torch.Tensor,
                   gamma: float) -> torch.Tensor:
    """(Na,), (Na, Na) -> (Na, 2Na+1) sigma points (SLAM.cpp:1148-1162)."""
    offs = gamma * sr.T  # column i = gamma * (row i of sr)^T
    return torch.cat(
        [mu[:, None], mu[:, None] + offs, mu[:, None] - offs], dim=1)


def deviations(sigma: torch.Tensor, wi_sr: float) -> torch.Tensor:
    """sqrt(wi)-scaled deviations from chi_0, transposed for QR:
    (Na, 2Na+1) -> (2Na, Na) rows (SLAM.cpp:1550-1555, Murray convention)."""
    return wi_sr * (sigma[:, 1:] - sigma[:, :1]).T
