"""Fixed-capacity SoA filter state (frozen dataclasses of torch tensors).

The reference grows/shrinks its state vector and sqrt covariance on every
feature add/delete (SLAM.h:47-70, 271-273; SLAM.cpp:1260-1334, 2637-2706).
Here ``max_landmarks`` slots are allocated up front:

  * state vector ``x``: (D,) with D = 6*M + 4, slot i at rows [6i, 6i+6),
    robot pose in the LAST four rows — the reference's layout (SLAM.h:271);
  * sqrt covariance ``S``: (D, D) upper triangular, P = S^T S;
  * per-slot landmark table as struct-of-arrays.

Invariant: an *inactive* slot i has x[6i:6i+6] = (0,0,0,0,0,1) and S
rows/cols equal to the unit diagonal, decoupled from every active row. All
lifecycle events are masked writes + structured refactorizations that keep
this invariant, so adds and deletes never reshape anything.

Every tensor of one state lives on one device; functions that build new
tensors take the device from the state they are given.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from ..config import SlamConfig
from ..ops import control


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """The device an entry point runs on: the current card unless the
    caller names another. Without an explicit device and without CUDA this
    raises — the engine never drops to the CPU on its own. A card is
    returned with its index (``cuda:<current_device()>`` for ``cuda``), the
    name its tensors report, so that per-device state is keyed alike
    (``ops.control.card``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the "
                "CPU explicitly")
        device = "cuda"
    return control.card(device)


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[name]


@dataclasses.dataclass(frozen=True)
class LandmarkTable:
    """Per-slot landmark records (reference PointsMap, SLAM.h:47-70)."""

    active: torch.Tensor       # (M,) bool
    lid: torch.Tensor          # (M,) int32 landmark IDs (0 = none)
    is_loop: torch.Tensor      # (M,) bool
    n_predict: torch.Tensor    # (M,) int32
    n_match: torch.Tensor      # (M,) int32
    visible: torch.Tensor      # (M,) bool
    matched: torch.Tensor      # (M,) bool
    pred: torch.Tensor         # (M, 2) predicted pixel (u, v)
    match_px: torch.Tensor     # (M, 2) matched pixel
    si: torch.Tensor           # (M, 2, 2) sqrt innovation
    init_pixel: torch.Tensor   # (M, 2)
    init_trans: torch.Tensor   # (M, 3) camera position at init
    init_theta: torch.Tensor   # (M,) camera yaw at init
    init_patch: torch.Tensor   # (M, P, P) float32, P = 2*hp_init + 1
    match_patch: torch.Tensor  # (M, Q, Q) float32, Q = 2*hp_match + 1
    xyz: torch.Tensor          # (M, 3) Cartesian estimate


@dataclasses.dataclass(frozen=True)
class StoredTable:
    """Snapshots for redirection / loop reuse (FeatureInfo, SLAM.h:73-99).

    ``stamp``/``seq`` implement oldest-first eviction when the table is
    full: every insert takes the monotone counter ``seq`` as its stamp."""

    valid: torch.Tensor        # (K,) bool
    stamp: torch.Tensor        # (K,) int32 insertion order stamp
    seq: torch.Tensor          # () int32 monotone insert counter
    lid: torch.Tensor          # (K,) int32
    is_loop: torch.Tensor      # (K,) bool
    n_predict: torch.Tensor    # (K,) int32
    n_match: torch.Tensor      # (K,) int32
    state: torch.Tensor        # (K, 6)
    sr: torch.Tensor           # (K, 6, 6)
    init_pixel: torch.Tensor   # (K, 2)
    init_trans: torch.Tensor   # (K, 3)
    init_theta: torch.Tensor   # (K,)
    init_patch: torch.Tensor   # (K, P, P) float32
    xyz: torch.Tensor          # (K, 3)


@dataclasses.dataclass(frozen=True)
class FilterState:
    """Complete SRUKF state, all fixed shapes."""

    x: torch.Tensor            # (D,)
    S: torch.Tensor            # (D, D)
    lm: LandmarkTable
    stored: StoredTable
    next_id: torch.Tensor      # () int32
    frame: torch.Tensor        # () int32 — m_frame.counter
    #: () int32 — cumulative MINOR covariance repairs (first jitter rungs)
    n_repairs: torch.Tensor
    #: () int32 — cumulative ESCALATED repairs (the 1e6x rung: a partial
    #: covariance reset). Zero on any healthy run.
    n_escalations: torch.Tensor
    #: () int32 — cumulative skipped measurement updates
    n_skipped: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PredictCache:
    """Propagated sigma points reused across motion -> measurement -> update
    (the reference keeps m_sigma / m_sigma_allPixel / m_allPredictSet across
    phases, SLAM.cpp:1463, 1615-1691, 2020-2038)."""

    sigma: Any                # (Na, 2Na+1) augmented, motion-propagated
    sigma_pix: Any            # (M, 2, 2Na+1) projected pixels per slot
    pred: torch.Tensor        # (M, 2) weighted-mean pixels
    #: (M, 2, 10) UT-implied measurement linearization per landmark,
    #: only under sigma_mode="implicit" (sigma/sigma_pix are None there)
    h_lin: Any = None
    #: (D, D) motion-predicted covariance GRAM, only under
    #: sigma_mode="implicit": the update factorizes the posterior directly,
    #: state.S is STALE until then
    g_pred: Any = None


def inactive_feature_defaults(dtype, device) -> torch.Tensor:
    """The (6,) state of an inactive slot, built once per device and dtype
    (never written into)."""
    return control.constant((0.0, 0.0, 0.0, 0.0, 0.0, 1.0), dtype, device)


def init_state(cfg: SlamConfig, theta0: float = 0.0, max_stored: int = 64,
               device: Optional[Union[str, torch.device]] = None
               ) -> FilterState:
    """Fresh 'robot only' state (initializeParameters, SLAM.cpp:226-246).

    Runs on ``cuda`` unless ``device`` names another device; raises when no
    device is named and CUDA is absent."""
    dev = resolve_device(device)
    dtype = np.dtype(cfg.dtype)
    M = cfg.max_landmarks
    D = cfg.state_dim
    P = 2 * cfg.hp_init + 1
    Q = 2 * cfg.hp_match + 1
    K = max_stored

    x = np.tile(np.array([0, 0, 0, 0, 0, 1], dtype), M)
    x = np.concatenate([x, np.zeros(4, dtype)])
    x[-1] = theta0
    s_diag = np.ones(D, dtype)
    s_diag[-4:] = [cfg.sigma_x, cfg.sigma_y, cfg.sigma_z, cfg.sigma_theta]

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    lm = LandmarkTable(
        active=t(np.zeros(M, bool)),
        lid=t(np.zeros(M, np.int32)),
        is_loop=t(np.zeros(M, bool)),
        n_predict=t(np.zeros(M, np.int32)),
        n_match=t(np.zeros(M, np.int32)),
        visible=t(np.zeros(M, bool)),
        matched=t(np.zeros(M, bool)),
        pred=t(np.zeros((M, 2), dtype)),
        match_px=t(np.zeros((M, 2), dtype)),
        si=t(np.tile(np.eye(2, dtype=dtype), (M, 1, 1))),
        init_pixel=t(np.zeros((M, 2), dtype)),
        init_trans=t(np.zeros((M, 3), dtype)),
        init_theta=t(np.zeros(M, dtype)),
        init_patch=t(np.zeros((M, P, P), np.float32)),
        match_patch=t(np.zeros((M, Q, Q), np.float32)),
        xyz=t(np.zeros((M, 3), dtype)),
    )
    stored = StoredTable(
        valid=t(np.zeros(K, bool)),
        stamp=t(np.zeros(K, np.int32)),
        seq=t(np.int32(0)),
        lid=t(np.zeros(K, np.int32)),
        is_loop=t(np.zeros(K, bool)),
        n_predict=t(np.zeros(K, np.int32)),
        n_match=t(np.zeros(K, np.int32)),
        state=t(np.zeros((K, 6), dtype)),
        sr=t(np.zeros((K, 6, 6), dtype)),
        init_pixel=t(np.zeros((K, 2), dtype)),
        init_trans=t(np.zeros((K, 3), dtype)),
        init_theta=t(np.zeros(K, dtype)),
        init_patch=t(np.zeros((K, P, P), np.float32)),
        xyz=t(np.zeros((K, 3), dtype)),
    )
    return FilterState(
        x=t(x), S=t(np.diag(s_diag)), lm=lm, stored=stored,
        next_id=t(np.int32(1)),
        frame=t(np.int32(1)),
        n_repairs=t(np.int32(0)),
        n_escalations=t(np.int32(0)),
        n_skipped=t(np.int32(0)),
    )


def robot_pose(state: FilterState) -> torch.Tensor:
    """(x, y, z, theta) — the last four state rows (SLAM.cpp:1184)."""
    return state.x[-4:]


def feature_states(state: FilterState, M: int) -> torch.Tensor:
    """(M, 6) view of the landmark blocks."""
    return state.x[: 6 * M].reshape(M, 6)


def replace(obj: Any, **kw) -> Any:
    return dataclasses.replace(obj, **kw)


def count_repairs(state: FilterState, *levels) -> FilterState:
    """Fold chol_psd_flagged repair levels into the state's counters:
    levels 1-3 -> n_repairs (benign regularization floors), level 4 ->
    n_escalations (the 1e6x rung: a partial covariance reset). A level is a
    Python int (added on the host: no upload) or a 0-d integer device
    tensor (added on the device: no read)."""
    minor = state.n_repairs
    major = state.n_escalations
    for lv in levels:
        if isinstance(lv, torch.Tensor):
            minor = minor + ((lv >= 1) & (lv <= 3)).to(torch.int32)
            major = major + (lv >= 4).to(torch.int32)
        else:
            minor = minor + int(1 <= lv <= 3)
            major = major + int(lv >= 4)
    return replace(state, n_repairs=minor, n_escalations=major)
