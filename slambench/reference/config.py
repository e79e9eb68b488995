"""Configuration for the PyTorch/CUDA ceiling-vision SRUKF SLAM engine.

A copy of ``cv_monoslam_tpu.config``: the same fields, the same defaults and
the same JSON form, so a configuration written for one package loads in the
other. Parameter names follow the reference implementation's tunable set
(the ``CSetParameters`` dialog + ``CSLAM::initializeParameters``,
reference: MonoSLAM/SLAM.cpp:158-353, SetParameters.cpp:32-63).

The state has *fixed capacity* ``max_landmarks``: every tensor shape is fixed
for a run, so adds and deletes are masked writes, never reallocations.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole + 2-coefficient radial distortion camera.

    Defaults are the reference's hard-coded intrinsics
    (SLAM.cpp:329-343): dx=dy=0.0028 mm/px, c=(310.1129, 236.7526),
    k1=1e-4, k2=0, f=2.1735 mm -> f/dx ~ 776.25 px.

    The reference's ``coordinatesCamera2Image`` intentionally swaps the
    u/v axes for its ceiling-mount convention (SLAM.cpp:3338-3345); that
    behaviour is reproduced in :mod:`cv_monoslam_tpu_torch.geometry.camera`.
    """

    width: int = 640
    height: int = 480
    dx: float = 0.0028
    dy: float = 0.0028
    cx: float = 310.1129
    cy: float = 236.7526
    k1: float = 0.0001
    k2: float = 0.0
    f: float = 2.1735
    #: Newton iterations for the forward-distortion solve. The reference uses
    #: 100 (SLAM.cpp:3186-3193); it converges in < 5 for this lens, so a
    #: small fixed count is used.
    distort_iters: int = 8
    #: pixels: camera2image clamps predictions this close to the border to the
    #: (0, 0) "invisible" sentinel (SLAM.cpp:3341-3345).
    margin: float = 10.0

    @property
    def f1(self) -> float:
        return self.f / self.dx

    @property
    def f2(self) -> float:
        return self.f / self.dy


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Full engine configuration.

    Field names follow the reference's parameter dialog (SetParameters.cpp)
    and ctor defaults (SLAM.cpp:164-213, 21-55).
    """

    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)

    # ---- capacity (fixed shapes) ----
    #: Maximum number of concurrently-tracked landmarks (state slots).
    max_landmarks: int = 32
    #: Maximum number of features initialized in a single frame.
    max_new_per_frame: int = 16
    #: Maximum raw corner detections considered per frame.
    max_detections: int = 64

    # ---- feature detection (reference defaults SLAM.cpp:172-190) ----
    deep: float = 3.0            # assumed ceiling depth (m); rho0 = 1/deep
    block_size: int = 3          # structure-tensor window
    quality_level: float = 0.1   # corner response threshold fraction of max
    n_initial_raws: int = 8      # corners requested on init frames
    n_process_raws: int = 8      # corners requested on normal frames
    min_num: int = 5             # add features when matches < min_num
    min_dist: float = 15.0       # min pixel distance between features
    dist_to_border: float = 20.0  # DIST_2_BORDER (SLAM.cpp:48)

    # ---- matching (SLAM.cpp:184-186) ----
    threshold_match_patch: float = 0.8  # NCC acceptance threshold
    #: 1-point RANSAC innovation-consensus radius in pixels
    #: (frontend.matching.one_point_ransac)
    threshold_ransac: float = 8.0
    #: innovation-consensus RANSAC; off by default, like the reference
    use_ransac: bool = False
    #: half-sizes: init patch 21x21, match patch 17x17 (HP_INIT_W/H=10,
    #: HP_MATCH_W/H=8, SLAM.cpp:41-44)
    hp_init: int = 10
    hp_match: int = 8
    #: chi2inv(0.95, 6) gate for the active-search ellipse (SLAM.cpp:54, 1975)
    chi2_gate: float = 12.59158724374398
    #: parabolic sub-pixel refinement of the NCC peak. The reference accepts
    #: integer match positions (SLAM.cpp:1986-2002); off = faithful.
    subpixel_match: bool = True
    #: reference isThereNoZero quirk (SLAM.cpp:684-696): when any landmark
    #: has a zero predicted/matched pixel, EVERY new-corner candidate is
    #: rejected. Off = skip the proximity test against such landmarks.
    detect_zero_blocks: bool = False
    #: run detection+integration only when the map is starved (reference
    #: trigger SLAM.cpp:552-562). When False the detection always runs and
    #: integration is masked.
    gate_detection: bool = True

    # ---- noise (SLAM.cpp:190-198, 240-246) ----
    sigma_measure: float = 3.0   # pixel measurement noise (sqrt)
    sigma_rho: Optional[float] = None  # default rho0/2 (SLAM.cpp:191)
    a1: float = 8.0              # odometry noise coefficients Mt
    a2: float = 8.0
    a3: float = 8.0
    a4: float = 8.0
    #: cap on the Mt sqrt-noise entries (the reference places variance-like
    #: values a_i * u^2 directly into the sqrt block, SLAM.cpp:1456-1458)
    motion_noise_cap: float = 0.2
    sigma_x: float = 0.02        # initial robot sqrt-cov diag (SLAM.cpp:243-246)
    sigma_y: float = 0.02
    sigma_z: float = 0.005
    sigma_theta: float = 0.02

    # ---- UT weights (SLAM.cpp:1050-1103) ----
    #: 0 = Murray SRUKF, 1 = UKF-2000, 2 = UKF-2004 (m_weightType, default 0)
    weight_type: int = 0
    alpha: float = 1e-3
    beta: float = 2.0
    kappa: float = 0.0

    # ---- odometry preprocessing (SLAM.cpp:45-47) ----
    min_step_xy: float = 0.01        # metres; skip frames with less motion
    min_step_theta_deg: float = 45.0  # redirection threshold |dtheta|
    capacity: int = 3000             # max frames per run (SLAM.h:127)

    # ---- lifecycle (SLAM.cpp:2443-2459) ----
    delete_predict_ratio: float = 2.0   # predicted > ratio * matched ...
    delete_predict_min: int = 10        # ... and predicted >= this
    delete_rho_min: float = 0.01        # rho below this (too far / negative)

    #: inverse-depth init: "flat" = rho0 = 1/deep for every feature (the
    #: reference, SLAM.cpp:853); "ceiling" = rho0 = m_z/deep, exact for a
    #: flat ceiling.
    rho_init_mode: str = "ceiling"

    # ---- filter update strategy ----
    #: "gram" = joint-Gram single-Cholesky update (default); "batched" =
    #: single joint QR-Schur update over all matches (same posterior up to
    #: roundoff); "sequential" = reference-faithful per-landmark 2D updates
    #: with rank-2 downdates (see downdate_mode; a parity mode, slow).
    update_mode: str = "gram"
    #: sequential-mode sqrt downdate: "hyperbolic" = rank-2 rotation
    #: downdate with PD-skip guard; "gmw" = the reference's
    #: recompose-refactor with Gill-Murray-Wright repair (SLAM.cpp:2106-2327)
    downdate_mode: str = "hyperbolic"
    #: sqrt-factor R computation: "gram" = equilibrated CholeskyQR plus
    #: structured Gram shortcuts (default); "householder" = Householder QR;
    #: "cholqr2" = CholeskyQR2.
    qr_mode: str = "gram"
    #: vision hot-loop backend: "pallas" = the hand-written CUDA kernels
    #: (ops/csrc/vision_kernels.cu; the plain torch version for CPU tensors),
    #: "xla" = the plain torch version everywhere, "auto" = the kernel for
    #: CUDA tensors and the plain version for CPU tensors.
    vision_backend: str = "auto"
    #: panel width of the row-sharded joint Cholesky: with a value > 0 and
    #: a mesh made ambient by ``parallel.mesh.set_mesh``, the gram update
    #: factorizes across that mesh (``parallel/dist_chol.py``); 0, or no
    #: ambient mesh, keeps the single-device factorization
    dist_chol_panel: int = 0
    #: sigma_mode="implicit" only: integrate new features through the
    #: closed-form sqrt fold (a 6K x 6K Cholesky) instead of a D x D
    #: refactorization
    integrate_fold: bool = True
    #: sigma-point realization: "full" materializes the (Na, 2Na+1) sigma
    #: tensor (SLAM.cpp:1463); "implicit" reads the touched rows off columns
    #: of S, keeps the predicted covariance as a Gram and runs one D x D
    #: factorization per frame (the large-state path; needs qr_mode and
    #: update_mode "gram").
    sigma_mode: str = "full"
    #: compute dtype of the filter core
    dtype: str = "float32"

    # ---- backend (bench config 4: backend/) ----
    ba_window: int = 8            # sliding-window keyframe count
    ba_iters: int = 5             # Gauss-Newton iterations per BA solve
    keyframe_every: int = 10      # keyframe spacing (frames)
    #: BA anchors each window pose to the filter's estimate with sigma =
    #: inflation * filter pose sigma: a converged filter has small sigma
    #: (strong anchor, BA is a no-op), a drifting filter has grown sigma
    #: (the reprojection/odometry evidence takes over)
    ba_pose_prior_inflation: float = 1.0
    #: window-BA corrections are committed only when the max pose
    #: correction exceeds this many filter sigmas. Ships INF (never commit:
    #: window BA solves and reports, the pose graph owns global correction).
    #: Set a finite gate to re-enable drift-guard commits in loop-free
    #: deployments.
    ba_apply_gate: float = float("inf")

    # ---- recording ----
    record_robot_info: bool = True
    record_features_info: bool = False

    def __post_init__(self):
        if self.sigma_rho is None:
            object.__setattr__(self, "sigma_rho", self.rho0 / 2.0)
        if self.sigma_mode == "implicit" and (
                self.qr_mode != "gram" or self.update_mode != "gram"):
            raise ValueError(
                "sigma_mode='implicit' requires qr_mode='gram' and "
                "update_mode='gram' (the implicit paths are derived from "
                "the Gram identities)")

    @property
    def rho0(self) -> float:
        """Initial inverse depth = 1/deep (SLAM.cpp:177)."""
        return 1.0 / self.deep

    @property
    def state_dim(self) -> int:
        """D = 6*M + 4; robot pose occupies the LAST four rows
        (layout per reference SLAM.h:271, SLAM.cpp:1184)."""
        return 6 * self.max_landmarks + 4

    @property
    def min_dist2(self) -> float:
        return self.min_dist * self.min_dist

    @property
    def min_step_theta(self) -> float:
        return self.min_step_theta_deg * math.pi / 180.0

    # -- serialization ------------------------------------------------------
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SlamConfig":
        d = json.loads(text)
        cam = d.pop("camera", None)
        cfg = cls(**d, camera=CameraConfig(**cam) if cam else CameraConfig())
        return cfg


DEFAULT_CONFIG = SlamConfig()
