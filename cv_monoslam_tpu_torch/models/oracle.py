"""Serial NumPy oracle of the reference SRUKF ceiling SLAM.

This is an independent, reference-faithful transcription of the serial math
in MonoSLAM/SLAM.cpp — the parity target called for by SURVEY.md §4/§6 and
BASELINE.md: the engine must match this oracle's trajectory (ATE) on
synthetic + recorded ceiling sequences.

It runs on the host, in NumPy, by design: it is the reference's serial math
that the engine is held against (``tests/test_torch_parity.py``, and on the
card ``chip_smoke.py``'s reference phase), not an engine entry point and not
a CPU fallback. It takes no device, and nothing on the engine's path imports
it. It is a copy of ``cv_monoslam_tpu/models/oracle.py`` (the two are held
equal by ``tests/test_torch_oracle.py``).

Faithful semantics (with file:line anchors):
  * state layout [feat_1(x,y,z,th,phi,rho), ..., feat_N, robot(x,y,z,th)]
    with upper-triangular sqrt covariance S, P = S^T S (SLAM.h:271-273)
  * Murray SRUKF weights, gamma = sqrt(3) (SLAM.cpp:1050-1103, weightType 0)
  * sigma points chi = [mu, mu +/- gamma * S_row_i^T] (SLAM.cpp:1148-1162)
  * motion update on the last-4 robot rows only, control noise subtracted
    from (rot1, trans, rot2) (SLAM.cpp:1476-1532); S by QR of sqrt(wi)-scaled
    deviations from chi_0 (SLAM.cpp:1539-1555)
  * sigma points are NOT resampled between motion and measurement — the
    propagated augmented set is reused (SLAM.cpp:1615-1691, 2020-2038)
  * sequential per-landmark 2D Kalman updates with recompose-refactor
    Cholesky downdate via Gill-Murray-Wright forced-PD factorization
    (SLAM.cpp:2048-2104, 2106-2155, 2197-2327)
  * landmark deletion rules + rank-6 Cholesky update fold-in
    (SLAM.cpp:2397-2706); redirection submap reset (SLAM.cpp:1343-1428)
  * feature init via augmented UT + QR + canonical reordering
    (SLAM.cpp:818-1334)

Documented deviations from the reference (quirks not reproduced):
  * patch warping uses the textbook plane-induced homography for the ceiling
    plane instead of the reference's viewing-ray-average normal and its
    row/column index swaps (SLAM.cpp:1804-1906) — the reference's version is
    an approximation of the same operation;
  * the loop re-insertion uses the *found* stored feature's state, where the
    reference indexes with the wrong loop variable (SLAM.cpp:981-982 uses
    [i] where every other field uses [j]);
  * the post-add reorder path in the Cholesky update (permutation + pivoted
    factorization, SLAM.cpp:2158-2179) is replaced by the same GMW forced-PD
    factorization used elsewhere — both are numerical workarounds for the
    rank deficiency introduced by feature anchors equal to the robot position.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..config import SlamConfig

# --------------------------------------------------------------------------
# numeric helpers (reference L0 layer)
# --------------------------------------------------------------------------


def qr_r(a: np.ndarray) -> np.ndarray:
    """Upper-triangular R of the thin QR of a (rows >= cols), as the
    reference's GSLQrDecomposition (SLAM.cpp:2330-2353)."""
    return np.linalg.qr(a, mode="r")


def gmw_cholesky(a: np.ndarray) -> np.ndarray:
    """Gill-Murray-Wright modified Cholesky: upper-triangular S with
    S^T S = A + E, E a minimal diagonal making A PD (SLAM.cpp:2197-2327).

    Standard GMW from "Practical Optimization": LDL^T with per-pivot floor
    delta and off-diagonal cap beta^2.
    """
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    if n == 0:
        return a.copy()
    eps = np.finfo(np.float64).eps
    diag = np.diag(a)
    gamma = max(np.max(np.abs(diag)), eps)
    offdiag = a - np.diag(diag)
    xi = max(np.max(np.abs(offdiag)) if n > 1 else 0.0, eps)
    delta = eps * max(gamma + xi, 1.0)
    beta2 = max(gamma, xi / max(np.sqrt(n * n - 1.0), 1.0), eps)

    L = np.zeros((n, n))
    d = np.zeros(n)
    c = np.zeros((n, n))
    for j in range(n):
        c[j, j] = a[j, j] - np.sum(d[:j] * L[j, :j] ** 2)
        for i in range(j + 1, n):
            c[i, j] = a[i, j] - np.sum(d[:j] * L[i, :j] * L[j, :j])
        theta = np.max(np.abs(c[j + 1 :, j])) if j < n - 1 else 0.0
        d[j] = max(abs(c[j, j]), theta * theta / beta2, delta)
        for i in range(j + 1, n):
            L[i, j] = c[i, j] / d[j]
        L[j, j] = 1.0
    # S = sqrt(D) L^T  (upper triangular), S^T S = L D L^T
    return (np.sqrt(d)[:, None] * L.T)


# --------------------------------------------------------------------------
# camera model (independent NumPy transcription; SLAM.cpp:3177-3420)
# --------------------------------------------------------------------------


class OracleCamera:
    def __init__(self, cfg: SlamConfig):
        c = cfg.camera
        self.w, self.h = c.width, c.height
        self.dx, self.dy = c.dx, c.dy
        self.cx, self.cy = c.cx, c.cy
        self.k1, self.k2 = c.k1, c.k2
        self.f1, self.f2 = c.f1, c.f2
        self.margin = c.margin

    def undistort(self, u, v):
        xd = (u - self.cx) * self.dx
        yd = (v - self.cy) * self.dy
        r2 = xd * xd + yd * yd
        d = 1 + self.k1 * r2 + self.k2 * r2 * r2
        return self.cx + xd * d / self.dx, self.cy + yd * d / self.dy

    def distort(self, u, v, iters: int = 100):
        """Newton solve with the reference's 100 iterations
        (SLAM.cpp:3186-3193) + visibility sentinel."""
        xu = (u - self.cx) * self.dx
        yu = (v - self.cy) * self.dy
        ru = np.sqrt(xu * xu + yu * yu)
        rd = ru / (1 + self.k1 * ru**2 + self.k2 * ru**4)
        for _ in range(iters):
            f = rd + self.k1 * rd**3 + self.k2 * rd**5 - ru
            fp = 1 + 3 * self.k1 * rd**2 + 5 * self.k2 * rd**4
            rd = rd - f / fp
        d = 1 + self.k1 * rd**2 + self.k2 * rd**4
        if d == 0:
            d = 1e-13
        ud = self.cx + (xu / d) / self.dx
        vd = self.cy + (yu / d) / self.dy
        if not (0 <= ud <= self.w and 0 <= vd <= self.h):
            return 0.0, 0.0
        return ud, vd

    def camera2image(self, hlr, err=(0.0, 0.0)):
        X, Y, Z = hlr
        if Z == 0:
            return 0.0, 0.0
        u = self.cy + self.f2 * Y / Z + err[0]
        v = self.cx + self.f1 * X / Z + err[1]
        m = self.margin
        if u < m or u > self.w - m or v < m or v > self.h - m:
            return 0.0, 0.0
        return u, v

    def image2camera(self, u, v):
        return np.array([(v - self.cx) / self.f1, (u - self.cy) / self.f2, 1.0])

    def project(self, hlr, err=(0.0, 0.0)):
        u, v = self.camera2image(hlr, err)
        if u == 0 and v == 0:
            return 0.0, 0.0
        return self.distort(u, v)

    @property
    def K(self):
        """Intrinsics in (v, u, 1) pixel-vector convention: row axis pairs
        with camera X through (cx, f1), column axis with Y through (cy, f2)."""
        return np.array(
            [[self.f1, 0, self.cx], [0, self.f2, self.cy], [0, 0, 1.0]]
        )


def yaw(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def wrap_angle(a):
    return np.arctan2(np.sin(a), np.cos(a))


# --------------------------------------------------------------------------
# frontend: Shi-Tomasi detection + NCC (NumPy; SLAM.cpp:574-768, 3141-3166)
# --------------------------------------------------------------------------


def shi_tomasi(image: np.ndarray, block_size: int = 3) -> np.ndarray:
    """Min-eigenvalue corner response (goodFeaturesToTrack's measure)."""
    from scipy.ndimage import sobel, uniform_filter

    img = image.astype(np.float64)
    gx = sobel(img, axis=1, mode="nearest") / 8.0
    gy = sobel(img, axis=0, mode="nearest") / 8.0
    ixx = uniform_filter(gx * gx, size=block_size, mode="nearest")
    iyy = uniform_filter(gy * gy, size=block_size, mode="nearest")
    ixy = uniform_filter(gx * gy, size=block_size, mode="nearest")
    tr = ixx + iyy
    det_disc = np.sqrt(np.maximum(((ixx - iyy) / 2) ** 2 + ixy * ixy, 0.0))
    return tr / 2 - det_disc  # min eigenvalue


def good_features(image: np.ndarray, max_corners: int, quality: float,
                  min_dist: float, block_size: int = 3) -> np.ndarray:
    """Top corners (u=col, v=row) with quality threshold + greedy min-dist,
    mirroring GoodFeaturesToTrackDetector (SLAM.cpp:599-600)."""
    resp = shi_tomasi(image, block_size)
    thresh = quality * resp.max()
    # 3x3 non-max suppression
    from scipy.ndimage import maximum_filter

    is_max = (resp == maximum_filter(resp, size=3, mode="nearest"))
    ys, xs = np.nonzero(is_max & (resp > thresh))
    order = np.argsort(-resp[ys, xs])
    ys, xs = ys[order], xs[order]
    picked = []
    md2 = min_dist * min_dist
    for x, y in zip(xs, ys):
        ok = True
        for px, py in picked:
            if (x - px) ** 2 + (y - py) ** 2 < md2:
                ok = False
                break
        if ok:
            picked.append((float(x), float(y)))
            if len(picked) >= max_corners:
                break
    return np.asarray(picked, dtype=np.float64).reshape(-1, 2)


def ncc(a: np.ndarray, b: np.ndarray) -> float:
    """Zero-mean NCC (SLAM.cpp:3141-3166)."""
    a = a.astype(np.float64) - a.mean()
    b = b.astype(np.float64) - b.mean()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(np.sum(a * b) / na / nb)


def _parabolic_offset(s_minus, s0, s_plus) -> float:
    """1-D parabolic sub-pixel peak offset from three NCC samples."""
    if s_minus is None or s_plus is None:
        return 0.0
    denom = s_minus - 2.0 * s0 + s_plus
    if denom >= -1e-12:
        return 0.0
    return float(np.clip(0.5 * (s_minus - s_plus) / denom, -0.5, 0.5))


def bilinear(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear sample img[v, u] with zero padding outside."""
    h, w = img.shape
    u0 = np.floor(u).astype(int)
    v0 = np.floor(v).astype(int)
    du, dv = u - u0, v - v0
    out = np.zeros_like(u, dtype=np.float64)
    valid = (u0 >= 0) & (u0 + 1 < w) & (v0 >= 0) & (v0 + 1 < h)
    u0c = np.clip(u0, 0, w - 2)
    v0c = np.clip(v0, 0, h - 2)
    s = (
        img[v0c, u0c] * (1 - du) * (1 - dv)
        + img[v0c, u0c + 1] * du * (1 - dv)
        + img[v0c + 1, u0c] * (1 - du) * dv
        + img[v0c + 1, u0c + 1] * du * dv
    )
    out[valid] = s[valid]
    return out


# --------------------------------------------------------------------------
# landmark record (reference PointsMap, SLAM.h:47-70)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Landmark:
    lid: int
    visible: bool = False
    matched: bool = False
    is_loop: bool = False
    n_predict: int = 0
    n_match: int = 0
    pred: np.ndarray = None      # predicted pixel (u, v)
    match: np.ndarray = None     # matched pixel (u, v)
    si: np.ndarray = None        # 2x2 sqrt innovation
    init_pixel: np.ndarray = None
    init_trans: np.ndarray = None    # camera position at init (3,)
    init_rot: np.ndarray = None      # R_wc at init
    init_patch: np.ndarray = None    # (21, 21)
    match_patch: np.ndarray = None   # (17, 17) warped
    xyz: np.ndarray = None           # Cartesian estimate


@dataclasses.dataclass
class StoredFeature:
    """Snapshot for redirection / loop reuse (FeatureInfo, SLAM.h:73-99)."""

    lid: int
    is_loop: bool
    n_predict: int
    n_match: int
    xyz: np.ndarray
    init_pixel: np.ndarray
    init_trans: np.ndarray
    init_rot: np.ndarray
    init_patch: np.ndarray
    state: np.ndarray   # 6-vector
    sr: np.ndarray      # 6x6 sqrt block


# --------------------------------------------------------------------------
# the oracle filter
# --------------------------------------------------------------------------


class OracleSLAM:
    """Reference-faithful serial SRUKF. One instance per run."""

    def __init__(self, cfg: SlamConfig, images, track):
        self.cfg = cfg
        self.cam = OracleCamera(cfg)
        self.images = images
        self.track = track
        self.counter = 1               # m_frame.counter (SLAM.cpp:246)
        self.next_id = 1
        self.landmarks: List[Landmark] = []
        self.stored: List[StoredFeature] = []
        self.x = np.zeros(4)
        self.x[3] = track.theta[0]     # SLAM.cpp:397
        self.S = np.diag([cfg.sigma_x, cfg.sigma_y, cfg.sigma_z,
                          cfg.sigma_theta])
        self.sigma = None              # augmented sigma points (Na, 2Na+1)
        self.sigma_pix = None          # (2*nmap, 2Na+1)
        self.pred_mean = None          # (2*nmap,)
        self.n_addings = 0
        self.first_detect_done = False
        self.image = self.images.get(int(track.frame_id[0]))
        self.traj: List[np.ndarray] = []
        # initial map (initializeParameters -> addFeatures, SLAM.cpp:348-350)
        self.add_features(force=False, first=True)

    # -- weights (SLAM.cpp:1050-1103, Murray scheme) -----------------------
    def weights(self, na: int):
        wm0 = 1.0 - na / 3.0
        wi = (1.0 - wm0) / (2 * na)
        return wm0, wi, np.sqrt(wi), np.sqrt(3.0)

    def gen_sigma(self, mu: np.ndarray, sr: np.ndarray, gamma: float):
        na = len(mu)
        sig = np.empty((na, 2 * na + 1))
        sig[:, 0] = mu
        sig[:, 1 : na + 1] = mu[:, None] + gamma * sr.T
        sig[:, na + 1 :] = mu[:, None] - gamma * sr.T
        return sig

    @property
    def dim(self):
        return len(self.x)

    @property
    def nmap(self):
        return len(self.landmarks)

    # ------------------------------------------------------------------
    def step(self):
        """One frame (CSLAM::SLAM, SLAM.cpp:87-112)."""
        self.predict_motion()
        self.predict_measurement()
        self.image = self.images.get(int(self.track.frame_id[self.counter]))
        self.data_association()
        self.kalman_update()
        self.update_features()
        self.traj.append(self.x[-4:].copy())
        if self.n_matched < self.cfg.min_num:
            self.add_features()
        self.counter += 1

    @property
    def n_matched(self):
        return sum(1 for l in self.landmarks if l.matched)

    # -- motion (SLAM.cpp:1343-1595) ---------------------------------------
    def predict_motion(self):
        cfg = self.cfg
        k = self.counter
        if self.track.redirect[k]:
            self._redirect()
            k = self.counter
        dim = self.dim
        xy = self.track.xy
        th = self.track.theta
        dx_, dy_ = xy[k, 0] - xy[k - 1, 0], xy[k, 1] - xy[k - 1, 1]
        rot1 = np.arctan2(dy_, dx_) - th[k - 1]
        trans = np.hypot(dx_, dy_)
        rot2 = th[k] - th[k - 1] - rot1
        mt = np.diag(np.minimum([
            cfg.a1 * rot1**2 + cfg.a2 * trans**2,
            cfg.a3 * trans**2 + cfg.a4 * rot1**2 + cfg.a4 * rot2**2,
            cfg.a1 * rot2**2 + cfg.a2 * trans**2,
        ], cfg.motion_noise_cap))  # values-as-sqrt like the reference,
        # capped (see config.motion_noise_cap)
        # NOTE: the reference also augments 2 *shared* measurement-noise
        # dims (Qt, SLAM.cpp:1462). Shared noise correlates every
        # landmark's pixel deviations, which both degenerates the joint
        # update and mismodels per-landmark pixel noise; independent noise
        # is added in the innovation sqrt and update instead.
        na = dim + 5
        wm0, wi, wi_sr, gamma = self.weights(na)
        mu = np.concatenate([self.x, np.zeros(5)])
        sr = np.zeros((na, na))
        sr[:dim, :dim] = self.S
        sr[dim : dim + 3, dim : dim + 3] = mt
        sig = self.gen_sigma(mu, sr, gamma)
        # propagate robot rows (SLAM.cpp:1488-1530)
        r1 = rot1 - sig[dim + 0]
        tr = trans - sig[dim + 1]
        r2 = rot2 - sig[dim + 2]
        sig[dim - 4] += tr * np.cos(sig[dim - 1] + r1)
        sig[dim - 3] += tr * np.sin(sig[dim - 1] + r1)
        sig[dim - 1] += r1 + r2
        self.sigma = sig
        # robot mean (SLAM.cpp:1518-1530)
        w = np.full(2 * na + 1, wi)
        w[0] = wm0
        self.x = sig[:dim] @ w
        # S by QR of deviations from chi_0 (SLAM.cpp:1539-1555)
        dev = wi_sr * (sig[:dim, 1:] - sig[:dim, :1]).T
        self.S = qr_r(dev)

    def _redirect(self):
        """Submap reset on |dtheta| > 45 deg (SLAM.cpp:1354-1428)."""
        cfg = self.cfg
        for i, lm in enumerate(self.landmarks):
            self.stored.append(self._snapshot(i, lm))
        k = self.counter
        self.image = self.images.get(int(self.track.frame_id[k]))
        pos = self.x[-4:-2].copy()
        self.x = np.zeros(4)
        self.x[:2] = pos
        self.x[3] = self.track.theta[k]
        self.S = np.diag([cfg.sigma_x, cfg.sigma_y, cfg.sigma_z,
                          cfg.sigma_theta])
        self.landmarks = []
        self.add_features(force=True, is_redirect=True)
        self.counter += 1
        self.x[3] = self.track.theta[self.counter]

    def _snapshot(self, idx: int, lm: Landmark) -> StoredFeature:
        s = slice(6 * idx, 6 * idx + 6)
        return StoredFeature(
            lid=lm.lid, is_loop=lm.is_loop, n_predict=lm.n_predict,
            n_match=lm.n_match, xyz=lm.xyz.copy(),
            init_pixel=lm.init_pixel.copy(), init_trans=lm.init_trans.copy(),
            init_rot=lm.init_rot.copy(), init_patch=lm.init_patch.copy(),
            state=self.x[s].copy(), sr=self.S[s, s].copy(),
        )

    # -- measurement predict (SLAM.cpp:1604-1795) --------------------------
    def feature_world(self, feat6, cam_pos):
        x, y, z, th, ph, rho = feat6
        if rho == 0:
            rho = 1e-13
        m = np.array([
            np.cos(ph) * np.sin(th), -np.sin(ph), np.cos(ph) * np.cos(th)
        ])
        return feat6[:3] + m / rho - cam_pos

    def predict_measurement(self):
        dim, nmap = self.dim, self.nmap
        if nmap == 0:
            self.pred_mean = np.zeros(0)
            self.sigma_pix = np.zeros((0, self.sigma.shape[1]))
            return
        na = dim + 5
        wm0, wi, wi_sr, _ = self.weights(na)
        ncols = 2 * na + 1
        pix = np.zeros((2 * nmap, ncols))
        for i in range(ncols):
            err = self.sigma[dim + 3 : dim + 5, i]
            pos = self.sigma[dim - 4 : dim - 1, i]
            rcw = yaw(self.sigma[dim - 1, i]).T
            for j in range(nmap):
                hlw = self.feature_world(self.sigma[6 * j : 6 * j + 6, i], pos)
                hlr = rcw @ hlw
                pix[2 * j : 2 * j + 2, i] = self.cam.project(hlr, err)
        w = np.full(ncols, wi)
        w[0] = wm0
        self.pred_mean = pix @ w
        self.sigma_pix = pix
        # per-feature visibility + 2x2 sqrt innovation (SLAM.cpp:1700-1795)
        for j, lm in enumerate(self.landmarks):
            px, py = self.pred_mean[2 * j : 2 * j + 2]
            if px != 0 and py != 0:
                lm.visible = True
                lm.matched = False
                lm.n_predict += 1
                lm.pred = np.array([px, py])
                dev = wi_sr * (pix[2 * j : 2 * j + 2, 1:]
                               - pix[2 * j : 2 * j + 2, :1]).T
                # independent measurement noise: Pyy = geo + sigma^2 I
                lm.si = qr_r(np.concatenate(
                    [dev, np.eye(2) * self.cfg.sigma_measure], axis=0))
            else:
                lm.visible = False
                lm.matched = False

    # -- patch warp (plane-induced homography; cf SLAM.cpp:1804-1906) ------
    def warp_matrix(self, lm: Landmark) -> np.ndarray:
        """2x2 affine warp A = d(init pixel)/d(current pixel) at the feature,
        from the ceiling-plane homography between the init and current views.

        The reference builds the full homography and re-centres its sample
        grid on the homography image of the feature (SLAM.cpp:1860-1906),
        which makes the warp insensitive to translation error in the plane
        distance; linearizing the homography at the feature point achieves
        the same invariance with a single 2x2 Jacobian.
        """
        r1 = yaw(self.x[-1])
        c1 = self.x[-4:-1]
        r0, c0 = lm.init_rot, lm.init_trans
        d0 = lm.xyz[2] - c0[2]             # plane distance in the init view
        if abs(d0) < 1e-6:
            d0 = 1e-6
        n0 = r0.T @ np.array([0.0, 0.0, 1.0])
        R10 = r1.T @ r0                    # camera0 -> camera1
        t10 = r1.T @ (c0 - c1)
        K = self.cam.K
        H10 = K @ (R10 + np.outer(t10, n0) / d0) @ np.linalg.inv(K)
        # Jacobian of the projective map at the init pixel (v, u, 1 coords)
        u0, v0 = self.cam.undistort(*lm.init_pixel)
        p0 = np.array([v0, u0, 1.0])
        q = H10 @ p0
        J10 = (H10[:2, :2] * q[2] - np.outer(q[:2], H10[2, :2])) / (q[2] ** 2)
        return np.linalg.inv(J10)          # current -> init, (dv,du) order

    def warp_patch(self, lm: Landmark) -> np.ndarray:
        """Warp the 21x21 init patch into a 17x17 current-view match patch
        by bilinear sampling along the affine warp (cf SLAM.cpp:1804-1906).

        Within a 17-px patch the differential radial distortion (k1 = 1e-4)
        is far below a pixel, so the affine map is applied directly in
        distorted pixel coordinates.
        """
        hp_m = self.cfg.hp_match
        A = self.warp_matrix(lm)           # (dv,du) -> (dv0,du0)
        d = np.arange(-hp_m, hp_m + 1, dtype=np.float64)
        dv, du = np.meshgrid(d, d, indexing="ij")
        v0 = lm.init_pixel[1] + A[0, 0] * dv + A[0, 1] * du
        u0 = lm.init_pixel[0] + A[1, 0] * dv + A[1, 1] * du
        hp_i = self.cfg.hp_init
        pu = u0 - (lm.init_pixel[0] - hp_i)
        pv = v0 - (lm.init_pixel[1] - hp_i)
        return bilinear(lm.init_patch, pu, pv)

    # -- data association (SLAM.cpp:1915-2009) -----------------------------
    def data_association(self):
        cfg = self.cfg
        hp_m = cfg.hp_match
        img = self.image
        h, w = img.shape
        for lm in self.landmarks:
            if not lm.visible:
                continue
            lm.match_patch = self.warp_patch(lm)
            px, py = lm.pred
            pi = lm.si.T @ lm.si
            if abs(np.linalg.det(pi)) < 1e-12:
                continue  # degenerate innovation (e.g. sentinel-polluted)
            pi_inv = np.linalg.inv(pi)
            half_x = int(np.ceil(2 * abs(lm.si[0, 0])))
            half_y = int(np.ceil(2 * abs(lm.si[1, 1])))
            half_x = min(cfg.hp_init, max(hp_m, half_x))
            half_y = min(cfg.hp_init, max(hp_m, half_y))
            best, best_uv = 0.0, None
            ipx, ipy = int(px), int(py)
            scores = {}
            for iu in range(ipx - half_x, ipx + half_x + 1):
                if iu < hp_m or iu > w - hp_m - 1:
                    continue
                for iv in range(ipy - half_y, ipy + half_y + 1):
                    if iv < hp_m or iv > h - hp_m - 1:
                        continue
                    e = np.array([iu - px, iv - py])
                    if e @ pi_inv @ e >= cfg.chi2_gate:
                        continue
                    roi = img[iv - hp_m : iv + hp_m + 1,
                              iu - hp_m : iu + hp_m + 1]
                    c = ncc(roi, lm.match_patch)
                    scores[(iu, iv)] = c
                    if c > best:
                        best, best_uv = c, (iu, iv)
            if best > cfg.threshold_match_patch:
                mu_, mv_ = float(best_uv[0]), float(best_uv[1])
                if cfg.subpixel_match:
                    mu_ += _parabolic_offset(
                        scores.get((best_uv[0] - 1, best_uv[1])),
                        best, scores.get((best_uv[0] + 1, best_uv[1])))
                    mv_ += _parabolic_offset(
                        scores.get((best_uv[0], best_uv[1] - 1)),
                        best, scores.get((best_uv[0], best_uv[1] + 1)))
                lm.matched = True
                lm.n_match += 1
                lm.match = np.array([mu_, mv_])

    # -- Kalman update (SLAM.cpp:2048-2155) --------------------------------
    def kalman_update(self):
        """Measurement update over the matched landmarks.

        Default mode is the *joint* square-root update over all matches at
        once — the batched semantics BASELINE.json mandates in place of the
        reference's per-landmark loop. The reference's sequential update
        (SLAM.cpp:2048-2104) reuses the prior sigma-point deviations for
        every match, so each successive gain overcounts information; the
        resulting indefinite downdates are patched by its forced-PD
        refactorization, inflating the covariance. The joint update is the
        exact conditional on the same sigma-point joint Gram:

            M = [Z | A],  A = sqrt(wi) (chi_i - chi_0)^T   (state dev.)
                          Z = sqrt(wi) (z_i - z_0)^T       (pixel dev.)
            R = qr(M) = [[Ryy, Ryx], [0, Rxx]]
            K nu = Ryx^T Ryy^-T nu,   S_post = Rxx   (Schur complement)

        ``update_mode="sequential"`` keeps the reference-faithful stale
        sequential loop for structural comparison.
        """
        if self.cfg.update_mode == "sequential":
            return self._kalman_update_sequential()
        dim = self.dim
        na = dim + 5
        _, wi, wi_sr, _ = self.weights(na)
        midx = [j for j, lm in enumerate(self.landmarks) if lm.matched]
        if not midx:
            return
        rows = np.concatenate([[2 * j, 2 * j + 1] for j in midx])
        A = wi_sr * (self.sigma[:dim, 1:] - self.sigma[:dim, :1]).T
        Z = wi_sr * (self.sigma_pix[rows, 1:] - self.sigma_pix[rows, :1]).T
        nu = np.concatenate(
            [self.landmarks[j].match - self.landmarks[j].pred for j in midx]
        )
        m2 = len(rows)
        top = np.concatenate([Z, A], axis=1)
        noise = np.concatenate(
            [np.eye(m2) * self.cfg.sigma_measure,
             np.zeros((m2, A.shape[1]))], axis=1)
        R = qr_r(np.concatenate([top, noise], axis=0))
        ryy = R[:m2, :m2]
        ryx = R[:m2, m2:]
        rxx = R[m2:, m2:]
        self.x = self.x + ryx.T @ np.linalg.solve(ryy.T, nu)
        self.S = rxx

    def _kalman_update_sequential(self):
        """Reference-faithful sequential per-landmark updates
        (SLAM.cpp:2048-2155), with the Murray-consistent cross-covariance."""
        dim = self.dim
        na = dim + 5
        _, wi, _, _ = self.weights(na)
        for j, lm in enumerate(self.landmarks):
            if not lm.matched:
                continue
            si = lm.si
            if min(abs(si[0, 0]), abs(si[1, 1])) < 1e-6:
                continue
            dx = self.sigma[:dim, 1:] - self.sigma[:dim, :1]
            dz = (self.sigma_pix[2 * j : 2 * j + 2, 1:]
                  - self.sigma_pix[2 * j : 2 * j + 2, :1])
            pxy = wi * dx @ dz.T
            sii = np.linalg.inv(si)
            K = pxy @ sii @ sii.T
            self.x = self.x + K @ (lm.match - lm.pred)
            U = K @ si.T
            # recompose-refactor downdate (SLAM.cpp:2106-2155)
            for col in range(U.shape[1]):
                u = U[:, col]
                self.S = gmw_cholesky(self.S.T @ self.S - np.outer(u, u))

    # -- lifecycle: deletion (SLAM.cpp:2397-2706) --------------------------
    def update_features(self):
        cfg = self.cfg
        b = cfg.dist_to_border
        w_img, h_img = self.cam.w, self.cam.h
        i = 0
        while i < len(self.landmarks):
            lm = self.landmarks[i]
            feat = self.x[6 * i : 6 * i + 6]
            rho = feat[5]
            hlr_z = rho * (feat[2] - self.x[-2]) + np.cos(feat[4]) * np.cos(
                feat[3]
            )
            px, py = (lm.pred if lm.pred is not None else (0.0, 0.0))
            delete = (
                (lm.n_predict > cfg.delete_predict_ratio * lm.n_match
                 and lm.n_predict >= cfg.delete_predict_min)
                or rho < cfg.delete_rho_min
                or hlr_z < 0.0
                or px < b or py < b or w_img - px < b or h_img - py < b
            )
            store = False
            if lm.matched:
                mx, my = lm.match
                near = (mx < b or my < b or w_img - mx < b or h_img - my < b)
                delete = delete or near
                border_pred = (px < b or py < b or w_img - px < b
                               or h_img - py < b)
                if delete and (near or border_pred) and not (
                    (lm.n_predict > cfg.delete_predict_ratio * lm.n_match
                     and lm.n_predict >= cfg.delete_predict_min)
                    or rho < cfg.delete_rho_min or hlr_z < 0.0
                ):
                    store = True
            if delete:
                if store:
                    self.stored.append(self._snapshot(i, lm))
                self._delete_feature(i)
            else:
                lm.xyz = self._cartesian(i)
                lm.visible = False
                i += 1

    def _cartesian(self, i):
        f = self.x[6 * i : 6 * i + 6]
        rho = f[5] if f[5] != 0 else 1e-13
        m = np.array([
            np.cos(f[4]) * np.sin(f[3]), -np.sin(f[4]),
            np.cos(f[4]) * np.cos(f[3]),
        ])
        return f[:3] + m / rho

    def _delete_feature(self, i):
        """Remove slot i; fold its S rows into the rest via Cholesky update
        (SLAM.cpp:2637-2706)."""
        dim = self.dim
        keep = np.r_[0 : 6 * i, 6 * i + 6 : dim]
        V = self.S[6 * i : 6 * i + 6][:, keep]   # removed rows, kept cols
        self.x = self.x[keep]
        self.S = self.S[np.ix_(keep, keep)]
        for col in range(V.shape[0]):
            u = V[col, :]
            self.S = gmw_cholesky(self.S.T @ self.S + np.outer(u, u))
        del self.landmarks[i]

    # -- feature addition (SLAM.cpp:552-1018, 1177-1334) -------------------
    def add_features(self, force=False, first=False, is_redirect=False):
        cfg = self.cfg
        raws = cfg.n_initial_raws if (first or is_redirect) else cfg.n_process_raws
        new_pix, loop_ids = self._detect(raws, first, is_redirect)
        tries = 0
        while (self.nmap + len(new_pix) + len(loop_ids)) < cfg.min_num:
            raws += cfg.min_num
            if raws > 30:
                break
            new_pix, loop_ids = self._detect(raws, first, is_redirect)
            tries += 1
        self.n_addings = len(new_pix) + len(loop_ids)
        if len(new_pix):
            self._integrate(np.asarray(new_pix))
        if is_redirect and loop_ids:
            self._readd_loop(loop_ids)

    def _detect(self, raws, first, is_redirect):
        cfg = self.cfg
        kps = good_features(self.image, raws, cfg.quality_level, cfg.min_dist,
                            cfg.block_size)
        b = cfg.dist_to_border
        w_img, h_img = self.cam.w, self.cam.h
        picked, loop_ids = [], []
        # projected stored features for loop detection (SLAM.cpp:618-638)
        stored_pix = []
        if is_redirect:
            pos = self.x[-4:-1]
            rcw = yaw(self.x[-1]).T
            for sf in self.stored:
                hlw = self.feature_world(sf.state, pos)
                stored_pix.append(self.cam.project(rcw @ hlw))
        for kx, ky in kps:
            if not (b <= kx <= w_img - b and b <= ky <= h_img - b):
                continue
            if first:
                picked.append((kx, ky))
                continue
            ok = True
            if not is_redirect and self.n_matched != 0:
                for lm in self.landmarks:
                    pm = lm.match if lm.match is not None else np.zeros(2)
                    pp = lm.pred if lm.pred is not None else np.zeros(2)
                    if np.all(pm == 0) or np.all(pp == 0):
                        ok = False
                        continue
                    if ((kx - pm[0]) ** 2 + (ky - pm[1]) ** 2 < cfg.min_dist2
                            or (kx - pp[0]) ** 2 + (ky - pp[1]) ** 2
                            < cfg.min_dist2):
                        ok = False
                        break
            if ok and is_redirect:
                for sf, sp in zip(list(self.stored), stored_pix):
                    if (kx - sp[0]) ** 2 + (ky - sp[1]) ** 2 < cfg.min_dist2:
                        ok = False
                        if sf.lid not in loop_ids:
                            loop_ids.append(sf.lid)
                        break
            if ok:
                for qx, qy in picked:
                    if (kx - qx) ** 2 + (ky - qy) ** 2 < cfg.min_dist2:
                        ok = False
                        break
            if ok:
                picked.append((kx, ky))
        return picked, loop_ids

    def _integrate(self, pix: np.ndarray):
        """Augmented-UT state extension + canonical reorder
        (SLAM.cpp:818-946, 1177-1334)."""
        cfg = self.cfg
        k = len(pix)
        dim = self.dim
        na = dim + 3 * k
        wm0, wi, wi_sr, gamma = self.weights(na)
        mu2 = np.zeros(3 * k)
        sr2 = np.zeros((3 * k, 3 * k))
        for i in range(k):
            mu2[3 * i : 3 * i + 2] = pix[i]
            mu2[3 * i + 2] = cfg.rho0
            sr2[3 * i, 3 * i] = cfg.sigma_measure
            sr2[3 * i + 1, 3 * i + 1] = cfg.sigma_measure
            sr2[3 * i + 2, 3 * i + 2] = cfg.sigma_rho
        mu = np.concatenate([self.x, mu2])
        sr = np.zeros((na, na))
        sr[:dim, :dim] = self.S
        sr[dim:, dim:] = sr2
        sig_in = self.gen_sigma(mu, sr, gamma)
        ncols = 2 * na + 1
        # map function: pixel -> world angles per sigma point
        sig_out = np.zeros((dim + 6 * k, ncols))
        sig_out[:dim] = sig_in[:dim]
        mean_hlw = np.zeros(3 * k)
        w = np.full(ncols, wi)
        w[0] = wm0
        hlw_all = np.zeros((3 * k, ncols))
        for i in range(ncols):
            rwc = yaw(sig_in[dim - 1, i])
            pos = sig_in[dim - 4 : dim - 1, i]
            for j in range(k):
                uvd = sig_in[dim + 3 * j : dim + 3 * j + 2, i]
                rho = sig_in[dim + 3 * j + 2, i]
                uu, vu = self.cam.undistort(uvd[0], uvd[1])
                hlr = self.cam.image2camera(uu, vu)
                hlw = rwc @ hlr
                th = np.arctan2(hlw[0], hlw[2])
                ph = np.arctan2(-hlw[1], np.hypot(hlw[0], hlw[2]))
                if self.cfg.rho_init_mode == "ceiling":
                    # rho = m_z * (1/depth): exact for a flat ceiling at
                    # height deep; the noise dim scales proportionally.
                    rho = rho * np.cos(ph) * np.cos(th)
                sig_out[dim + 3 * j : dim + 3 * j + 3, i] = (th, ph, rho)
                sig_out[dim + 3 * k + 3 * j : dim + 3 * k + 3 * j + 3, i] = pos
                hlw_all[3 * j : 3 * j + 3, i] = hlw
        mean_hlw = hlw_all @ w
        mean_angle = sig_out[dim : dim + 3 * k] @ w
        # disordered mean: [x_old, angles, positions] (SLAM.cpp:1246-1250)
        cam_pos = self.x[-4:-1]
        x_dis = np.concatenate([self.x, mean_angle, np.tile(cam_pos, k)])
        dev = wi_sr * (sig_out[:, 1:] - sig_out[:, :1]).T
        s_dis = qr_r(dev)
        # permutation to canonical layout (SLAM.cpp:1292-1334)
        newdim = dim + 6 * k
        perm = np.zeros((newdim, newdim))
        dim_old = dim
        if dim_old != 4:
            perm[: dim_old - 4, : dim_old - 4] = np.eye(dim_old - 4)
        for r in range(4):
            perm[newdim - 4 + r, dim_old - 4 + r] = 1
        for j in range(k):
            base = dim_old - 4 + 6 * j
            perm[base + 0, dim_old + 3 * k + 3 * j + 0] = 1
            perm[base + 1, dim_old + 3 * k + 3 * j + 1] = 1
            perm[base + 2, dim_old + 3 * k + 3 * j + 2] = 1
            perm[base + 3, dim_old + 3 * j + 0] = 1
            perm[base + 4, dim_old + 3 * j + 1] = 1
            perm[base + 5, dim_old + 3 * j + 2] = 1
        self.x = perm @ x_dis
        self.S = qr_r(perm @ s_dis @ perm.T)
        # landmark records (SLAM.cpp:891-946)
        rwc = yaw(self.x[-1])
        hp = self.cfg.hp_init
        h_img, w_img = self.image.shape
        for j in range(k):
            u, v = pix[j]
            iu, iv = int(round(u)), int(round(v))
            patch = self.image[iv - hp : iv + hp + 1, iu - hp : iu + hp + 1]
            # Cartesian estimate from the initialized inverse-depth state
            # (the reference stores the unit-ray point here and recomputes a
            # proper one next frame, SLAM.cpp:911-913 vs 2566; we store the
            # proper one immediately)
            th_j, ph_j, rho_j = mean_angle[3 * j : 3 * j + 3]
            ray = np.array([
                np.cos(ph_j) * np.sin(th_j), -np.sin(ph_j),
                np.cos(ph_j) * np.cos(th_j),
            ])
            self.landmarks.append(
                Landmark(
                    lid=self.next_id,
                    xyz=cam_pos + ray / (rho_j if rho_j != 0 else 1e-13),
                    init_pixel=np.array([u, v]),
                    init_trans=cam_pos.copy(),
                    init_rot=rwc.copy(),
                    init_patch=patch.astype(np.float64).copy(),
                )
            )
            self.next_id += 1

    def _readd_loop(self, loop_ids):
        """Splice stored features back into state (SLAM.cpp:948-1015)."""
        for lid in loop_ids:
            j = next(i for i, sf in enumerate(self.stored) if sf.lid == lid)
            sf = self.stored.pop(j)
            dim = self.dim
            x_new = np.zeros(dim + 6)
            x_new[: dim - 4] = self.x[: dim - 4]
            x_new[dim - 4 : dim + 2] = sf.state
            x_new[dim + 2 :] = self.x[dim - 4 :]
            s_new = np.zeros((dim + 6, dim + 6))
            s_new[: dim - 4, : dim - 4] = self.S[: dim - 4, : dim - 4]
            s_new[: dim - 4, dim + 2 :] = self.S[: dim - 4, dim - 4 :]
            s_new[dim + 2 :, : dim - 4] = self.S[dim - 4 :, : dim - 4]
            s_new[dim + 2 :, dim + 2 :] = self.S[dim - 4 :, dim - 4 :]
            s_new[dim - 4 : dim + 2, dim - 4 : dim + 2] = sf.sr
            self.x, self.S = x_new, s_new
            self.landmarks.append(
                Landmark(
                    lid=sf.lid, is_loop=True, xyz=sf.xyz,
                    init_pixel=sf.init_pixel, init_trans=sf.init_trans,
                    init_rot=sf.init_rot, init_patch=sf.init_patch,
                )
            )
        self.S = qr_r(self.S)

    # ------------------------------------------------------------------
    def run(self, n_frames: Optional[int] = None) -> np.ndarray:
        n = len(self.track) - 1 if n_frames is None else n_frames
        for _ in range(n):
            if self.counter >= len(self.track):
                break
            self.step()
        return np.asarray(self.traj)
