"""The benchmark's traffic: a ceiling world and a closed patrol lap, made from
the seed, rendered once on the device and driven lap after lap.

One general generator reads every traffic file (``traffic/<mix>.json``):

* ``world``: ``{"kind": "blobs", "extent", "density", "seed"}`` (random
  Gaussian blobs) or ``{"kind": "grid", "extent", "spacing", "jitter",
  "seed"}`` (a jittered blob grid, an acoustic-tile ceiling), both at the
  camera's ``deep``; the world is the mix's own, drawn from its ``seed``;
* ``lap``: ``{"frames": n, "step_m": s}``, a closed circle of ``n`` frames
  ``s`` metres apart, turning ``2 pi / n`` a frame;
* ``odometry``: ``{"sigma_xy": ..., "sigma_theta": ...}``, a random walk
  added to the true pose (0 for clean odometry).

The run's seed chooses where on the lap the recording starts (frame ``seed
mod n``), so every seed drives the same world and the same lap, lap after
lap, from another start: the same work in another order. The odometry is
rebased to start at the origin, as the program's reader rebases it.

The world's blobs are those of the port's NumPy generator
(``io/synthetic.make_world`` / ``make_world_periodic``, frozen here), and
the frames those of its blob-stamped renderer (``SyntheticWorld._stamp``):
each blob's Gaussian is evaluated over its 5-sigma pixel box, in float64,
on the device, then rounded to uint8 as the committed fixtures are. The
stamps are summed without atomics, so one seed gives the same frames.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Camera:
    """The camera fields the renderer needs (``SlamConfig.camera``)."""

    width: int
    height: int
    dx: float
    dy: float
    cx: float
    cy: float
    k1: float
    k2: float
    f: float

    @property
    def f1(self) -> float:
        return self.f / self.dx

    @property
    def f2(self) -> float:
        return self.f / self.dy


@dataclasses.dataclass
class Lap:
    """One rendered lap and the odometry of the whole run."""

    frames: np.ndarray      # (n, H, W) uint8, the lap's images
    raw: np.ndarray         # (N, 4) [image id, x, y, theta], N >= n
    #: (n, 2) true positions of the lap's frames, rebased as the odometry
    gt_xy: np.ndarray
    render_s: float = 0.0


def make_blobs(seed: int, world: dict) -> np.ndarray:
    """(K, 4) blobs ``[wx, wy, sigma, amplitude]`` of the world ``world``
    from ``seed`` (the draws of ``io/synthetic.make_world`` and
    ``make_world_periodic``)."""
    rng = np.random.default_rng(seed)
    if world["kind"] == "blobs":
        extent = float(world["extent"])
        n = int(float(world["density"]) * extent * extent)
        pos = rng.uniform(-extent / 2, extent / 2, size=(n, 2))
        sig = rng.uniform(0.03, 0.07, size=(n, 1))
        amp = rng.uniform(60.0, 200.0, size=(n, 1))
    elif world["kind"] == "grid":
        extent, spacing = float(world["extent"]), float(world["spacing"])
        k = int(extent / spacing)
        gx, gy = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
        pos = (np.stack([gx, gy], axis=-1).reshape(-1, 2) * spacing
               - extent / 2.0)
        pos = pos + rng.normal(0, float(world["jitter"]), pos.shape)
        n = len(pos)
        sig = np.full((n, 1), 0.018)
        amp = rng.uniform(140.0, 180.0, size=(n, 1))
    else:
        raise ValueError(f"unknown world kind {world['kind']!r}")
    return np.concatenate([pos, sig, amp], axis=1)


def lap_poses(n: int, step: float, count: int, start: int = 0):
    """Poses of ``count`` frames driven round a closed circle of ``n``
    frames, ``step`` metres apart, from the lap's frame ``start``: ``(lap
    frame of each (count,), xy (count, 2), theta (count,))``. Frame k is at
    the lap's frame ``(start + k) % n``; theta keeps growing."""
    k = start + np.arange(count)
    theta = k * (2.0 * np.pi / n)
    i = np.arange(n)
    d = step * np.stack([np.cos(i * 2.0 * np.pi / n),
                         np.sin(i * 2.0 * np.pi / n)], axis=1)
    d[0] = 0.0
    # the lap's own vertices, repeated: frame k and frame k + n coincide
    lap_xy = np.cumsum(d, axis=0)
    return k % n, lap_xy[k % n], theta


def start_frame(traffic: dict, seed: int) -> int:
    return int(seed) % int(traffic["lap"]["frames"])


def odometry(traffic: dict, seed: int, count: int) -> np.ndarray:
    """(count, 4) raw odometry rows ``[image id, x, y, theta]`` of ``count``
    frames from the seed's start: the lap's true poses, rebased to start at
    the origin, plus the mix's random walk."""
    n, step = int(traffic["lap"]["frames"]), float(traffic["lap"]["step_m"])
    ids, xy, theta = lap_poses(n, step, count, start_frame(traffic, seed))
    xy = xy - xy[0]
    odo = traffic.get("odometry", {})
    sxy, sth = float(odo.get("sigma_xy", 0.0)), float(odo.get("sigma_theta",
                                                              0.0))
    if sxy or sth:
        rng = np.random.default_rng([seed, 1])
        xy = xy + np.cumsum(rng.normal(0, sxy, size=(count, 2)), axis=0)
        theta = theta + np.cumsum(rng.normal(0, sth, size=count))
    return np.concatenate([ids[:, None].astype(np.float64), xy,
                           theta[:, None]], axis=1)


def render(blobs: np.ndarray, cam: Camera, deep: float, xy: np.ndarray,
           theta: np.ndarray, device, base: float = 40.0) -> torch.Tensor:
    """(n, H, W) float64 frames of the poses ``xy``, ``theta`` on
    ``device``: ``SyntheticWorld._stamp`` batched over blobs."""
    dev = torch.device(device)
    f64 = torch.float64
    H, W = cam.height, cam.width
    b = torch.as_tensor(blobs, dtype=f64, device=dev)
    bx, by, sig, amp = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    half = torch.ceil(5.0 * sig * cam.f1 / deep).to(torch.int64) + 3
    # pixel -> camera ray, the same for every frame (SyntheticWorld.render)
    v, u = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                          torch.arange(W, dtype=f64, device=dev),
                          indexing="ij")
    xd = (u - cam.cx) * cam.dx
    yd = (v - cam.cy) * cam.dy
    rd2 = xd * xd + yd * yd
    d = 1.0 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
    uu = cam.cx + xd * d / cam.dx
    vu = cam.cy + yd * d / cam.dy
    X = ((vu - cam.cx) / cam.f1).reshape(-1)
    Y = ((uu - cam.cy) / cam.f2).reshape(-1)
    out = torch.empty((len(theta), H, W), dtype=f64, device=dev)
    for i in range(len(theta)):
        out[i] = _stamp(bx, by, sig, amp, half, X, Y, cam, deep,
                        float(xy[i, 0]), float(xy[i, 1]), float(theta[i]),
                        base)
    return out


def _stamp(bx, by, sig, amp, half, X, Y, cam: Camera, t: float, px: float,
           py: float, th: float, base: float) -> torch.Tensor:
    H, W = cam.height, cam.width
    c, s = float(np.cos(th)), float(np.sin(th))
    wx = px + t * (c * X - s * Y)
    wy = py + t * (s * X + c * Y)
    # world -> undistorted pixel of each blob centre, then the distortion
    # factor inverted by fixed point
    Xb = (c * (bx - px) + s * (by - py)) / t
    Yb = (-s * (bx - px) + c * (by - py)) / t
    vu = cam.cx + cam.f1 * Xb
    uu = cam.cy + cam.f2 * Yb
    ru2 = ((uu - cam.cx) * cam.dx) ** 2 + ((vu - cam.cy) * cam.dy) ** 2
    rd2 = ru2.clone()
    for _ in range(3):
        dd = 1.0 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
        rd2 = ru2 / (dd * dd)
    dd = 1.0 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
    u0 = cam.cx + (uu - cam.cx) / dd
    v0 = cam.cy + (vu - cam.cy) / dd
    inview = ((u0 > -half) & (u0 < W + half) & (v0 > -half)
              & (v0 < H + half))
    idx = torch.nonzero(inview)[:, 0]
    out = torch.full((H * W,), base, dtype=torch.float64, device=X.device)
    if idx.numel():
        hb = half[idx]
        hm = int(hb.max())
        off = torch.arange(-hm, hm + 1, device=X.device)
        iu = u0[idx].to(torch.int64)          # int() truncates toward zero
        iv = v0[idx].to(torch.int64)
        uu_ = iu[:, None, None] + off[None, None, :]
        vv_ = iv[:, None, None] + off[None, :, None]
        ok = ((off[None, None, :].abs() <= hb[:, None, None])
              & (off[None, :, None].abs() <= hb[:, None, None])
              & (uu_ >= 0) & (uu_ < W) & (vv_ >= 0) & (vv_ < H))
        sel = torch.nonzero(ok, as_tuple=True)
        pix = vv_[sel[0], sel[1], 0] * W + uu_[sel[0], 0, sel[2]]
        k = idx[sel[0]]
        d2 = (wx[pix] - bx[k]) ** 2 + (wy[pix] - by[k]) ** 2
        val = amp[k] * torch.exp(-d2 / (2.0 * sig[k] ** 2))
        out += _pixel_sums(pix, val, H * W)
    return torch.clamp(out, 0.0, 255.0).reshape(H, W)


def _pixel_sums(pix: torch.Tensor, val: torch.Tensor,
                size: int) -> torch.Tensor:
    """``(size,)`` sums of ``val`` by pixel ``pix`` in a fixed order (no
    atomics, so one seed gives the same bits): a stable sort by pixel, a
    running sum, and its differences at the ends of the pixels' runs."""
    order = torch.argsort(pix, stable=True)
    p, cs = pix[order], torch.cumsum(val[order], 0)
    last = torch.ones_like(p, dtype=torch.bool)
    last[:-1] = p[1:] != p[:-1]
    ends = torch.nonzero(last)[:, 0]
    tot = cs[ends]
    seg = tot - torch.cat([tot.new_zeros(1), tot[:-1]])
    out = torch.zeros(size, dtype=val.dtype, device=val.device)
    out[p[ends]] = seg
    return out


def make_lap(traffic: dict, seed: int, cam: Camera, deep: float,
             count: int, device) -> Lap:
    """The mix's lap, rendered on ``device`` and brought to the host as
    uint8, with ``count`` rows of odometry from the seed's start."""
    import time

    t0 = time.perf_counter()
    n, step = int(traffic["lap"]["frames"]), float(traffic["lap"]["step_m"])
    blobs = make_blobs(int(traffic["world"]["seed"]), traffic["world"])
    _, xy, theta = lap_poses(n, step, n)
    frames = render(blobs, cam, deep, xy, theta, device)
    # through float32, as the port's renderer hands its frames over
    frames = torch.round(frames.to(torch.float32)).to(torch.uint8)
    frames = frames.cpu().numpy()
    raw = odometry(traffic, seed, count)
    gt_xy = xy - xy[start_frame(traffic, seed)]
    return Lap(frames=frames, raw=raw, gt_xy=gt_xy,
               render_s=time.perf_counter() - t0)
