"""PyTorch port: the plain versions of the two vision kernels.

On the CPU the port's wrappers compute the plain PyTorch versions
(``ncc_score_map_ref``, ``warp_bilinear_ref``); the CUDA kernels themselves
are held against these on the card by ``chip_smoke.py``. Here the plain
versions are held against the JAX package's Pallas kernels, run in
interpret mode as ``tests/test_pallas_vision.py`` runs them, and against
direct numpy oracles, on seeded inputs.

Tolerances: float32 inputs, 1e-4 absolute on NCC scores (in [-1, 1]) and on
warped values (up to 255, so ~1e-6 relative) — the two implementations sum
in different orders; float64 comparisons against the oracles use 1e-9.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_monoslam_tpu.ops.pallas_vision import ncc_score_map, warp_bilinear
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.frontend import matching
from cv_monoslam_tpu_torch.ops import vision

PM, W1, PI = 17, 21, 21
RG = W1 + PM - 1


def _ncc_direct(regions, patches, w1):
    """Direct zero-mean NCC (reference formula, SLAM.cpp:3141-3166)."""
    m, _, _ = regions.shape
    pm = patches.shape[-1]
    out = np.zeros((m, w1, w1))
    for k in range(m):
        pc = patches[k] - patches[k].mean()
        pn = np.sqrt((pc * pc).sum())
        for dy in range(w1):
            for dx in range(w1):
                w = regions[k, dy:dy + pm, dx:dx + pm]
                wc = w - w.mean()
                den = np.sqrt((wc * wc).sum()) * pn
                out[k, dy, dx] = (wc * pc).sum() / den if den > 0 else 0.0
    return out


def _ncc_inputs(m, seed):
    rng = np.random.default_rng(seed)
    regions = rng.integers(0, 256, (m, RG, RG)).astype(np.float32)
    patches = rng.integers(0, 256, (m, PM, PM)).astype(np.float32)
    regions[0, 3:3 + PM, 4:4 + PM] = patches[0]      # planted exact match
    regions[1] = 7.0                                  # flat windows
    patches[2] = 42.0                                 # flat template
    return regions, patches


def test_ncc_plain_matches_pallas_interpret_m37():
    """M = 37: not a multiple of any block size (the Pallas wrapper pads
    to its 128-lane block)."""
    regions, patches = _ncc_inputs(37, 0)
    got = vision.ncc_score_map_ref(torch.as_tensor(regions),
                                   torch.as_tensor(patches), pm=PM, w1=W1)
    want = np.asarray(ncc_score_map(jnp.asarray(regions),
                                    jnp.asarray(patches), pm=PM, w1=W1))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert float(got[0, 3, 4]) > 0.999
    assert float(got[2].abs().max()) == 0.0          # flat template
    assert float(got[1].abs().max()) < 5e-3          # flat window (roundoff)


@pytest.mark.parametrize("m", [32, 130])
def test_ncc_plain_matches_pallas_interpret(m):
    """M = 32 (config 1) and M = 130, which crosses the Pallas wrapper's
    128-lane block into a second, padded one."""
    regions, patches = _ncc_inputs(m, 10 + m)
    got = vision.ncc_score_map_ref(torch.as_tensor(regions),
                                   torch.as_tensor(patches), pm=PM, w1=W1)
    want = np.asarray(ncc_score_map(jnp.asarray(regions),
                                    jnp.asarray(patches), pm=PM, w1=W1))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert float(got[0, 3, 4]) > 0.999
    assert float(got[2].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["uint8", "low_texture", "uniform"])
def test_normalized_templates_match_jax_wrapper_arithmetic(kind):
    """The plain normalization against the arithmetic of the JAX wrapper
    (pallas_vision.py: mean, centre, norm, guarded divide) in numpy
    float32, 1e-6 absolute; the second centring leaves |sum(p_hat)| per
    template at float32 roundoff (<= 1e-5)."""
    rng = np.random.default_rng(20)
    if kind == "uint8":
        patches = rng.integers(0, 256, (40, PM, PM)).astype(np.float32)
    elif kind == "low_texture":
        patches = (100 + rng.integers(-2, 3, (40, PM, PM))).astype(np.float32)
    else:
        patches = rng.uniform(0, 255, (40, PM, PM)).astype(np.float32)
    patches[3] = 42.0                                 # flat template
    pflat = patches.reshape(40, PM * PM)
    pc = pflat - pflat.mean(axis=1, keepdims=True, dtype=np.float32)
    pn = np.sqrt((pc * pc).sum(axis=1, keepdims=True, dtype=np.float32))
    want = np.where(pn > 0, pc / np.where(pn == 0, 1.0, pn), 0.0)
    got = vision.normalized_templates(torch.as_tensor(patches)).numpy()
    np.testing.assert_allclose(got.reshape(40, -1), want, rtol=0, atol=1e-6)
    assert np.abs(got.reshape(40, -1).sum(axis=1, dtype=np.float64)).max() \
        <= 1e-5
    assert np.abs(got[3]).max() == 0.0
    norms = np.sqrt((got.astype(np.float64) ** 2).sum(axis=(1, 2)))
    np.testing.assert_allclose(np.delete(norms, 3), 1.0, rtol=0, atol=1e-6)


def test_ncc_with_templates_on_cpu_is_plain_pair_and_launches_nothing(
        monkeypatch):
    regions, patches = _ncc_inputs(6, 5)
    r, p = torch.as_tensor(regions), torch.as_tensor(patches)
    launched = []
    monkeypatch.setattr(vision, "_launch", lambda *a, **k: launched.append(a))
    scores, p_hat = vision.ncc_score_map_with_templates(r, p, pm=PM, w1=W1)
    assert launched == []
    torch.testing.assert_close(
        scores, vision.ncc_score_map_ref(r, p, pm=PM, w1=W1), rtol=0, atol=0)
    torch.testing.assert_close(p_hat, vision.normalized_templates(p),
                               rtol=0, atol=0)
    assert p_hat.shape == (6, PM, PM) and scores.shape == (6, W1, W1)
    with pytest.raises(ValueError):
        vision.ncc_score_map_with_templates(r, p[:, :-1], pm=PM, w1=W1)


@pytest.mark.parametrize("m,pm,w1,want", [
    # every configuration's shape: 37 region rows x 3 strips = 111
    # column-sum tasks -> four warps
    (32, 17, 21, dict(compiled=True, threads=128)),
    (576, 17, 21, dict(compiled=True, threads=128)),
    # any other shape: run-time bounds of the same kernel
    (37, 9, 13, dict(compiled=False, threads=64)),
    (37, 17, 13, dict(compiled=False, threads=64)),
    (37, 9, 21, dict(compiled=False, threads=96)),
    (4, 3, 5, dict(compiled=False, threads=32)),
])
def test_ncc_launch_plan(m, pm, w1, want):
    plan = vision.ncc_launch_plan(m, pm, w1)
    assert plan == dict(want, smem_bytes=plan["smem_bytes"])
    # the layout of vision_kernels.cu: normalized template with rows padded
    # to 16 bytes, float2 column sums and window sums, odd-pitch region
    # rows, raw template
    strips = -(-w1 // vision.NCC_STRIP)
    rg = w1 + pm - 1
    csw = strips * vision.NCC_STRIP
    tp = -(-pm // 4) * 4
    pitch = (csw + tp - 1) | 1
    assert pitch % 2 == 1 and pitch >= rg
    assert plan["smem_bytes"] == 4 * (pm * tp + 2 * rg * csw + 2 * w1 * csw
                                      + rg * pitch + pm * pm)
    assert (pm * tp) % 4 == 0                         # float2 arrays aligned
    assert plan["threads"] % 32 == 0
    assert plan["threads"] >= rg * strips >= w1 * strips


def test_ncc_launch_plan_limits():
    with pytest.raises(ValueError):                   # > 48 KB shared memory
        vision.ncc_launch_plan(576, 41, 61)
    with pytest.raises(ValueError):
        vision.ncc_launch_plan(0, 17, 21)
    # the widest search that fits stays within 1024 threads per block
    wide = vision.ncc_launch_plan(576, 3, 41)
    assert wide["threads"] <= 1024
    assert wide["smem_bytes"] <= vision.NCC_SMEM_LIMIT


def test_ncc_plain_matches_direct_oracle_f64():
    regions, patches = _ncc_inputs(4, 1)
    f64 = torch.float64
    got = vision.ncc_score_map_ref(torch.as_tensor(regions, dtype=f64),
                                   torch.as_tensor(patches, dtype=f64),
                                   pm=PM, w1=W1)
    want = _ncc_direct(regions.astype(np.float64),
                       patches.astype(np.float64), W1)
    # the flat window's variance is exactly 0 in the oracle but a roundoff
    # residue in the running sums: compare it separately
    np.testing.assert_allclose(got.numpy()[[0, 2, 3]], want[[0, 2, 3]],
                               rtol=0, atol=1e-9)
    assert float(got[1].abs().max()) < 1e-6


def test_ncc_wrapper_on_cpu_uses_plain_version(monkeypatch):
    regions, patches = _ncc_inputs(5, 2)
    r, p = torch.as_tensor(regions), torch.as_tensor(patches)
    launched = []
    monkeypatch.setattr(vision, "_launch", lambda *a, **k: launched.append(a))
    got = vision.ncc_score_map(r, p, pm=PM, w1=W1)
    assert launched == []                             # no kernel launch
    torch.testing.assert_close(
        got, vision.ncc_score_map_ref(r, p, pm=PM, w1=W1), rtol=0, atol=0)
    with pytest.raises(ValueError):
        vision.ncc_score_map(r[:, 1:], p, pm=PM, w1=W1)


def test_ncc_scores_uint8_frame_equals_float32_frame():
    """uint8-transported frames are cast on the device before the region
    gather: scores must equal those from a float32 frame (the JAX
    package's r5 regression, matching.py:158-165)."""
    rng = np.random.default_rng(7)
    img_u8 = rng.integers(0, 256, (120, 160), dtype=np.uint8)
    m = 24
    cfg = SlamConfig()
    hp = cfg.hp_match
    centers = np.stack([rng.integers(30, 130, m),
                        rng.integers(30, 90, m)], axis=1).astype(np.int32)
    patches = torch.as_tensor(np.stack([
        img_u8[v - hp:v + hp + 1, u - hp:u + hp + 1].astype(np.float32)
        for u, v in centers]))
    c = torch.as_tensor(centers)
    for backend in ("xla", "pallas"):
        cfg2 = dataclasses.replace(cfg, vision_backend=backend)
        s_u8, _ = matching.ncc_scores(
            torch.as_tensor(img_u8).to(torch.float32), c, patches, cfg2)
        s_f32, _ = matching.ncc_scores(
            torch.as_tensor(img_u8.astype(np.float32)), c, patches, cfg2)
        torch.testing.assert_close(s_u8, s_f32, rtol=0, atol=0)
        best = s_u8.reshape(m, -1).max(dim=1).values
        assert bool((best > 0.95).all()), backend


def _bilinear_direct(patches, su, sv):
    m, pi, _ = patches.shape
    out = np.zeros_like(su)
    for k in range(m):
        for idx in np.ndindex(su.shape[1:]):
            u, v = su[(k,) + idx], sv[(k,) + idx]
            u0, v0 = int(np.floor(u)), int(np.floor(v))
            if u0 < 0 or v0 < 0 or u0 + 1 > pi - 1 or v0 + 1 > pi - 1:
                continue
            du, dv = u - u0, v - v0
            p = patches[k]
            out[(k,) + idx] = (p[v0, u0] * (1 - du) * (1 - dv)
                               + p[v0, u0 + 1] * du * (1 - dv)
                               + p[v0 + 1, u0] * (1 - du) * dv
                               + p[v0 + 1, u0 + 1] * du * dv)
    return out


def _warp_inputs(m, seed):
    rng = np.random.default_rng(seed)
    patches = rng.integers(0, 256, (m, PI, PI)).astype(np.float32)
    d = np.arange(-(PM // 2), PM // 2 + 1, dtype=np.float64)
    dv, du = np.meshgrid(d, d, indexing="ij")
    a = np.eye(2)[None] + rng.normal(0, 0.15, (m, 2, 2))
    a[::5] *= 1.4                                     # some out of bounds
    sv = PI // 2 + a[:, 0, 0, None, None] * dv + a[:, 0, 1, None, None] * du
    su = PI // 2 + a[:, 1, 0, None, None] * dv + a[:, 1, 1, None, None] * du
    return patches, su.astype(np.float32), sv.astype(np.float32)


def test_warp_plain_matches_pallas_interpret_and_oracle():
    patches, su, sv = _warp_inputs(37, 3)
    got = vision.warp_bilinear_ref(torch.as_tensor(patches),
                                   torch.as_tensor(su), torch.as_tensor(sv))
    want = np.asarray(warp_bilinear(jnp.asarray(patches), jnp.asarray(su),
                                    jnp.asarray(sv)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    direct = _bilinear_direct(patches.astype(np.float64),
                              su.astype(np.float64), sv.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), direct, rtol=0, atol=1e-4)
    assert (got.numpy() == 0).sum() > 0               # invalid samples


def test_warp_identity_zeroes_last_row_and_column():
    rng = np.random.default_rng(4)
    pi = 9
    patches = torch.as_tensor(rng.uniform(0, 255, (1, pi, pi)))
    g = torch.arange(pi, dtype=torch.float64)
    sv, su = torch.meshgrid(g, g, indexing="ij")
    got = vision.warp_bilinear(patches, su[None], sv[None])
    torch.testing.assert_close(got[0, :-1, :-1], patches[0, :-1, :-1],
                               rtol=0, atol=1e-9)
    assert float(got[0, -1].abs().max()) == 0.0
    assert float(got[0, :, -1].abs().max()) == 0.0


@pytest.mark.parametrize("avoid", [False, True])
def test_detect_corners_matches_jax(avoid):
    """The whole detection pipeline on a fixture frame, float64: the same
    corners, the same validity mask, responses (up to ~5) to 2e-3: both
    packages compute the map in float32, XLA's convolution and the port's
    shifted sums in different orders, and the min eigenvalue is a small
    difference of the structure tensor's much larger terms (XLA's CPU
    convolution does not round alike from run to run: up to 8e-4 seen); with
    landmark pixels to avoid (one of them zeroed, the isThereNoZero quirk
    on) and an escalated raw cap."""
    from cv_monoslam_tpu.config import SlamConfig as JaxConfig
    from cv_monoslam_tpu.frontend import detect as jdet
    from cv_monoslam_tpu_torch.frontend import detect as tdet
    from cv_monoslam_tpu_torch.io import fixtures as tfix

    kw = dict(max_landmarks=8, max_detections=48, dtype="float64",
              detect_zero_blocks=avoid)
    cfg, jcfg = SlamConfig(**kw), JaxConfig(**kw)
    frame = tfix.load("bench1_arc")[0].get(5).astype(np.float64)
    args, jargs = (), ()
    extra = dict(n_matched=0, n_map=2, n_loop=0, base_raws=4)
    if avoid:
        rng = np.random.default_rng(7)
        pts = rng.uniform([40, 40], [600, 440], (8, 2))
        pts[3] = 0.0
        ok = np.arange(8) < 6
        args = (torch.as_tensor(pts), torch.as_tensor(ok))
        jargs = (jnp.asarray(pts), jnp.asarray(ok))
        extra["n_matched"] = 3
    pix, valid, resp = tdet.detect_corners(torch.as_tensor(frame), cfg,
                                           *args, **extra)
    jpix, jvalid, jresp = jdet.detect_corners(jnp.asarray(frame), jcfg,
                                              *jargs, **extra)
    np.testing.assert_array_equal(pix.numpy(), np.asarray(jpix))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(resp.numpy(), np.asarray(jresp), rtol=0,
                               atol=2e-3)
    assert int(valid.sum()) == (0 if avoid else 3)
