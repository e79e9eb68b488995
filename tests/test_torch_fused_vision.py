"""PyTorch port: the fused warp + region + NCC step of data association.

On the kernel route the matcher makes one call, ``vision.warp_ncc_score_map``
(one CUDA launch on the card), where it made two before: ``warp_patches``
then ``ncc_scores``. On the CPU the wrapper computes the plain version,
``warp_ncc_score_map_ref``, which is the old composition of plain versions
in the old order. Here that plain version is held against the JAX package's
chain (``warp_patches`` then ``ncc_scores`` with ``vision_backend="pallas"``,
its two Pallas kernels in interpret mode, as ``tests/test_pallas_vision.py``
runs them) on seeded numpy inputs; against the port's own two-step
composition bit for bit; and the wrapper's launch plan and type checks,
which the CUDA branch takes, are tested without a card.

Tolerances: float64, 1e-9 on scores and warped templates (the two packages
sum in different orders). float32: 1e-4 on NCC scores (in [-1, 1]); warped
templates 4 ulp of 255, 6.1e-5 (the Pallas warp contracts one-hot weight
matrices, so it associates the four taps otherwise than the port's
left-to-right sum; seen: 3.05e-5, 2 ulp of values in [128, 256), which an
absolute 1e-5 would be below).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.filter import state as jstate
from cv_monoslam_tpu.frontend import matching as jmatching
from cv_monoslam_tpu_torch.api import SlamSession
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.filter.state import init_state, replace
from cv_monoslam_tpu_torch.frontend import matching
from cv_monoslam_tpu_torch.io import fixtures
from cv_monoslam_tpu_torch.ops import vision

HP_INIT, HP_MATCH = 10, 8
PM, W1, PI = 17, 21, 21
RG = W1 + PM - 1
H, W = 96, 128


def _inputs(m, seed):
    """A uint8-valued frame, window centres (the first four past the
    frame's corners, so their regions clamp to the corners), init patches
    and warps: near-identity (every fifth scaled out past the patch
    border), then at 4-8 identity, a scale that puts the last sample row
    and column on the patch edge, a large shear, and inf / NaN entries as
    a singular J10 gives them."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (H, W)).astype(np.float64)
    centers = np.stack([rng.integers(-10, W + 10, m),
                        rng.integers(-10, H + 10, m)], axis=1)
    centers[:4] = [[-30, -30], [W + 30, -30], [-30, H + 30], [W + 30, H + 30]]
    patches = rng.integers(0, 256, (m, PI, PI)).astype(np.float64)
    a = np.eye(2)[None] + rng.normal(0, 0.15, (m, 2, 2))
    a[::5] *= 1.4
    a[4] = np.eye(2)
    a[5] = (HP_INIT / HP_MATCH) * np.eye(2)
    a[6] = [[2.0, 0.8], [-0.7, 1.9]]
    a[7] = [[np.inf, -np.inf], [-np.inf, np.inf]]
    a[8] = np.nan
    return image, centers.astype(np.int32), patches, a


def _jax_chain(image, centers, patches, a, dtype, monkeypatch):
    """The JAX engine's data-association chain on these inputs: its
    ``warp_patches`` (with ``warp_matrices`` returning ``a``) and its
    ``ncc_scores``, both through the Pallas kernels in interpret mode."""
    m = len(patches)
    jcfg = JaxConfig(max_landmarks=m, dtype=dtype, vision_backend="pallas")
    st = jstate.init_state(jcfg)
    st = jstate.replace(st, lm=jstate.replace(
        st.lm, init_patch=jnp.asarray(patches, jnp.float32)))
    monkeypatch.setattr(jmatching, "warp_matrices",
                        lambda s, c: jnp.asarray(a, dtype))
    warped = jmatching.warp_patches(st, jcfg)
    scores, base = jmatching.ncc_scores(jnp.asarray(image, dtype),
                                        jnp.asarray(centers), warped, jcfg)
    return np.asarray(scores), np.asarray(warped), np.asarray(base)


def _port(image, centers, patches, a, dtype):
    t = getattr(torch, dtype)
    cfg = SlamConfig(dtype=dtype)
    base = matching.region_origins(torch.as_tensor(centers), H, W, cfg)
    scores, warped = vision.warp_ncc_score_map_ref(
        torch.as_tensor(image, dtype=t), base, torch.as_tensor(a, dtype=t),
        torch.as_tensor(patches, dtype=torch.float32).to(t),
        hp_init=HP_INIT, hp_match=HP_MATCH)
    return scores.numpy(), warped.numpy(), base.numpy()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("m", [32, 130])
def test_fused_plain_matches_jax_chain(m, dtype, monkeypatch):
    """M = 32 (config 1) and M = 130 (past the Pallas NCC's 128-lane
    block); clamped corner regions, out-of-patch samples, a singular warp.

    The singular warps (rows 7 and 8): the port drops a sample at a NaN
    coordinate (0, as its kernels do), while both of the JAX package's
    warps give NaN samples there (the Pallas one multiplies NaN weights by
    its one-hot zeros; the plain one casts NaN to an index). Its NCC maps a
    NaN template to scores 0, as the port's maps a flat one, so the scores
    agree on every row, and only those warped templates differ."""
    image, centers, patches, a = _inputs(m, 30 + m)
    want_s, want_w, want_b = _jax_chain(image, centers, patches, a, dtype,
                                        monkeypatch)
    got_s, got_w, got_b = _port(image, centers, patches, a, dtype)
    np.testing.assert_array_equal(got_b, want_b)
    assert np.isnan(want_w[7:9]).any() and np.abs(got_w[7:9]).max() == 0
    assert np.abs(got_s[7:9]).max() == 0 and np.abs(want_s[7:9]).max() == 0
    keep = np.r_[0:7, 9:m]
    got_w, want_w = got_w[keep], want_w[keep]
    assert got_b[:4].tolist() == [[0, 0], [W - RG, 0], [0, H - RG],
                                  [W - RG, H - RG]]
    if dtype == "float64":
        np.testing.assert_allclose(got_w, want_w, rtol=0, atol=1e-9)
        np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-9)
    else:
        np.testing.assert_allclose(got_w, want_w, rtol=0,
                                   atol=4 * np.spacing(np.float32(255)))
        np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)
    o = HP_INIT - HP_MATCH
    np.testing.assert_array_equal(got_w[4], patches[4, o:o + PM, o:o + PM])
    assert np.abs(got_w[5, -1]).max() == 0
    assert np.abs(got_w[5, :, -1]).max() == 0
    assert (got_w[6] == 0).sum() > PM * PM // 2          # outside the patch
    assert np.isfinite(got_s).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_plain_equals_two_step_composition(dtype, monkeypatch):
    """Bit for bit the port's ``warp_patches`` then ``ncc_scores`` on the
    same state: the CPU path of every session is unchanged."""
    image, centers, patches, a = _inputs(24, 5)
    t = getattr(torch, dtype)
    cfg = SlamConfig(max_landmarks=24, dtype=dtype, vision_backend="pallas")
    st = init_state(cfg, device="cpu")
    st = replace(st, lm=replace(st.lm, init_patch=torch.as_tensor(
        patches, dtype=torch.float32)))
    A = torch.as_tensor(a, dtype=t)
    monkeypatch.setattr(matching, "warp_matrices", lambda s, c: A)
    img = torch.as_tensor(image, dtype=t)
    c = torch.as_tensor(centers)
    warped = matching.warp_patches(st, cfg)
    scores, base = matching.ncc_scores(img, c, warped, cfg)
    got_s, got_w = vision.warp_ncc_score_map(
        img, base, A, st.lm.init_patch.to(t), hp_init=HP_INIT,
        hp_match=HP_MATCH)
    assert torch.equal(got_w, warped) and torch.equal(got_s, scores)


def test_association_rows_kernel_route_equals_two_step_route():
    """``association_rows`` on a config-1 state after 6 frames: the kernel
    route (the fused wrapper; its plain version on the CPU) and the "xla"
    route give the same accepted set, match pixels and warped patches, bit
    for bit, and the patches are those of the two-step ``warp_patches``
    that the matcher called before the fusion."""
    seq, track, _, _ = fixtures.load("bench1_arc")
    cfg = SlamConfig(max_landmarks=32, max_new_per_frame=8,
                     max_detections=48, vision_backend="pallas")
    xla = dataclasses.replace(cfg, vision_backend="xla")
    sess = SlamSession(cfg, seq, track, device="cpu")
    sess.run(n_frames=6, chunk=3)
    image = sess._to_device(sess._prep_image(seq.get(int(track.frame_id[7]))))
    fused = matching.association_rows(sess.state, image, cfg)
    two = matching.association_rows(sess.state, image, xla)
    assert int(fused[0].sum()) >= 4
    for f, t in zip(fused, two):
        assert torch.equal(f, t)
    assert torch.equal(fused[2], matching.warp_patches(sess.state, xla))


def test_fused_uint8_frame_equals_float32_frame():
    """A frame through the session's transport (uint8 across, cast on the
    device) gives the fused step the scores and templates of the same
    frame made as float32; each template planted from it is found."""
    seq, track, _, _ = fixtures.load("bench1_arc")
    sess = SlamSession(SlamConfig(max_landmarks=8, max_detections=16,
                                  max_new_per_frame=4), seq, track,
                       device="cpu")
    frame = seq.get(int(track.frame_id[3]))
    host = sess._prep_image(frame)
    assert sess._img_u8 and host.dtype == np.uint8
    img_u8 = sess._to_device(host)
    img_f32 = torch.as_tensor(np.asarray(frame, dtype=np.float32))
    assert img_u8.dtype == torch.float32
    fh, fw = img_f32.shape
    rng = np.random.default_rng(7)
    m = 12
    cand = np.stack([rng.integers(30, fw - 30, 400),
                     rng.integers(30, fh - 30, 400)], axis=1)
    # textured windows only: a flat template scores 0 everywhere
    centers = np.array([(u, v) for u, v in cand if frame[
        v - HP_MATCH:v + HP_MATCH + 1, u - HP_MATCH:u + HP_MATCH + 1
    ].std() > 5][:m])
    assert len(centers) == m
    o = HP_INIT - HP_MATCH
    # init patches cut from the frame around each centre: with an identity
    # warp the template is the frame's own window there
    patches = torch.stack([
        img_f32[v - HP_INIT:v + HP_INIT + 1, u - HP_INIT:u + HP_INIT + 1]
        for u, v in centers]).contiguous()
    A = torch.eye(2).repeat(m, 1, 1)
    base = matching.region_origins(torch.as_tensor(centers, dtype=torch.int32),
                                   fh, fw, SlamConfig())
    s_u8, w_u8 = vision.warp_ncc_score_map(
        img_u8, base, A, patches, hp_init=HP_INIT, hp_match=HP_MATCH)
    s_f32, w_f32 = vision.warp_ncc_score_map(
        img_f32, base, A, patches, hp_init=HP_INIT, hp_match=HP_MATCH)
    assert torch.equal(s_u8, s_f32) and torch.equal(w_u8, w_f32)
    assert torch.equal(w_u8, patches[:, o:o + PM, o:o + PM])
    assert bool((s_u8.reshape(m, -1).max(dim=1).values > 0.999).all())


@pytest.mark.parametrize("m,pm,w1,pi,want", [
    # every configuration's shape: the NCC kernel's 128 threads
    (32, 17, 21, 21, dict(compiled=True, threads=128)),
    (576, 17, 21, 21, dict(compiled=True, threads=128)),
    # hp_match = 4, hp_init = 6, and any shape other than (17, 21, 21):
    # the run-time bounds of the same kernel
    (37, 9, 13, 13, dict(compiled=False, threads=64)),
    (37, 17, 21, 13, dict(compiled=False, threads=128)),
])
def test_warp_ncc_launch_plan(m, pm, w1, pi, want):
    plan = vision.warp_ncc_launch_plan(m, pm, w1, pi)
    assert plan == dict(want, smem_bytes=plan["smem_bytes"])
    ncc = vision.ncc_launch_plan(m, pm, w1)
    # the NCC kernel's layout, then the init patch
    assert plan["smem_bytes"] == ncc["smem_bytes"] + 4 * pi * pi
    assert plan["threads"] == ncc["threads"]
    if (pm, w1, pi) == (17, 21, 21):
        assert plan["smem_bytes"] == 18328 + 1764


def test_warp_ncc_launch_plan_limits():
    # the NCC layout alone fits; with a (45, 45) init patch it does not
    assert vision.ncc_launch_plan(4, 9, 41)["smem_bytes"] \
        <= vision.NCC_SMEM_LIMIT
    assert vision.warp_ncc_launch_plan(4, 9, 41, 41)["smem_bytes"] \
        <= vision.NCC_SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        vision.warp_ncc_launch_plan(4, 9, 41, 45)
    with pytest.raises(ValueError):                   # NCC layout too large
        vision.warp_ncc_launch_plan(4, 41, 61, 21)
    with pytest.raises(ValueError):
        vision.warp_ncc_launch_plan(0, 17, 21, 21)
    with pytest.raises(ValueError):
        vision.warp_ncc_launch_plan(4, 17, 21, 1)


def _small(m=5, seed=2):
    image, centers, patches, a = _inputs(max(m, 9), seed)
    base = matching.region_origins(torch.as_tensor(centers), H, W,
                                   SlamConfig())
    return (torch.as_tensor(image, dtype=torch.float32), base,
            torch.as_tensor(a, dtype=torch.float32),
            torch.as_tensor(patches, dtype=torch.float32))


def test_fused_wrapper_on_cpu_is_plain_version_and_launches_nothing(
        monkeypatch):
    args = _small()
    hp = dict(hp_init=HP_INIT, hp_match=HP_MATCH)
    launched = []
    monkeypatch.setattr(vision, "_launch", lambda *a, **k: launched.append(a))
    scores, warped = vision.warp_ncc_score_map(*args, **hp)
    s2, w2, p_hat = vision.warp_ncc_score_map_with_templates(*args, **hp)
    assert launched == []
    want_s, want_w = vision.warp_ncc_score_map_ref(*args, **hp)
    for got, want in ((scores, want_s), (warped, want_w), (s2, want_s),
                      (w2, want_w),
                      (p_hat, vision.normalized_templates(want_w))):
        assert torch.equal(got, want)
    assert scores.shape == (9, W1, W1) and warped.shape == (9, PM, PM)


def test_fused_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks the CUDA branch makes before it launches, called directly
    (no card here): float32 frame, warps and patches, int32 origins, all
    contiguous; and the shapes, which every branch checks."""
    image, base, a, patches = _small()
    check = vision._warp_ncc_check_types
    check(image, base, a, patches)                    # what the kernel takes
    with pytest.raises(TypeError, match="float32"):
        check(image.double(), base, a, patches)
    with pytest.raises(TypeError, match="float32"):
        check(image, base, a, patches.double())
    with pytest.raises(TypeError, match="int32"):
        check(image, base.long(), a, patches)
    with pytest.raises(ValueError, match="contiguous"):
        check(image.t().contiguous().t(), base, a, patches)
    with pytest.raises(ValueError, match="contiguous"):
        check(image, base.t().contiguous().t(), a, patches)
    with pytest.raises(ValueError, match="contiguous"):
        check(image, base, a.transpose(1, 2), patches)
    with pytest.raises(TypeError, match="float32"):
        check(image, base, a, patches, torch.empty(9, W1, W1,
                                                   dtype=torch.float64))
    hp = dict(hp_init=HP_INIT, hp_match=HP_MATCH)
    with pytest.raises(ValueError, match="shapes"):
        vision.warp_ncc_score_map(image, base[:-1], a, patches, **hp)
    with pytest.raises(ValueError, match="shapes"):
        vision.warp_ncc_score_map(image, base, a[:, :1], patches, **hp)
    with pytest.raises(ValueError, match="shapes"):
        vision.warp_ncc_score_map(image[:RG - 1], base, a, patches, **hp)
    with pytest.raises(ValueError, match="shapes"):
        vision.warp_ncc_score_map(image, base, a, patches[:, :, :-1], **hp)
