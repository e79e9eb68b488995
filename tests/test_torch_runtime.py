"""PyTorch port: checkpoint / resume, watchdog recovery, recorder, timers,
viz, synthetic sequences, video and the command line.

The cases of the JAX package's ``tests/test_runtime.py`` (checkpoint round
trip, watchdog detects and recovers), plus what the port's docstrings
promise: every leaf round-trips exactly, a resumed session continues bit for
bit, and the two packages' checkpoint files are interchangeable (each loads
what the other saved, leaf for leaf). Everything here is exact: a
checkpoint stores arrays, it computes nothing.

The app shell is held against the JAX package's the same way: the recorder's
three files are byte-equal for the same calls, the synthetic renderer and the
AVI writer give the same bytes, a sequence cached by one package loads in the
other, ``landmark_display_info`` agrees to 1e-9 (float64), and
``python -m cv_monoslam_tpu_torch`` runs end to end on the CPU without ever
loading ``jax``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.filter import state as jstate
from cv_monoslam_tpu.utils import checkpoint as jckpt
from cv_monoslam_tpu_torch.api import SlamSession
from cv_monoslam_tpu_torch.config import CameraConfig, SlamConfig
from cv_monoslam_tpu_torch.convert import state_from_arrays, state_to_arrays
from cv_monoslam_tpu_torch.filter.state import init_state, replace
from cv_monoslam_tpu_torch.io import fixtures as tfix
from cv_monoslam_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                    load_checkpoint,
                                                    save_checkpoint)
from cv_monoslam_tpu_torch.utils.watchdog import (HealthReport, Watchdog,
                                                  health_check)

CFG = SlamConfig(max_landmarks=4, dtype="float64",
                 camera=CameraConfig(width=128, height=96, cx=64.0, cy=48.0))
KW = dict(max_landmarks=32, max_new_per_frame=8, max_detections=48,
          dtype="float64")


def _random_state(cfg, seed=0):
    """A state whose every leaf holds seeded random values of its dtype, so
    a permuted or dropped leaf cannot round-trip by accident."""
    rng = np.random.default_rng(seed)
    arrays = state_to_arrays(init_state(cfg, device="cpu"))
    for k, v in arrays.items():
        if v.dtype == bool:
            arrays[k] = rng.random(v.shape) < 0.5
        elif np.issubdtype(v.dtype, np.integer):
            arrays[k] = rng.integers(0, 1000, v.shape).astype(v.dtype)
        else:
            arrays[k] = rng.normal(size=v.shape).astype(v.dtype)
    return arrays


def _assert_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_checkpoint_roundtrip_is_exact_for_every_leaf(tmp_path):
    arrays = _random_state(CFG)
    state = state_from_arrays(arrays, device="cpu")
    p = str(tmp_path / "ck" / "ckpt_000010.npz")
    save_checkpoint(p, state, 10, CFG, extra={"note": "x"})
    s2, counter, cfg2, extra = load_checkpoint(p, device="cpu")
    assert counter == 10 and cfg2 == CFG and extra == {"note": "x"}
    _assert_equal(state_to_arrays(s2), arrays)
    assert s2.x.device.type == "cpu"
    assert latest_checkpoint(str(tmp_path / "ck")) == p
    assert not (tmp_path / "ck" / "ckpt_000010.npz.tmp").exists()


def test_latest_checkpoint_picks_highest_counter(tmp_path):
    assert latest_checkpoint(str(tmp_path / "none")) is None
    state = init_state(CFG, device="cpu")
    for n in (5, 120, 40):
        save_checkpoint(str(tmp_path / f"ckpt_{n:06d}.npz"), state, n, CFG)
    (tmp_path / "ckpt_bad.npz").write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == \
        str(tmp_path / "ckpt_000120.npz")


def test_load_checkpoint_without_device_raises_on_cpu_only_host(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, init_state(CFG, device="cpu"), 1, CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(p)


def test_load_checkpoint_rejects_a_foreign_leaf(tmp_path):
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, init_state(CFG, device="cpu"), 1, CFG)
    with np.load(p) as z:
        payload = {k: z[k] for k in z.files}
    payload["leaf_0"] = payload["leaf_0"].astype(np.float32)
    np.savez(p, **payload)
    with pytest.raises(ValueError, match="leaf x"):
        load_checkpoint(p, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_files_interchange_with_the_jax_package(tmp_path, writer):
    """Same leaf order, same keys, same config JSON: a file written by
    either package loads in the other with every leaf in its own field."""
    jcfg = JaxConfig(max_landmarks=4, dtype="float64")
    tcfg = SlamConfig(max_landmarks=4, dtype="float64")
    arrays = _random_state(tcfg, seed=3)
    p = str(tmp_path / "ckpt_000007.npz")
    if writer == "jax":
        import jax
        import jax.numpy as jnp

        template = jstate.init_state(jcfg)
        leaves = [jnp.asarray(v) for v in arrays.values()]
        jstate_ = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(template), leaves)
        assert np.array_equal(np.asarray(jstate_.stored.sr),
                              arrays["stored.sr"])
        jckpt.save_checkpoint(p, jstate_, 7, jcfg)
        got, counter, cfg2, _ = load_checkpoint(p, device="cpu")
        assert cfg2 == tcfg
        _assert_equal(state_to_arrays(got), arrays)
    else:
        save_checkpoint(p, state_from_arrays(arrays, device="cpu"), 7, tcfg)
        got, counter, cfg2, _ = jckpt.load_checkpoint(p)
        assert cfg2 == jcfg
        _assert_equal(state_to_arrays(got), arrays)
    assert counter == 7


def test_session_checkpoints_and_resume_continues_bit_for_bit(tmp_path):
    seq, track, _, _ = tfix.load("bench1_arc")
    cfg = SlamConfig(**KW)
    ck = str(tmp_path / "ck")
    a = SlamSession(cfg, seq, track, device="cpu", checkpoint_dir=ck,
                    checkpoint_every=4)
    a.run(n_frames=8, chunk=4)
    # frames 4 and 8 were checkpointed at the end of their chunks
    assert latest_checkpoint(ck) == a.save_checkpoint()
    b = SlamSession.resume(latest_checkpoint(ck), seq, track, device="cpu")
    assert b.counter == a.counter == 9 and b.cfg == cfg
    _assert_equal(state_to_arrays(b.state), state_to_arrays(a.state))
    a.run(n_frames=4, chunk=4)
    b.run(n_frames=4, chunk=4)
    _assert_equal(state_to_arrays(b.state), state_to_arrays(a.state))
    np.testing.assert_array_equal(b.trajectory, a.trajectory[8:])
    assert [r.frame for r in b.records] == [9, 10, 11, 12]


def test_watchdog_detects_and_recovers():
    state = init_state(CFG, device="cpu")
    assert bool(health_check(state, CFG).all())

    bad_x = state.x.clone()
    bad_x[0] = float("nan")
    bad = replace(state, x=bad_x)
    wd = Watchdog(CFG, check_every=1)
    report = wd.check(bad)
    assert not report.ok and not report.finite
    assert wd.n_checks == 1 and wd.n_failures == 1

    recovered = wd.recover(bad, theta_odo=0.7)
    assert bool(torch.isfinite(recovered.x).all())
    assert float(recovered.x[-1]) == 0.7
    assert not bool(recovered.lm.active.any())


def test_watchdog_recover_keeps_only_finite_stored_records():
    arrays = _random_state(CFG, seed=1)
    arrays["stored.valid"][:] = True
    arrays["stored.valid"][5] = False
    arrays["stored.state"][2, 3] = np.inf          # poisoned records
    arrays["stored.sr"][7, 1, 1] = np.nan
    arrays["x"][0] = np.nan
    bad = state_from_arrays(arrays, device="cpu")
    got = Watchdog(CFG).recover(bad, theta_odo=-0.2)
    keep = np.ones(64, bool)
    keep[[2, 5, 7]] = False
    np.testing.assert_array_equal(got.stored.valid.numpy(), keep)
    np.testing.assert_array_equal(got.stored.sr.numpy()[keep],
                                  arrays["stored.sr"][keep])
    assert int(got.next_id) == int(arrays["next_id"])
    assert int(got.frame) == int(arrays["frame"])
    assert bool(health_check(got, CFG).all())


def test_watchdog_restore_fn_and_flags():
    sentinel = init_state(CFG, theta0=0.1, device="cpu")
    wd = Watchdog(CFG, check_every=5, restore_fn=lambda: sentinel)
    assert wd.should_check(10) and not wd.should_check(11)
    assert wd.recover(init_state(CFG, device="cpu"), 0.0) is sentinel
    rep = wd.check_flags(np.array([True, False, True]))
    assert rep == HealthReport(ok=False, finite=True, s_diag_ok=False,
                               pose_ok=True)
    assert wd.last_report is rep and wd.n_failures == 1


def test_session_watchdog_recovers_a_poisoned_state():
    """A state poisoned between chunks trips the watchdog at the next
    checked frame; the session goes on from a robot-only state."""
    seq, track, _, _ = tfix.load("bench1_arc")
    cfg = SlamConfig(**KW)
    wd = Watchdog(cfg, check_every=1)
    sess = SlamSession(cfg, seq, track, device="cpu", watchdog=wd)
    sess.run(n_frames=4, chunk=4)
    assert wd.n_checks == 4 and wd.n_failures == 0
    x = sess.state.x.clone()
    x[0] = float("nan")
    sess.state = replace(sess.state, x=x)
    sess.step()
    assert wd.n_failures == 1
    assert not bool(sess.state.lm.active.any())
    assert bool(torch.isfinite(sess.state.x).all())
    rec = sess.step()
    assert np.isfinite(rec.pose).all() and rec.n_map > 0


# -- recorder ------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_some(recorder, seed=0, n=6, M=5):
    rng = np.random.default_rng(seed)
    for k in range(1, n + 1):
        sc = np.abs(rng.normal(size=2)).astype(np.float32) * 1e-2
        recorder.record_frame(
            k, odo_xy=rng.normal(size=2).astype(np.float32),
            pose=rng.normal(size=4), pose_cov2=np.diag(sc * sc),
            lids=rng.integers(1, 99, M).astype(np.int32),
            xyz=rng.normal(size=(M, 3)).astype(np.float32),
            valid=rng.random(M) < 0.6,
            n_map=int(rng.integers(0, 9)), n_visible=3, n_matched=2,
            redirected=bool(k == 3), wall_time=0.25 * k)
    recorder.close()


@pytest.mark.parametrize("use_native", [False, True])
def test_recorder_files_are_byte_equal_to_the_jax_packages(tmp_path,
                                                           use_native,
                                                           monkeypatch):
    """Each package's recorder with the same ``use_native``: the Python
    writers, or the C++ writer (10 decimals, no frame lines) where both
    packages' native libraries build."""
    from cv_monoslam_tpu.io import native as jnative
    from cv_monoslam_tpu.io import recording as jrec
    from cv_monoslam_tpu_torch.io import native as tnative
    from cv_monoslam_tpu_torch.io import recording as trec

    if use_native:
        # the JAX bindings over the library the port built (same source and
        # flags): their own load would run ``make`` in native/
        monkeypatch.setattr(jnative, "_LIB_PATH", tnative.library_path())
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_tried", False)
        assert jnative.available() == tnative.available()
    names = dict(robot_path="RobotPath.txt", features_path="FeaturesInfo.txt",
                 metrics_path="metrics.jsonl")
    for tag, mod in (("j", jrec), ("t", trec)):
        os.makedirs(tmp_path / tag)
        _record_some(mod.RunRecorder(
            **{k: str(tmp_path / tag / v) for k, v in names.items()},
            use_native=use_native))
    for v in names.values():
        got = (tmp_path / "t" / v).read_bytes()
        assert got == (tmp_path / "j" / v).read_bytes(), v
        assert len(got) > 200
    # a writer left out writes nothing
    _record_some(trec.RunRecorder(metrics_path=str(tmp_path / "m.jsonl")))
    rows = [json.loads(x) for x in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["frame"] for r in rows] == [1, 2, 3, 4, 5, 6]
    assert rows[2]["redirected"] is True and len(rows[0]["pose"]) == 4


def test_robot_path_roundtrip(tmp_path):
    from cv_monoslam_tpu_torch.io.recording import (RobotPathRecorder,
                                                    load_robot_path)

    p = str(tmp_path / "RobotPath.txt")
    r = RobotPathRecorder(p)
    cov = np.array([[1e-3, 1e-5], [1e-5, 2e-3]])
    r.record(1, np.array([0.1, 0.2]), np.array([0.11, 0.19]), cov)
    r.record(2, np.array([0.2, 0.3]), np.array([0.21, 0.29]), cov)
    r.close()
    back = load_robot_path(p)
    assert list(back["frame"]) == [1, 2]
    np.testing.assert_allclose(back["est_xy"][0], [0.11, 0.19], atol=1e-6)
    np.testing.assert_allclose(back["pose_cov"][1], cov, rtol=1e-4)
    open(p, "w").close()
    assert load_robot_path(p)["pose_cov"].shape == (0, 2, 2)


def test_session_records_every_frame(tmp_path):
    """Single steps and chunks both reach the recorder, in frame order,
    with the odometry row of each frame."""
    from cv_monoslam_tpu_torch.io.recording import (RunRecorder,
                                                    load_robot_path)

    seq, track, _, _ = tfix.load("bench1_arc")
    rec = RunRecorder(robot_path=str(tmp_path / "RobotPath.txt"),
                      features_path=str(tmp_path / "FeaturesInfo.txt"),
                      metrics_path=str(tmp_path / "metrics.jsonl"))
    sess = SlamSession(SlamConfig(**KW), seq, track, device="cpu",
                       recorder=rec)
    sess.step()
    sess.run(n_frames=8, chunk=4)
    rec.close()
    back = load_robot_path(str(tmp_path / "RobotPath.txt"))
    assert list(back["frame"]) == list(range(1, 10))
    np.testing.assert_allclose(back["odo_xy"], track.xy[1:10], atol=1e-6)
    np.testing.assert_allclose(back["est_xy"], sess.trajectory[:, :2],
                               atol=1e-6)
    rows = [json.loads(x) for x in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["n_matched"] for r in rows] == \
        [r.n_matched for r in sess.records]
    feats = (tmp_path / "FeaturesInfo.txt").read_text().splitlines()
    assert feats[0] == "# frame 1" and len(feats) > 9


# -- timers and trace ------------------------------------------------------------

def test_trace_writes_a_chrome_trace(tmp_path):
    from cv_monoslam_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "tr")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# -- viz ---------------------------------------------------------------------------

def _viz_state():
    state = init_state(CFG, device="cpu")
    arrays = state_to_arrays(state)
    rng = np.random.default_rng(5)
    arrays["x"][0:6] = [0, 0, 0, 0.01, 0.01, 1 / 3.0]
    arrays["x"][6:12] = [0.1, -0.2, 0, 0.3, -0.1, 0.4]
    arrays["S"] = np.triu(rng.normal(size=arrays["S"].shape)) * 0.05
    arrays["lm.active"][:2] = True
    arrays["lm.visible"][:2] = True
    arrays["lm.matched"][0] = True
    arrays["lm.is_loop"][1] = True
    arrays["lm.lid"][:2] = [5, 6]
    arrays["lm.pred"][:2] = [[60.0, 40.0], [30.0, 70.0]]
    arrays["lm.match_px"][0] = [61.0, 41.0]
    arrays["lm.si"][:2] = np.eye(2) * 2.0
    arrays["stored.valid"][0] = True
    return arrays


def test_landmark_display_info_matches_jax():
    import jax
    import jax.numpy as jnp

    from cv_monoslam_tpu import viz as jviz
    from cv_monoslam_tpu_torch import viz as tviz

    arrays = _viz_state()
    jcfg = JaxConfig(max_landmarks=4, dtype="float64")
    template = jstate.init_state(jcfg)
    jst = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(v) for v in arrays.values()])
    want = jviz.landmark_display_info(jst, jcfg)
    got = tviz.landmark_display_info(
        state_from_arrays(arrays, device="cpu"), CFG)
    assert sorted(got) == sorted(want)
    for k in ("xyz", "cov3", "sigma"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-9,
                                   err_msg=k)
    # eigenvectors are defined up to sign: compare the quaternions' axes
    # only where both are finite, and the discrete fields exactly
    for k in ("active", "is_loop", "lid"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["quat"].shape == (4, 4)
    np.testing.assert_allclose(got["xyz"][0, 2], 3.0, atol=0.1)


def _nonfinite_covariances():
    """3x3 covariances built with numpy from a seed: finite ones, and the
    non-finite patterns (an all-NaN block, one NaN entry below, above and on
    the diagonal, infinities on the diagonal, off it, and mixed with a
    NaN) in one batch with finite ones between them."""
    rng = np.random.default_rng(9)

    def spd():
        a = rng.normal(size=(3, 3))
        return a @ a.T + 0.1 * np.eye(3)

    cases = {"all_nan": np.full((3, 3), np.nan)}
    for i, j in ((0, 0), (2, 1), (0, 2)):
        cases[f"nan_{i}{j}"] = spd()
        cases[f"nan_{i}{j}"][i, j] = np.nan
    for i in range(3):
        cases[f"inf_{i}{i}"] = spd()
        cases[f"inf_{i}{i}"][i, i] = np.inf
    cases["inf_00_minus_inf_11"] = spd()
    cases["inf_00_minus_inf_11"][[0, 1], [0, 1]] = [np.inf, -np.inf]
    cases["inf_01"] = spd()
    cases["inf_01"][0, 1] = np.inf
    cases["inf_00_nan_01"] = spd()
    cases["inf_00_nan_01"][0, 0], cases["inf_00_nan_01"][0, 1] = (np.inf,
                                                                  np.nan)
    cases["all_inf"] = np.full((3, 3), np.inf)
    names, mats = [], []
    for name, c in cases.items():
        names += [f"finite before {name}", name]
        mats += [spd(), c]
    return names, np.stack(mats)


def _same_nans_and_close(got, want, what):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=f"{what}: NaN positions")
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9, atol=1e-9,
                               err_msg=what)


def test_covariance_ellipsoid_nonfinite_matches_jax():
    """On non-finite covariances ``jnp.linalg.eigh`` gives NaN where
    ``torch.linalg.eigh`` raised: sigma NaN, the quaternion NaN, or the
    identity's when only the diagonal holds infinities. float64, NaN
    positions equal, finite entries to 1e-9; the finite covariances of the
    batch keep their own eigh's bits (their eigenvectors' signs are
    LAPACK's choice in each package, so their quaternions are compared
    with the port's eigh alone)."""
    import jax.numpy as jnp

    from cv_monoslam_tpu.geometry import transforms as jtf
    from cv_monoslam_tpu_torch.geometry import transforms as ttf

    names, mats = _nonfinite_covariances()
    js, jq = (np.asarray(v) for v in jtf.covariance_ellipsoid(
        jnp.asarray(mats)))
    ts, tq = (v.numpy() for v in ttf.covariance_ellipsoid(
        torch.as_tensor(mats)))
    _same_nans_and_close(ts, js, "sigma")
    finite = np.isfinite(mats).all(axis=(1, 2))
    _same_nans_and_close(tq[~finite], jq[~finite], "quat")
    assert np.isnan(jq[~finite]).any() and not np.isnan(jq[~finite]).all()
    for i in np.flatnonzero(finite):
        w, v = torch.linalg.eigh(torch.as_tensor(mats[i]))
        assert np.array_equal(ts[i], torch.sqrt(w).numpy()), names[i]
        assert np.array_equal(tq[i], ttf.rotation_to_quaternion(v).numpy())


def test_landmark_display_info_nonfinite_matches_jax():
    """``landmark_display_info`` on a state whose sqrt factor holds NaN in
    one slot's columns and an infinity in another's: the JAX function's
    NaN positions and finite values (float64, 1e-9), where the port
    raised."""
    import jax
    import jax.numpy as jnp

    from cv_monoslam_tpu import viz as jviz
    from cv_monoslam_tpu_torch import viz as tviz

    arrays = _viz_state()
    arrays["S"][:, 6:12] = np.nan
    arrays["S"][14, 14] = np.inf
    jcfg = JaxConfig(max_landmarks=4, dtype="float64")
    template = jstate.init_state(jcfg)
    jst = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(v) for v in arrays.values()])
    want = jviz.landmark_display_info(jst, jcfg)
    got = tviz.landmark_display_info(
        state_from_arrays(arrays, device="cpu"), CFG)
    assert np.isnan(want["sigma"]).any() and not np.isnan(
        want["sigma"]).all()
    for k in ("xyz", "cov3", "sigma"):
        _same_nans_and_close(got[k], want[k], k)
    finite = np.isfinite(want["cov3"]).all(axis=(1, 2))
    _same_nans_and_close(got["quat"][~finite], want["quat"][~finite], "quat")


def test_viz_products(tmp_path):
    pytest.importorskip("matplotlib")
    from cv_monoslam_tpu_torch import viz

    state = state_from_arrays(_viz_state(), device="cpu")
    est = np.cumsum(np.ones((10, 2)) * 0.01, axis=0)
    covs = np.tile(np.eye(2) * 1e-4, (10, 1, 1))
    p1 = viz.plot_trajectory(est, est + 0.01, pose_covs=covs, gt_xy=est,
                             landmarks=np.ones((3, 3)),
                             path=str(tmp_path / "t.png"))
    img = np.random.default_rng(0).uniform(0, 255, (96, 128))
    p2 = viz.draw_overlay(img, state, CFG, path=str(tmp_path / "o.png"),
                          frame=7)
    p3 = viz.plot_map3d(state, CFG, est_path=est,
                        path=str(tmp_path / "m.png"))
    for p in (p1, p2, p3):
        assert os.path.getsize(p) > 1000


# -- synthetic sequences and video ---------------------------------------------------

def test_sequence_cache_is_shared_with_the_jax_package(tmp_path, monkeypatch):
    """Same directory layout, keys and file contents: a sequence one
    package rendered is loaded, not rendered again, by the other."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import experiment as jexp
    finally:
        sys.path.pop(0)
    from cv_monoslam_tpu_torch.io import synthetic as tsyn

    assert os.path.realpath(tsyn.CACHE) == os.path.realpath(jexp.CACHE)
    monkeypatch.setattr(tsyn, "CACHE", str(tmp_path))
    monkeypatch.setattr(jexp, "CACHE", str(tmp_path))

    def no_render(*a, **k):
        raise AssertionError("rendered again instead of loading the cache")

    # the port renders, the JAX package loads
    seq, track, gt_xy, gt_th = tsyn.get_sequence("arc@0.04", 3, 1, noise=0.02)
    assert len(os.listdir(tmp_path)) == 1
    with monkeypatch.context() as m:
        m.setattr(jexp, "make_world", no_render)
        jseq, jtrack, jgt, jth = jexp.get_sequence("arc@0.04", 3, 1,
                                                   noise=0.02)
    np.testing.assert_array_equal(jseq.get(2), seq.get(2))
    np.testing.assert_array_equal(jtrack.xy, track.xy)
    np.testing.assert_array_equal(jgt, gt_xy)
    np.testing.assert_array_equal(jth, gt_th)
    # the JAX package renders, the port loads; and both render the same
    jseq, jtrack, _, _ = jexp.get_sequence("straight", 2, 0)
    assert len(os.listdir(tmp_path)) == 2
    with monkeypatch.context() as m:
        m.setattr(tsyn, "make_world", no_render)
        seq, track, _, _ = tsyn.get_sequence("straight", 2, 0)
    np.testing.assert_array_equal(seq.get(1), jseq.get(1))
    np.testing.assert_array_equal(track.theta, jtrack.theta)
    monkeypatch.setattr(tsyn, "CACHE", str(tmp_path / "fresh"))
    seq2, _, _, _ = tsyn.get_sequence("straight", 2, 0)
    np.testing.assert_array_equal(seq2.get(1), jseq.get(1))
    assert float(seq2.get(1).std()) > 1.0


def test_mjpeg_avi_roundtrip_and_same_bytes_as_the_jax_package(tmp_path):
    pytest.importorskip("PIL")
    from cv_monoslam_tpu.io import video as jvid
    from cv_monoslam_tpu_torch.io import video as tvid

    frames = np.random.default_rng(0).integers(0, 255, (4, 48, 64),
                                               dtype=np.uint8)
    tvid.write_mjpeg_avi(str(tmp_path / "t.avi"), frames, quality=95)
    jvid.write_mjpeg_avi(str(tmp_path / "j.avi"), frames, quality=95)
    assert (tmp_path / "t.avi").read_bytes() == \
        (tmp_path / "j.avi").read_bytes()
    vs = tvid.VideoSequence(str(tmp_path / "j.avi"))
    assert len(vs) == 4 and len(tvid.index_avi_frames(vs.path)) == 4
    for k in (3, 0, 2):
        got = vs.get(k)
        assert got.dtype == np.float32 and got.shape == (48, 64)
        assert np.abs(got - frames[k]).mean() < 12.0       # JPEG-lossy


# -- the command line -------------------------------------------------------------

def _run_cli(args, timeout=600):
    """``python -m cv_monoslam_tpu_torch <args>`` in a fresh interpreter that
    reports afterwards which modules of JAX or the JAX package it loaded."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['cv_monoslam_tpu_torch'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('cv_monoslam_tpu_torch', run_name='__main__')\n"
        "    rc = 0\n"
        "except SystemExit as e:\n"
        "    rc = e.code or 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cv_monoslam_tpu'))\n"
        "print('LOADED:' + ','.join(bad))\n"
        "sys.exit(rc)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_synthetic_run(tmp_path):
    """End to end on the CPU: a synthetic run with recording, viz (when
    matplotlib is there), watchdog, backend and checkpoints; then a resumed
    run from its checkpoint. ``jax`` is never loaded."""
    out = str(tmp_path / "out")
    try:
        import matplotlib  # noqa: F401
        viz = ["--viz"]
    except ImportError:
        viz = []
    res = _run_cli(
        ["run", "--device", "cpu", "--frames", "8", "--out", out, "--record",
         *viz, "--watchdog", "--backend", "--checkpoint",
         "--checkpoint-every", "4", "--chunk", "4",
         "--set", "max_landmarks=16", "--set", "max_detections=32",
         "--set", "max_new_per_frame=8", "--set", "keyframe_every=2"])
    assert res.returncode == 0, res.stderr[-2000:]
    for name in ("RobotPath.txt", "FeaturesInfo.txt", "metrics.jsonl",
                 "trajectory.npz", "keyframes.npz",
                 os.path.join("ckpt", "ckpt_000005.npz")):
        assert os.path.exists(os.path.join(out, name)), name
    if viz:
        for name in ("trajectory.png", "map3d.png", "overlay.png"):
            assert os.path.getsize(os.path.join(out, name)) > 1000
    assert "ATE" in res.stdout and "backend: 3 keyframes" in res.stdout
    assert "LOADED:\n" in res.stdout, res.stdout[-500:]
    poses = np.load(os.path.join(out, "trajectory.npz"))["poses"]
    assert poses.shape == (7, 4) and np.isfinite(poses).all()

    out2 = str(tmp_path / "out2")
    res = _run_cli(
        ["run", "--device", "cpu", "--frames", "8", "--out", out2,
         "--resume", os.path.join(out, "ckpt", "ckpt_000005.npz")])
    assert res.returncode == 0, res.stderr[-2000:]
    z = np.load(os.path.join(out2, "trajectory.npz"))
    assert list(z["frames"]) == [5, 6, 7]
    np.testing.assert_allclose(z["poses"], poses[4:], atol=1e-5)


def test_cli_info_and_device_default(tmp_path):
    res = _run_cli(["info", "--device", "cpu"], timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"torch: {torch.__version__}" in res.stdout
    assert "device: cpu" in res.stdout and '"max_landmarks"' in res.stdout
    assert "LOADED:\n" in res.stdout
    if not torch.cuda.is_available():
        # no --device: the card is the default, and it is not there
        res = _run_cli(["info"], timeout=120)
        assert res.returncode != 0 and "no CUDA device" in res.stderr
