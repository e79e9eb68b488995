"""PyTorch port: checkpoint / resume and watchdog recovery.

The cases of the JAX package's ``tests/test_runtime.py`` (checkpoint round
trip, watchdog detects and recovers), plus what the port's docstrings
promise: every leaf round-trips exactly, a resumed session continues bit for
bit, and the two packages' checkpoint files are interchangeable (each loads
what the other saved, leaf for leaf). Everything here is exact: a
checkpoint stores arrays, it computes nothing.
"""

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
