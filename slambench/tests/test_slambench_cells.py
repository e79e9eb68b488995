"""Each cell end to end on the CPU at a tiny size (the kernels' plain
versions, the eager route), the faults the check must catch, and what a
run loads."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from slambench import harness
from slambench.tests import tiny


@pytest.mark.parametrize("name", ["m576_replay", "m32_replay", "m32_live"])
def test_cell_runs_and_is_correct(name):
    res, rows = tiny.run(name)
    assert res["correct"], rows
    assert res["failed"] == 0 and res["attempted"] > 0
    checks = res["checks"]
    assert list(res)[-1] == "checks" and checks["samples"]["value"] >= 1
    bench = harness.benchmark()
    want = {m["name"] for m in harness.cell_metrics(bench, name,
                                                    "end_to_end")}
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "cpu"


def test_traced_run_reads_the_trace():
    """On the CPU the profiler sees no device: the readers return nothing
    and the line still carries the device's busy and window seconds."""
    res, _ = tiny.run("m32_replay", traced=True)
    assert res["correct"]
    assert res["metrics"] == {}
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _broken(monkeypatch, fault):
    """The timed path broken underneath: ``slam_step`` as the session
    calls it."""
    from cv_monoslam_tpu_torch import api
    from cv_monoslam_tpu_torch.filter import srukf

    real = api.slam_step
    if fault == "state_unchanged":
        def step(state, *a, **k):
            _, out = real(state, *a, **k)
            return state, out
        monkeypatch.setattr(api, "slam_step", step)
    elif fault == "half_the_matches":
        real_update = srukf.kalman_update

        def update(state, cache, cfg):
            from dataclasses import replace
            lm = state.lm
            keep = torch.arange(lm.matched.shape[0]) % 2 == 0
            return real_update(
                replace(state, lm=replace(lm, matched=lm.matched & keep)),
                cache, cfg)
        monkeypatch.setattr(srukf, "kalman_update", update)
    elif fault == "answer_altered":
        def step(state, *a, **k):
            st, out = real(state, *a, **k)
            return st, {**out, "pose": out["pose"] + 1e-3}
        monkeypatch.setattr(api, "slam_step", step)
    elif fault == "landmarks_unupdated":
        # the map's part of x and S kept from before the frame, the pose,
        # the tables and the frame counter moved on
        def step(state, *a, **k):
            from dataclasses import replace
            st, out = real(state, *a, **k)
            x = torch.cat([state.x[:-4], st.x[-4:]])
            S = st.S.clone()
            S[:-4, :-4] = state.S[:-4, :-4]
            return replace(st, x=x, S=S), out
        monkeypatch.setattr(api, "slam_step", step)
    elif fault in ("stale_carry_midchunk", "answer_altered_midchunk"):
        # a chunk's frames after its first: stepped from the state before
        # the frame ahead of them (its counter moved on), or with their
        # pose altered where it is made (by 1: the chained frame's limits
        # are those of a frame stepped on from the reference's own state)
        def frames(self, state, imgs, odo, detect, redirect=False):
            from dataclasses import replace
            imgs = imgs.to(self._dtype)
            rows, prev = [], state
            for i in range(imgs.shape[0]):
                start = state
                if fault == "stale_carry_midchunk" and i > 0:
                    start = replace(prev, frame=state.frame)
                prev = state
                state, out = real(start, imgs[i], odo[i], odo[i + 1],
                                  redirect, self.cfg, allow_detect=detect)
                if fault == "answer_altered_midchunk" and i > 0:
                    out = {**out, "pose": out["pose"] + 1.0}
                rows.append(api._pack_row(out, self.cfg.max_landmarks))
            return state, torch.stack(rows)
        monkeypatch.setattr(api.SlamSession, "_frames", frames)


@pytest.mark.parametrize("name", ["m32_replay", "m32_live", "m576_replay"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_matches",
                                   "answer_altered", "landmarks_unupdated"])
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    _broken(monkeypatch, fault)
    res, rows = tiny.run(name)
    assert not res["correct"], rows


@pytest.mark.parametrize("name", ["m32_replay", "m576_replay"])
@pytest.mark.parametrize("fault", ["stale_carry_midchunk",
                                   "answer_altered_midchunk"])
def test_broken_chunk_is_not_correct(monkeypatch, name, fault):
    """Faults only in a chunk's later frames: the check judges them too."""
    _broken(monkeypatch, fault)
    res, rows = tiny.run(name)
    assert not res["correct"], rows


def test_run_loads_neither_jax_nor_the_jax_package():
    """A whole tiny cell in a fresh process, then the loaded modules'
    top-level names, compared whole."""
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        from slambench import harness
        from slambench.tests import tiny
        import slambench.run
        res, _ = tiny.run("m32_live")
        print("FOUND", harness.forbidden_modules(), res["correct"])
        print("PORT", "cv_monoslam_tpu_torch" in sys.modules)
    """ % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND [] True" in out.stdout and "PORT True" in out.stdout


def test_run_without_a_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload", "m32_live",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_same_seed_same_inputs():
    from slambench import lap

    t = harness.traffic("blob_lap")
    a, b = (lap.odometry(t, 2147483901, 300) for _ in range(2))
    assert np.array_equal(a, b) and np.all(a[0, 1:3] == 0.0)
    c = lap.odometry(t, 2147483902, 300)
    assert a[0, 0] != c[0, 0]
