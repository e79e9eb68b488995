"""The port's native C++ host runtime (``io/native.py`` over
``native/cvms_runtime.cpp``) against its Python counterparts and against the
JAX package's bindings of the same library: the counterpart of
``tests/test_native.py`` plus cross-package cases.

The port builds its own copy of the library under ``.cache/native/``; the
JAX package's bindings are pointed at that copy (the JAX package builds its
own into ``native/``, from the same source with the same flags). Decoded
frames, parsed odometry and recorded bytes are equal exactly; native rows
and Python rows (10 against 6 decimals) agree to 1e-6.
"""

import os

import numpy as np
import pytest

from cv_monoslam_tpu.io import dataset as jdataset
from cv_monoslam_tpu.io import native as jnative
from cv_monoslam_tpu.io import recording as jrec
from cv_monoslam_tpu_torch.io import native
from cv_monoslam_tpu_torch.io import recording as trec
from cv_monoslam_tpu_torch.io.dataset import (ImageSequence,
                                              load_odometry_file,
                                              parse_odometry_text,
                                              preprocess_odometry)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime not built")

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's bindings over the library this package built (same
    source, same flags): its own load would run ``make`` in ``native/``,
    which no test of the port may write into."""
    monkeypatch.setattr(jnative, "_LIB_PATH", native.library_path())
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.available()
    return jnative


def _write_odo(path, rows):
    with open(path, "w") as f:
        for (i, t, x, y, th) in rows:
            f.write(f"{i} : {t} {x} {y} {th}\n")


def _random_odo(path, seed=3, n=60):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0, 0.03, n))
    y = np.cumsum(rng.uniform(0, 0.02, n))
    th = np.cumsum(rng.uniform(-0.2, 0.9, n))
    _write_odo(path, [(i, 0.1 * i, x[i], y[i], th[i]) for i in range(n)])


def _jpegs(tmp_path, n, shape=(48, 64), quality=95, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        img = rng.integers(0, 256, shape, np.uint8)
        Image.fromarray(img, mode="L").save(tmp_path / f"{i:04d}.jpg",
                                            quality=quality)
        frames.append(img)
    return str(tmp_path / "%04d.jpg"), frames


def test_library_builds_outside_native_dir():
    path = native.library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.realpath(os.path.join(ROOT, "native")) not in \
        os.path.realpath(path)
    assert native.build() is False          # cached: nothing rebuilt


def test_native_odometry_matches_python(tmp_path):
    p = tmp_path / "odo.txt"
    _random_odo(p)
    ids_n, xy_n, th_n, rd_n = native.load_odometry(str(p))
    track = load_odometry_file(str(p))
    np.testing.assert_array_equal(ids_n, track.frame_id)
    np.testing.assert_allclose(xy_n, track.xy, rtol=0, atol=1e-12)
    np.testing.assert_allclose(th_n, track.theta, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(rd_n, track.redirect)


def test_native_odometry_equals_the_jax_packages(tmp_path, jax_native):
    p = tmp_path / "odo.txt"
    _random_odo(p, seed=5, n=80)
    got = native.load_odometry(str(p), min_step_xy=0.02)
    want = jax_native.load_odometry(str(p), min_step_xy=0.02)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    track = preprocess_odometry(parse_odometry_text(p.read_text()),
                                min_step_xy=0.02)
    np.testing.assert_array_equal(got[0], track.frame_id)
    np.testing.assert_array_equal(got[3], track.redirect)


def test_native_odometry_min_step_filter(tmp_path):
    # rows below the 0.01 m min-step must be dropped (SLAM.cpp:419-432)
    rows = [(0, 0.0, 0.0, 0.0, 0.0),
            (1, 0.1, 0.001, 0.001, 0.0),    # dropped
            (2, 0.2, 0.05, 0.0, 0.0),
            (3, 0.3, 0.052, 0.001, 0.0),    # dropped
            (4, 0.4, 0.10, 0.0, 2.0)]       # kept + redirect (|dth|>45deg)
    p = tmp_path / "odo.txt"
    _write_odo(p, rows)
    ids, xy, th, rd = native.load_odometry(str(p))
    assert list(ids) == [0, 2, 4]
    assert rd.tolist() == [False, False, True]


def test_native_jpeg_decode_matches_pil(tmp_path):
    from PIL import Image

    pattern, _ = _jpegs(tmp_path, 1)
    p = pattern % 0
    got = native.decode_jpeg_gray(p)
    want = np.asarray(Image.open(p).convert("L"), np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1.0)


def test_image_sequence_get_equals_the_jax_packages(tmp_path, jax_native):
    pattern, _ = _jpegs(tmp_path, 3, shape=(96, 128), seed=4)
    tseq = ImageSequence(pattern=pattern)
    jseq = jdataset.ImageSequence(pattern=pattern)
    for i in range(3):
        got = tseq.get(i)
        assert got.dtype == np.float32 and got.shape == (96, 128)
        assert np.array_equal(got, jseq.get(i))
        assert np.array_equal(got, native.decode_jpeg_gray(pattern % i))
    with pytest.raises(FileNotFoundError):
        tseq.get(7)


def test_prefetch_equals_get_frame_for_frame(tmp_path):
    pattern, _ = _jpegs(tmp_path, 8, seed=6)
    seq = ImageSequence(pattern=pattern)
    ids = [3, 0, 7, 1, 2, 6, 5, 4]
    got = list(seq.prefetch(ids, width=64, height=48, depth=3))
    assert len(got) == 8
    for i, frame in zip(ids, got):
        assert np.array_equal(frame, seq.get(i))
    # an in-memory sequence iterates synchronously, in the order asked
    frames = np.stack(got)
    mem = ImageSequence(frames=frames)
    assert all(np.array_equal(a, b) for a, b in
               zip(mem.prefetch([2, 0], 64, 48), frames[[2, 0]]))


def test_native_prefetcher_order_and_content(tmp_path):
    pattern, frames = _jpegs(tmp_path, 6, shape=(32, 40), quality=100,
                             seed=1)
    pf = native.NativePrefetcher(pattern, np.arange(6), width=40, height=32,
                                 depth=3)
    for i in range(6):
        got = pf.next()
        assert got is not None and got.shape == (32, 40)
        # quality-100 jpeg of gray image is near-lossless
        assert np.abs(got - frames[i]).mean() < 3.0
    assert pf.next() is None
    pf.close()


def test_native_recorder_format(tmp_path):
    rp = tmp_path / "RobotPath.txt"
    fp = tmp_path / "FeaturesInfo.txt"
    rec = native.NativeRecorder(str(rp), str(fp))
    rec.record_robot(3, (0.1, 0.2), (0.11, 0.19),
                     np.array([[1e-4, 0.0], [0.0, 2e-4]]))
    rec.record_features(np.array([7, 8]),
                        np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]),
                        np.array([1, 0], np.uint8))
    rec.close()
    rows = np.loadtxt(rp).reshape(-1, 9)
    assert rows[0, 0] == 3
    np.testing.assert_allclose(rows[0, 1:5], [0.1, 0.2, 0.11, 0.19])
    np.testing.assert_allclose(rows[0, 5:], [1e-4, 0.0, 0.0, 2e-4])
    frows = np.loadtxt(fp).reshape(-1, 4)
    assert frows.shape == (1, 4)          # only the valid landmark
    np.testing.assert_allclose(frows[0], [7, 1.0, 2.0, 3.0])
    assert rp.read_text().startswith("3 0.1000000000 0.2000000000 ")


def _record(recorder, seed=0, n=6, M=5):
    rng = np.random.default_rng(seed)
    for k in range(1, n + 1):
        sc = np.abs(rng.normal(size=2)) * 1e-2
        recorder.record_frame(
            k, odo_xy=rng.normal(size=2), pose=rng.normal(size=4),
            pose_cov2=np.diag(sc * sc),
            lids=rng.integers(1, 99, M).astype(np.int32),
            xyz=rng.normal(size=(M, 3)), valid=rng.random(M) < 0.6,
            n_map=3, n_matched=2)
    recorder.close()


def _run(mod, tmp_path, tag, **kw):
    names = dict(robot_path="RobotPath.txt",
                 features_path="FeaturesInfo.txt",
                 metrics_path="metrics.jsonl")
    _record(mod.RunRecorder(
        **{k: str(tmp_path / tag / v) for k, v in names.items()}, **kw))
    return {v: (tmp_path / tag / v) for v in names.values()}


def test_native_recorder_bytes_equal_the_jax_native_recorders(tmp_path,
                                                              jax_native):
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "j")
    got = _run(trec, tmp_path, "t", use_native=True)
    want = _run(jrec, tmp_path, "j", use_native=True)
    for name in got:
        assert got[name].read_bytes() == want[name].read_bytes(), name
    assert "# frame" not in got["FeaturesInfo.txt"].read_text()


def test_native_rows_equal_python_rows(tmp_path):
    os.makedirs(tmp_path / "n")
    nat = _run(trec, tmp_path, "n", use_native=True)
    py = _run(trec, tmp_path, "p")
    for name in ("RobotPath.txt", "FeaturesInfo.txt"):
        assert nat[name].read_bytes() != py[name].read_bytes()
        a, b = np.loadtxt(nat[name]), np.loadtxt(py[name])
        assert a.shape == b.shape and a.size > 20
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert nat["metrics.jsonl"].read_bytes() == py["metrics.jsonl"].read_bytes()


def test_parse_odometry_text_python_oracle():
    text = "0 : 0.0 1.0 2.0 0.5\nbad line\n1 : 0.1 1.5 2.5 0.6\n"
    rows = parse_odometry_text(text)
    assert rows.shape == (2, 4)
    assert len(preprocess_odometry(rows)) == 2
