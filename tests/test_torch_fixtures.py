"""The port's ``io/fixtures.build``: rendering a committed fixture anew
with the port's ``io/synthetic.py`` gives the committed bytes.

Every case renders into a temporary directory (``FIXTURES_DIR`` and
``MANIFEST`` patched to it, with a copy of the committed manifest) and never
writes into ``fixtures/``. ``parity_loop`` takes about 5 s; the other three
fixtures are one ``slow`` parametrized test.
"""

import json
import os
import shutil

import numpy as np
import pytest

from cv_monoslam_tpu.io import fixtures as jfix
from cv_monoslam_tpu_torch.io import fixtures as tfix

COMMITTED = os.path.join(os.path.dirname(__file__), "..", "fixtures")


@pytest.fixture
def scratch_fixtures(tmp_path, monkeypatch):
    man = tmp_path / "MANIFEST.json"
    shutil.copy(os.path.join(COMMITTED, "MANIFEST.json"), man)
    monkeypatch.setattr(tfix, "FIXTURES_DIR", str(tmp_path))
    monkeypatch.setattr(tfix, "MANIFEST", str(man))
    with open(man) as f:
        return tmp_path, json.load(f)


def _build_and_check(name, scratch):
    tmp_path, committed = scratch
    path = tfix.build(name, force=True)
    assert os.path.dirname(path) == str(tmp_path)
    entry = committed["files"][name]
    assert tfix._sha256(path) == entry["sha256"]
    with open(tmp_path / "MANIFEST.json") as f:
        man = json.load(f)
    assert man == committed                 # re-anchored to the same entry
    seq, track, gt_xy, _ = tfix.load(name)  # and loads through the check
    assert list(np.asarray(seq._frames).shape) == entry["shape"]
    assert len(track) > 1 and np.isfinite(gt_xy).all()


def test_build_parity_loop_reproduces_the_committed_bytes(scratch_fixtures):
    _build_and_check("parity_loop", scratch_fixtures)
    # an anchored file is kept unless forced
    tmp_path, _ = scratch_fixtures
    path = tmp_path / "parity_loop.npz"
    stamp = os.stat(path).st_mtime_ns
    assert tfix.build("parity_loop") == str(path)
    assert os.stat(path).st_mtime_ns == stamp


@pytest.mark.slow
@pytest.mark.parametrize("name", ["bench1_arc", "bench3_grid", "bench4_lap"])
def test_build_reproduces_the_committed_bytes(scratch_fixtures, name):
    _build_and_check(name, scratch_fixtures)


def test_specs_equal_the_jax_packages():
    assert tfix.SPECS == jfix.SPECS
    assert tfix.RENDERER_VERSION == jfix.RENDERER_VERSION
    with open(os.path.join(COMMITTED, "MANIFEST.json")) as f:
        man = json.load(f)
    assert man["renderer"] == tfix.RENDERER_VERSION
    assert {k: v["spec"] for k, v in man["files"].items()} == tfix.SPECS
