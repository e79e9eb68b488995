"""The full-sigma measurement prediction's kernels (``ops/vision.py::
measure_project`` and ``measure_merge``, ``csrc/vision_kernels.cu``) and
their routing in ``filter/measurement.py``.

The kernels run only on the card (``chip_smoke.py --measure`` holds them
against the plain version there). Here: the plain version ``full_rows_ref``
is the parent's chain bit for bit; ``vision_backend="xla"`` and CPU tensors
take it, any other device the two wrappers, with the slot range, around the
plain version's two reductions; a landmark shard's rows are a slice of the
whole call; the wrappers refuse what the kernels do not take; and a model
of the kernels' arithmetic, built from the constants in the order the CUDA
source declares them, agrees with the plain version to the roundoff of a
division by a scalar taken as a product with its reciprocal (as the card's
torch takes it) and of the einsum's rounding on the CPU.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from cv_monoslam_tpu_torch.api import SlamSession
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.filter import measurement
from cv_monoslam_tpu_torch.filter.measurement import (chol2x2_upper,
                                                      full_rows_ref,
                                                      prediction_rows,
                                                      project_all)
from cv_monoslam_tpu_torch.filter.sigma import ut_weights
from cv_monoslam_tpu_torch.io import fixtures as tfix
from cv_monoslam_tpu_torch.ops import control, vision

KW = dict(max_landmarks=16, max_new_per_frame=4, max_detections=32)
DTYPES = ("float32", "float64")
CU = os.path.join(os.path.dirname(vision.__file__), "csrc",
                  "vision_kernels.cu")


def _parent_full_rows(state, cache, cfg, lo, hi):
    """The parent commit's ``filter/measurement._full_rows``, frozen."""
    dtype = state.x.dtype
    dev = state.x.device
    D = cfg.state_dim
    w = ut_weights(D + 5, cfg)

    pix = project_all(cache.sigma, cfg, lo, hi)         # (M, 2, ns)
    mean = pix @ w.mean_weights(dtype, dev)             # (M, 2)

    lm = state.lm
    visible = lm.active[lo:hi] & (mean[:, 0] != 0) & (mean[:, 1] != 0)

    dev_pix = w.wi_sr * (pix[:, :, 1:] - pix[:, :, :1])  # (M, 2, 2Na)
    gram = torch.einsum("mis,mjs->mij", dev_pix, dev_pix)
    gram = gram + (cfg.sigma_measure ** 2) * torch.eye(
        2, dtype=dtype, device=dev)
    si = chol2x2_upper(gram)
    return dict(visible=visible,
                pred=torch.where(visible[:, None], mean, lm.pred[lo:hi]),
                si=torch.where(visible[:, None, None], si, lm.si[lo:hi]),
                sigma_pix=pix)


@pytest.fixture(scope="module", params=DTYPES)
def kept(request):
    """(cfg, [(state, cache)]): the inputs of three measurement predictions
    of a CPU session on ``bench1_arc`` (frames 11-13), and each again with
    its sigma set moved by seeded noise."""
    seq, track, _, _ = tfix.load("bench1_arc")
    cfg = SlamConfig(**KW, dtype=request.param)
    sess = SlamSession(cfg, seq, track, device="cpu")
    sets, real = [], measurement._full_rows

    def keep(state, cache, cfg_, lo, hi):
        sets.append((control.tree_map(torch.clone, state),
                     control.tree_map(torch.clone, cache)))
        return real(state, cache, cfg_, lo, hi)

    for _ in range(10):
        sess.step()
    measurement._full_rows = keep
    try:
        for _ in range(3):
            sess.step()
    finally:
        measurement._full_rows = real
    g = torch.Generator().manual_seed(22)
    noisy = []
    for state, cache in sets:
        sig = cache.sigma
        moved = sig + 1e-3 * torch.randn(sig.shape, generator=g,
                                         dtype=sig.dtype)
        noisy.append((state, dataclasses.replace(cache, sigma=moved)))
    return cfg, sets + noisy


def _equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)


def test_plain_version_is_the_parents_chain(kept):
    cfg, sets = kept
    visible = 0
    for state, cache in sets:
        ref = full_rows_ref(state, cache, cfg, 0, cfg.max_landmarks)
        _equal(ref, _parent_full_rows(state, cache, cfg, 0,
                                      cfg.max_landmarks))
        visible += int(ref["visible"].sum())
    assert visible > 0


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
def test_cpu_tensors_and_xla_take_the_plain_version(kept, backend,
                                                    monkeypatch):
    cfg, sets = kept
    cfg = dataclasses.replace(cfg, vision_backend=backend)

    def refuse(*a, **k):
        raise AssertionError("a kernel's wrapper was called")

    monkeypatch.setattr(vision, "measure_project", refuse)
    monkeypatch.setattr(vision, "measure_merge", refuse)
    for state, cache in sets:
        st, ca = measurement.measurement_predict(state, cache, cfg)
        ref = full_rows_ref(state, cache, cfg, 0, cfg.max_landmarks)
        _equal(dict(visible=st.lm.visible, pred=st.lm.pred, si=st.lm.si,
                    sigma_pix=ca.sigma_pix),
               {k: ref[k] for k in ("visible", "pred", "si", "sigma_pix")})


def _on_meta(tree):
    return control.tree_map(lambda t: t.to("meta"), tree)


@pytest.mark.parametrize("lo,hi", [(0, 16), (4, 12)])
def test_other_devices_take_the_wrappers_with_the_slot_range(kept, lo, hi,
                                                             monkeypatch):
    """A tensor on any device but the CPU goes to the two wrappers (here
    spies, on the ``meta`` device) with the slot range's rows, the plain
    version's reductions between them; ``xla`` goes to the plain version."""
    cfg, sets = kept
    state, cache = (_on_meta(t) for t in sets[0])
    calls = {}

    def project(sigma, **kw):
        calls["project"] = (sigma, kw)
        m, ns = kw["m"], sigma.shape[1]
        return torch.empty((m, ns, 2), dtype=sigma.dtype,
                           device=sigma.device).permute(0, 2, 1)

    def merge(mean, gram, active, pred, si, **kw):
        calls["merge"] = (mean, gram, active, pred, si, kw)
        return (torch.empty(active.shape, dtype=torch.bool,
                            device=mean.device), torch.empty_like(pred),
                torch.empty_like(si))

    monkeypatch.setattr(vision, "measure_project", project)
    monkeypatch.setattr(vision, "measure_merge", merge)
    rows = prediction_rows(state, cache, cfg, lo, hi)
    assert set(rows) == {"visible", "pred", "si", "sigma_pix"}
    ns = cache.sigma.shape[1]
    assert rows["sigma_pix"].shape == (hi - lo, 2, ns)
    sigma, kw = calls["project"]
    assert sigma is cache.sigma
    assert kw == dict(lo=lo, m=hi - lo, state_dim=cfg.state_dim,
                      cam=cfg.camera)
    mean, gram, active, pred, si, kw = calls["merge"]
    assert mean.shape == (hi - lo, 2) and gram.shape == (hi - lo, 2, 2)
    assert active.shape == (hi - lo,) and active.dtype == torch.bool
    assert pred.shape == (hi - lo, 2) and si.shape == (hi - lo, 2, 2)
    assert kw == dict(sigma_measure=cfg.sigma_measure)

    seen = []
    xla = dataclasses.replace(cfg, vision_backend="xla")
    monkeypatch.setattr(measurement, "full_rows_ref",
                        lambda *a: seen.append(a) or "plain")
    assert prediction_rows(state, cache, xla, lo, hi) == "plain"
    assert len(seen) == 1 and seen[0][3:] == (lo, hi)


@pytest.mark.parametrize("lo,hi", [(0, 5), (5, 11), (11, 16), (3, 4)])
def test_prediction_rows_are_a_slice_of_the_whole_call(kept, lo, hi):
    cfg, sets = kept
    for state, cache in sets[:2]:
        whole = prediction_rows(state, cache, cfg, 0, cfg.max_landmarks)
        part = prediction_rows(state, cache, cfg, lo, hi)
        _equal(part, {k: v[lo:hi] for k, v in whole.items()})


def test_kernels_have_the_measure_slots():
    assert vision.KERNELS[-2:] == ("measure_project", "measure_merge")
    assert len(set(vision.KERNELS)) == len(vision.KERNELS)


def _tail_args(cfg, state, cache, lo=0, hi=None):
    """The merge's arguments: the plain version's reductions of its own
    pixels, the slots' rows."""
    hi = cfg.max_landmarks if hi is None else hi
    pix = project_all(cache.sigma, cfg, lo, hi)
    mean, gram = measurement._pixel_moments(pix, cfg)
    lm = state.lm
    return ([mean, gram, lm.active[lo:hi], lm.pred[lo:hi], lm.si[lo:hi]],
            dict(sigma_measure=cfg.sigma_measure))


def _set(i, f):
    return lambda a, kw: a.__setitem__(i, f(a[i]))


def _other(t):
    return t.to(torch.float64 if t.dtype == torch.float32 else torch.float32)


PROJECT_FAULTS = {
    "sigma rows": (ValueError, _set(0, lambda t: t[1:])),
    "sigma 1-d": (ValueError, _set(0, lambda t: t[0])),
    "slots past the map": (ValueError, lambda a, kw: kw.update(lo=3)),
    "negative lo": (ValueError, lambda a, kw: kw.update(lo=-1)),
    "no slots": (ValueError, lambda a, kw: kw.update(m=0)),
    "half sigma": (TypeError, _set(0, lambda t: t.half())),
    "sigma not contiguous": (ValueError,
                             _set(0, lambda t: t.T.contiguous().T)),
    "cpu": (ValueError, lambda a, kw: None),
}
MERGE_FAULTS = {
    "mean shape": (ValueError, _set(0, lambda t: t[:, :1])),
    "gram shape": (ValueError, _set(1, lambda t: t[:, 0])),
    "no slots": (ValueError, lambda a, kw: [
        a.__setitem__(i, a[i][:0]) for i in range(5)]),
    "pred shape": (ValueError, _set(3, lambda t: t[:, :1])),
    "si shape": (ValueError, _set(4, lambda t: t[:, 0])),
    "half": (TypeError, lambda a, kw: [
        a.__setitem__(i, a[i].half()) for i in (0, 1, 3, 4)]),
    "mixed types": (TypeError, _set(3, _other)),
    "active not bool": (TypeError, _set(2, lambda t: t.to(torch.uint8))),
    "si not contiguous": (ValueError, _set(4, lambda t: t.transpose(1, 2))),
    "cpu": (ValueError, lambda a, kw: None),
}


@pytest.mark.parametrize("fault", list(PROJECT_FAULTS))
def test_project_wrapper_refuses_what_the_kernel_does_not_take(kept, fault):
    cfg, sets = kept
    args = [sets[0][1].sigma]
    kw = dict(lo=0, m=cfg.max_landmarks, state_dim=cfg.state_dim,
              cam=cfg.camera)
    exc, spoil = PROJECT_FAULTS[fault]
    spoil(args, kw)
    with pytest.raises(exc, match="measure_project"):
        vision.measure_project(*args, **kw)


@pytest.mark.parametrize("fault", list(MERGE_FAULTS))
def test_merge_wrapper_refuses_what_the_kernel_does_not_take(kept, fault):
    cfg, sets = kept
    args, kw = _tail_args(cfg, *sets[0])
    exc, spoil = MERGE_FAULTS[fault]
    spoil(args, kw)
    with pytest.raises(exc, match="measure_merge"):
        vision.measure_merge(*args, **kw)


def _consts_order() -> dict:
    """The index of each name of ``enum MeasureConst`` in the CUDA source."""
    with open(CU) as f:
        body = re.search(r"enum MeasureConst \{([^}]*)\}", f.read()).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    return {n: i for i, n in enumerate(names)}


def _project_model(sigma, *, lo, m, state_dim, cam):
    """``measure_project_kernel``'s arithmetic in its order, vectorized over
    the points, the constants taken from :func:`vision.measure_consts` by
    the CUDA enum's order; (M, 2, ns)."""
    k = _consts_order()
    c = vision.measure_consts(cam)
    assert len(c) == k["kMeasureConsts"]
    dt = sigma.dtype

    def cst(name):
        return torch.tensor(c[k[name]], dtype=dt)

    d = state_dim
    f = sigma[6 * lo:6 * (lo + m)].reshape(m, 6, -1)
    ax, ay, az, th, ph, rho = f.unbind(1)
    px, py, pz, tr = sigma[d - 4], sigma[d - 3], sigma[d - 2], sigma[d - 1]
    e0, e1 = sigma[d + 3], sigma[d + 4]
    cp = torch.cos(ph)
    r = torch.where(rho == 0, torch.tensor(1e-13, dtype=dt), rho)
    h0 = ax + cp * torch.sin(th) / r - px
    h1 = ay + (-torch.sin(ph)) / r - py
    h2 = az + cp * torch.cos(th) / r - pz
    co, sn = torch.cos(tr), torch.sin(tr)
    X = co * h0 + sn * h1 + 0 * h2
    Y = -sn * h0 + co * h1 + 0 * h2
    Z = 0 * h0 + 0 * h1 + 1 * h2
    sz = torch.where(Z == 0, torch.ones_like(Z), Z)
    u = cst("kF2") * Y / sz + cst("kCy") + e0
    v = cst("kF1") * X / sz + cst("kCx") + e1
    ok = ((Z != 0) & (u >= cst("kMargin")) & (u <= cst("kUHi"))
          & (v >= cst("kMargin")) & (v <= cst("kVHi")))
    xu = (u - cst("kCx")) * cst("kDx")
    yu = (v - cst("kCy")) * cst("kDy")
    ru = torch.sqrt(xu * xu + yu * yu)
    ru2 = ru * ru
    rd = ru / (1 + cst("kK1") * ru2 + cst("kK2") * ru2 * ru2)
    for _ in range(cam.distort_iters):
        rd2 = rd * rd
        fn = rd + cst("kK1") * (rd2 * rd) + cst("kK2") * (rd2 * rd2 * rd) - ru
        fp = (1 + cst("kK1x3") * rd * rd + cst("kK2x5") * (rd2 * rd2))
        rd = rd - fn / fp
    rd2 = rd * rd
    dd = 1 + cst("kK1") * rd2 + cst("kK2") * rd2 * rd2
    dd = torch.where(dd == 0, torch.tensor(1e-13, dtype=dt), dd)
    # the reciprocal taken in double and cast, as torch's CUDA division by a
    # Python scalar takes it
    ud = xu / dd * torch.tensor(1.0 / c[k["kDx"]], dtype=dt) + cst("kCx")
    vd = yu / dd * torch.tensor(1.0 / c[k["kDy"]], dtype=dt) + cst("kCy")
    inside = ((ud >= 0) & (ud <= cst("kWidth")) & (vd >= 0)
              & (vd <= cst("kHeight")) & ok)
    zero = torch.zeros_like(ud)
    return torch.stack([torch.where(inside, ud, zero),
                        torch.where(inside, vd, zero)], dim=1)


def _merge_model(mean, gram, active, pred, si, *, sigma_measure):
    """``measure_merge_kernel``'s arithmetic, one slot a row."""
    s2 = sigma_measure ** 2
    g00, g01, g11 = gram[:, 0, 0] + s2, gram[:, 0, 1] + 0, gram[:, 1, 1] + s2
    a = torch.sqrt(torch.where(g00 < 0, torch.zeros_like(g00), g00))
    b = g01 / torch.where(a == 0, torch.ones_like(a), a)
    t = g11 - b * b
    c = torch.sqrt(torch.where(t < 0, torch.zeros_like(t), t))
    vis = active & (mean[:, 0] != 0) & (mean[:, 1] != 0)
    si_new = torch.stack([torch.stack([a, b], -1),
                          torch.stack([torch.zeros_like(a), c], -1)], -2)
    return (vis, torch.where(vis[:, None], mean, pred),
            torch.where(vis[:, None, None], si_new, si))


@pytest.mark.parametrize("lo,hi", [(0, 16), (3, 9)])
def test_kernel_model_matches_the_plain_version(kept, lo, hi):
    """The projection's model against ``project_all`` (float32: a few ulps
    of ~300 px, the CPU's einsum and true divisions against the model's
    separate roundings and reciprocal products); the merge's model, on the
    plain version's own reductions, equal to its tail."""
    cfg, sets = kept
    tol = (1e-12, 1e-9) if cfg.dtype == "float64" else (1e-6, 1e-3)
    seen = 0
    for state, cache in sets:
        pix = _project_model(cache.sigma, lo=lo, m=hi - lo,
                             state_dim=cfg.state_dim, cam=cfg.camera)
        rpix = project_all(cache.sigma, cfg, lo, hi)
        assert torch.equal(pix == 0, rpix == 0)
        np.testing.assert_allclose(pix.numpy(), rpix.numpy(), *tol)
        ref = full_rows_ref(state, cache, cfg, lo, hi)
        args, kw = _tail_args(cfg, state, cache, lo, hi)
        _equal(dict(zip(("visible", "pred", "si"), _merge_model(*args, **kw))),
               {k: ref[k] for k in ("visible", "pred", "si")})
        seen += int(ref["visible"].sum())
    assert seen > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU route")
    return torch.device("cuda:0")


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_on_the_card_give_the_plain_version(card, dtype):
    """On a card: the kernel route's rows are the plain version's bits."""
    seq, track, _, _ = tfix.load("bench1_arc")
    cfg = SlamConfig(**KW, dtype=dtype)
    sess = SlamSession(cfg, seq, track, device=card)
    sets, real = [], measurement._full_rows

    def keep(state, cache, cfg_, lo, hi):
        sets.append((control.tree_map(torch.clone, state),
                     control.tree_map(torch.clone, cache)))
        return real(state, cache, cfg_, lo, hi)

    sess._graphs = False
    measurement._full_rows = keep
    try:
        for _ in range(13):
            sess.step()
    finally:
        measurement._full_rows = real
    for state, cache in sets:
        _equal(measurement._full_rows(state, cache, cfg, 0,
                                      cfg.max_landmarks),
               full_rows_ref(state, cache, cfg, 0, cfg.max_landmarks))
