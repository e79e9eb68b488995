"""The chunk machinery of the port's session against the JAX session's.

On the card a chunk is one captured CUDA graph with the filter's gates on
the device (``ops/control.py``), and two host loops became kernels
(``store_slots``, ``gftt_greedy_nms``). Here, on the CPU, every gate is
read on the host and each kernel wrapper takes its plain version; these
tests hold those pieces against the JAX package in float64, from inputs
made with numpy from a seed:

* ``chol_psd_flagged``: the repair ladder's (R, level), level now a device
  tensor, on matrices built to need rungs 0-4, and its host reads;
* ``store_slots`` + the gather of ``store_features`` against the JAX
  ``store_features`` (a ``lax.scan`` of ``lax.cond``) on tables that
  exercise the dup, free and eviction policies;
* the greedy separation against the JAX ``gftt_candidates`` at K <= 64 (its
  unrolled chain) and K > 64 (its blocked scan);
* ``SlamSession.run(chunk=k)`` through ``_dispatch_chunk`` /
  ``_finish_chunk`` against the JAX session: records and each chunk's
  detect flag, pipelined, not pipelined (a watchdog attached) and with
  ``detect_host_gate``;
* a host-read guard (``ops/host_reads.no_host_reads``): ``_dispatch_chunk``
  at the config-1 and implicit settings reads nothing back to the host
  outside ``control.host_bool`` and uploads nothing, so a new host read
  fails here before it fails a capture on the card.

The kernels themselves, the captured graphs and the no-sync dispatch run
only on the card (``chip_smoke.py``, phase chunk graphs).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_monoslam_tpu.api import SlamSession as JaxSession
from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.filter import lifecycle as jlife
from cv_monoslam_tpu.filter import state as jstate
from cv_monoslam_tpu.frontend import detect as jdetect
from cv_monoslam_tpu.io import fixtures as jfix
from cv_monoslam_tpu.ops import linalg as jla
from cv_monoslam_tpu_torch.api import SlamSession
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.filter import lifecycle as tlife
from cv_monoslam_tpu_torch.filter import state as tstate
from cv_monoslam_tpu_torch.frontend import detect as tdetect
from cv_monoslam_tpu_torch.io import fixtures as tfix
from cv_monoslam_tpu_torch.ops import control, vision
from cv_monoslam_tpu_torch.ops import linalg as tla
from cv_monoslam_tpu_torch.ops.host_reads import HostRead, no_host_reads
from cv_monoslam_tpu_torch.utils import profiling
from cv_monoslam_tpu_torch.utils.watchdog import Watchdog

#: config 1's settings at a smaller width, float64
KW = dict(max_landmarks=16, max_new_per_frame=4, max_detections=32,
          dtype="float64")
#: the implicit large-state path at M = 48, float64
IMPLICIT_KW = dict(max_landmarks=48, max_new_per_frame=16, max_detections=96,
                   min_num=24, gate_detection=False, sigma_mode="implicit",
                   min_step_xy=0.005, dtype="float64")


# ---------------------------------------------------------------------------
# the host-read guard
# ---------------------------------------------------------------------------


def test_guard_catches_host_reads_and_uploads():
    x = torch.arange(4.0)
    with no_host_reads():
        for bad in (lambda: bool(x.sum()), lambda: int(x[0]),
                    lambda: x.sum().item(), lambda: x.tolist(),
                    lambda: x[torch.tensor(1)],
                    lambda: torch.tensor([1.0], device="cpu"),
                    lambda: x.__setitem__(0, 2.0),
                    lambda: torch.nonzero(x),
                    lambda: torch.linalg.eigh(torch.eye(3))):
            with pytest.raises(HostRead):
                bad()
        assert control.host_bool(x.sum() > 0)
        x[1:] = 0.0                         # a slice fill: no upload
        y = x[torch.tensor([1, 2])]         # a 1-d index: stays put
    assert y.shape == (2,)


# ---------------------------------------------------------------------------
# the repair ladder
# ---------------------------------------------------------------------------


def _spd(n, eigs, seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(n, n)))
    return (q * np.asarray(eigs)) @ q.T


# smallest eigenvalue -> the rung that repairs it (jitter 1e-6, scale 1)
@pytest.mark.parametrize("lam_min,level", [
    (0.2, 0), (-4e-7, 1), (-4e-5, 2), (-4e-4, 3), (-0.2, 4)])
def test_chol_psd_flagged_rungs_match_jax(lam_min, level, monkeypatch):
    g = _spd(7, np.linspace(lam_min, 1.0, 7), seed=11)
    reads = []
    real = control.host_bool
    monkeypatch.setattr(control, "host_bool",
                        lambda p: reads.append(1) or real(p))
    with no_host_reads():
        r, lv = tla.chol_psd_flagged(torch.as_tensor(g), 1e-6)
    jr, jlv = jla.chol_psd_flagged(jnp.asarray(g), 1e-6)
    assert isinstance(lv, torch.Tensor) and lv.dim() == 0
    assert lv.dtype == torch.int32
    assert int(lv) == int(jlv) == level
    # eager: one read per rung tried, one for a clean factorization
    assert len(reads) == min(level + 1, 5)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-10,
                               atol=1e-10)
    assert r.is_contiguous()


# ---------------------------------------------------------------------------
# store_features: the slot policy + one gather per field
# ---------------------------------------------------------------------------


def _tables(case: str, S: int, M: int, rng):
    """(stored table arrays, records, mask) for a store of ``case``."""
    P = 2 * 4 + 1
    valid = np.zeros(S, bool)
    lid = np.zeros(S, np.int32)
    stamp = np.zeros(S, np.int32)
    if case == "free":
        valid[[0, 2]] = True
        lid[[0, 2]] = [101, 102]
        stamp[[0, 2]] = [0, 1]
        seq = 2
    else:                                     # full table: dup and eviction
        valid[:] = True
        lid[:] = 200 + np.arange(S)
        stamp[:] = rng.permutation(S)
        seq = S
    table = dict(
        valid=valid, stamp=stamp, seq=np.int32(seq), lid=lid,
        is_loop=rng.random(S) < 0.5,
        n_predict=rng.integers(0, 9, S).astype(np.int32),
        n_match=rng.integers(0, 9, S).astype(np.int32),
        state=rng.normal(size=(S, 6)), sr=rng.normal(size=(S, 6, 6)),
        init_pixel=rng.normal(size=(S, 2)),
        init_trans=rng.normal(size=(S, 3)), init_theta=rng.normal(size=S),
        init_patch=rng.normal(size=(S, P, P)).astype(np.float32),
        xyz=rng.normal(size=(S, 3)))
    rec_lid = 300 + np.arange(M, dtype=np.int32)
    if case == "dup":
        rec_lid[[1, 3]] = lid[[2, 0]]         # refresh two stored landmarks
        rec_lid[5] = rec_lid[1]               # and one twice in the batch
    recs = dict(
        lid=rec_lid, is_loop=rng.random(M) < 0.5,
        n_predict=rng.integers(0, 9, M).astype(np.int32),
        n_match=rng.integers(0, 9, M).astype(np.int32),
        state=rng.normal(size=(M, 6)), sr=rng.normal(size=(M, 6, 6)),
        init_pixel=rng.normal(size=(M, 2)),
        init_trans=rng.normal(size=(M, 3)), init_theta=rng.normal(size=M),
        init_patch=rng.normal(size=(M, P, P)).astype(np.float32),
        xyz=rng.normal(size=(M, 3)))
    mask = rng.random(M) < 0.7
    mask[[1, 3, 5]] = True
    return table, recs, mask


@pytest.mark.parametrize("case", ["free", "dup", "evict"])
def test_store_features_matches_jax(case):
    S, M = 6, 9
    table, recs, mask = _tables(case, S, M, np.random.default_rng(7))
    jt = jstate.StoredTable(**{k: jnp.asarray(v) for k, v in table.items()})
    tt = tstate.StoredTable(**{k: torch.as_tensor(v)
                               for k, v in table.items()})
    want = jlife.store_features(jt, {k: jnp.asarray(v)
                                     for k, v in recs.items()},
                                jnp.asarray(mask))
    with no_host_reads():
        got = tlife.store_features(tt, {k: torch.as_tensor(v)
                                        for k, v in recs.items()},
                                   torch.as_tensor(mask))
    for k in table:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    # the policy alone: each stored record's slot, in record order
    slot, src, *_ = vision.store_slots(
        torch.as_tensor(mask), torch.as_tensor(recs["lid"]),
        tt.valid, tt.lid, tt.stamp, tt.seq)
    assert (slot.numpy() >= 0).tolist() == mask.tolist()
    for s_ in range(S):
        j = int(src[s_])
        if j >= 0:
            assert int(slot[j]) == s_ and int(got.lid[s_]) == recs["lid"][j]


# ---------------------------------------------------------------------------
# the greedy separation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [32, 96])
def test_greedy_separation_matches_jax(K):
    """K = 32 takes the JAX package's unrolled chain, K = 96 its blocked
    scan; corners crowd a small textured patch so the min-distance test
    removes many. The JAX function is compiled, as the JAX session runs
    it (op by op, its unrolled chain takes seconds); its responses round
    otherwise than op by op, so they are not compared."""
    rng = np.random.default_rng(K)
    img = np.full((120, 160), 90.0)
    img[30:90, 40:120] = rng.integers(0, 256, (60, 80))
    kw = dict(max_detections=K, min_dist=6.0)
    jp, jk, jr, _ = jax.jit(jdetect.gftt_candidates, static_argnums=1)(
        jnp.asarray(img), JaxConfig(**kw))
    with no_host_reads():
        tp, tk, tr, tt = tdetect.gftt_candidates(torch.as_tensor(img),
                                                 SlamConfig(**kw))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert 0 < int(tk.sum()) < int((tt > -np.inf).sum())


# ---------------------------------------------------------------------------
# the session's chunks against the JAX session's
# ---------------------------------------------------------------------------


def _spy(sess, calls):
    """Record the order of dispatches and finishes, and each chunk's detect
    flag (JAX: ``_chunk_fn``'s ``detect``; the port: ``chunk_detect``)."""
    for name in ("_dispatch_chunk", "_finish_chunk"):
        real = getattr(sess, name)

        def wrapped(*a, _real=real, _name=name):
            out = _real(*a)
            calls.append(_name[1:].split("_")[0])
            return out

        setattr(sess, name, wrapped)


def _assert_same_records(ts, js, n):
    assert len(ts.records) == len(js.records) == n
    for a, b in zip(ts.records, js.records):
        assert (a.frame, a.n_map, a.n_visible, a.n_matched, a.redirected) \
            == (b.frame, b.n_map, b.n_visible, b.n_matched, b.redirected)
        assert (a.n_repairs, a.n_escalations, a.n_skipped) == \
            (b.n_repairs, b.n_escalations, b.n_skipped)
    assert np.abs(ts.trajectory - js.trajectory).max() <= 1e-6


@pytest.fixture(scope="module")
def jax_run():
    seq, track, _, _ = jfix.load("bench1_arc")
    js = JaxSession(JaxConfig(**KW), seq, track)
    js.run(n_frames=12, chunk=4)
    return js


@pytest.mark.parametrize("observer", [None, "watchdog"])
def test_run_chunks_follow_jax_session(jax_run, observer):
    """No observer: chunk i + 1 is dispatched before chunk i is finished
    (the JAX ``run``'s pipelining); a watchdog attached: each chunk is
    finished before the next is dispatched. The records are the same."""
    seq, track, _, _ = tfix.load("bench1_arc")
    wd = Watchdog(SlamConfig(**KW), check_every=1) if observer else None
    ts = SlamSession(SlamConfig(**KW), seq, track, device="cpu",
                     watchdog=wd)
    calls = []
    _spy(ts, calls)
    ts.run(n_frames=12, chunk=4)
    _assert_same_records(ts, jax_run, 12)
    assert ts.chunk_detect == [True] * 3
    if observer:
        assert calls == ["dispatch", "finish"] * 3
    else:
        assert calls == ["dispatch", "dispatch", "finish", "dispatch",
                         "finish", "finish"]
    tot = profiling.totals()
    assert tot["counters"]["frames"] == 12
    assert tot["counters"]["chunks_detect"] == 3
    assert tot["spans"]["slam.dispatch"]["count"] == 3
    assert tot["spans"]["slam.finish"]["count"] == 3
    assert tot["spans"]["slam.run"]["total_ns"] > 0


def test_host_gated_chunks_follow_jax_session():
    """``detect_host_gate`` without a margin: not pipelined, each chunk's
    detect flag read from the chunk just finished, as the JAX session
    picks it."""
    jseq, jtrack, _, _ = jfix.load("bench3_grid", min_step_xy=0.005)
    tseq, ttrack, _, _ = tfix.load("bench3_grid", min_step_xy=0.005)
    js = JaxSession(JaxConfig(**IMPLICIT_KW), jseq, jtrack)
    jflags = []
    real = js._chunk_fn
    js._chunk_fn = lambda k, detect=True: (jflags.append(bool(detect))
                                           or real(k, detect))
    ts = SlamSession(SlamConfig(**IMPLICIT_KW), tseq, ttrack, device="cpu")
    calls = []
    _spy(ts, calls)
    for sess in (js, ts):
        sess.detect_host_gate = True
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            sess.run(n_frames=12, chunk=4)
    _assert_same_records(ts, js, 12)
    assert ts.chunk_detect == jflags == [True, False, False]
    assert calls == ["dispatch", "finish"] * 3


# ---------------------------------------------------------------------------
# _dispatch_chunk reads nothing back and uploads nothing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(KW, dtype="float32"),
                                dict(IMPLICIT_KW, dtype="float32")],
                         ids=["config1", "implicit"])
def test_dispatch_chunk_makes_no_host_read(kw):
    """After one chunk and a warm-up frame (both sides of every gate, as
    before a capture: it builds the per-device constants of branches the
    chunk did not take), a dispatch through both detect variants runs
    under the guard: every gate goes through ``control`` and every
    constant comes from its cache."""
    name, extra = (("bench3_grid", dict(min_step_xy=0.005))
                   if kw.get("sigma_mode") == "implicit"
                   else ("bench1_arc", {}))
    seq, track, _, _ = tfix.load(name, **extra)
    ts = SlamSession(SlamConfig(**kw), seq, track, device="cpu")
    ts.step_chunk(4)
    imgs = torch.from_numpy(ts._stack_window(ts.counter, 1))
    with control.warmup():          # thrown away, as the capture's warm-up
        ts._frames(control.tree_map(torch.clone, ts.state), imgs,
                   ts._odo[ts.counter - 1:ts.counter + 1], True)
    ts.detect_host_gate = True
    for matched in (0, 10 ** 6):              # a detect and a tracking chunk
        ts._last_matched = matched
        with no_host_reads():
            pending = ts._dispatch_chunk(4)
        recs = ts._finish_chunk(pending)
        assert len(recs) == 4 and np.all(np.isfinite(ts.trajectory))
    assert ts.chunk_detect == [True, True, False]


# ---------------------------------------------------------------------------
# ops/control.py on the CPU
# ---------------------------------------------------------------------------


def test_cond_and_if_read_the_host_once_and_run_one_branch():
    x = torch.arange(3.0)
    ran = []
    out = control.cond(x.sum() > 0, lambda a: ran.append("t") or a + 1,
                       lambda a: ran.append("f") or a - 1, (x,))
    assert ran == ["t"] and out.tolist() == [1.0, 2.0, 3.0]
    assert control.if_(x.sum() < 0, lambda: ran.append("body")) is False
    assert ran == ["t"]
    with control.warmup():                      # both branches, every body
        out = control.cond(x.sum() < 0, lambda a: ran.append("t") or a + 1,
                           lambda a: ran.append("f") or a - 1, (x,))
        assert control.if_(x.sum() < 0, lambda: ran.append("b")) is None
    assert ran == ["t", "t", "f", "b"] and out.tolist() == [-1.0, 0.0, 1.0]


def test_launch_counting_and_constants_under_a_capture_record():
    """Every kernel adds one to its own slot of the device counters, which
    the wrapper hands it and ``device_counts`` reads; in warm-up it gets a
    scratch slot instead, so warm-up launches do not count. The counters
    are built at the first call (the warm-up frame before every capture),
    and served inside a capture from the cache. A constant first built
    inside a capture is refused."""
    vision.reset_device_counts("cpu")
    for i, name in enumerate(vision.KERNELS):
        slot = vision._device_counter("cpu", name)
        slot += i + 1                  # what the kernel's thread 0 adds
        with control.warmup():
            scratch = vision._device_counter("cpu", name)
        assert scratch.data_ptr() != slot.data_ptr()
        scratch += 100
    assert vision.device_counts("cpu") == {
        name: i + 1 for i, name in enumerate(vision.KERNELS)}
    vision.reset_device_counts("cpu")
    assert set(vision.device_counts("cpu").values()) == {0}
    defaults = control.constant((0.0, 0.0, 0.0, 0.0, 0.0, 1.0),
                                torch.float64, "cpu")
    with control.capture(None):
        assert vision._device_counter("cpu", "store_slots").numel() == 1
        with pytest.raises(RuntimeError, match="inside a CUDA graph"):
            control.constant((1.5, 2.5, 3.5, 4.5, 5.5, 6.5, 7.5),
                             torch.float64, "cpu")
        # a constant built before the capture is served from the cache
        assert control.constant((0.0, 0.0, 0.0, 0.0, 0.0, 1.0),
                                torch.float64, "cpu") is defaults


def test_tree_map_and_leaves_cover_the_filter_state():
    cfg = SlamConfig(**KW)
    st = tstate.init_state(cfg, device="cpu")
    leaves = control.leaves(st)
    assert len(leaves) == 2 + 16 + 14 + 5   # x, S, lm, stored, scalars
    copy = control.tree_map(torch.clone, st)
    assert all(a is not b and torch.equal(a, b)
               for a, b in zip(leaves, control.leaves(copy)))


@pytest.mark.parametrize("device,backend,shard_sqrt,panel,graphs", [
    ("cuda", "nccl", False, 0, True), ("cuda", "nccl", True, 0, True),
    ("cuda", "nccl", False, 64, True), ("cuda", "nccl", True, 64, True),
    ("cuda", "gloo", False, 64, False), ("cuda", "gloo", True, 0, False),
    ("cpu", "gloo", True, 64, False)])
def test_graph_route_under_a_mesh(device, backend, shard_sqrt, panel,
                                  graphs):
    """``_graph_route`` with a stub mesh: an NCCL mesh on the card keeps
    the graph route in both layouts, with the distributed factorization
    on or off; a ``gloo`` mesh (collectives through the host, which no
    graph can capture) and the CPU take the eager route."""
    import types

    from cv_monoslam_tpu_torch.parallel.mesh import Mesh, set_mesh

    cfg = SlamConfig(**IMPLICIT_KW, dist_chol_panel=panel)
    sess = types.SimpleNamespace(_graphs=True, cfg=cfg,
                                 device=torch.device(device))
    mesh = Mesh(group=None, rank=0, size=1, device=torch.device(device),
                backend=backend)
    assert mesh.captures == graphs
    assert SlamSession._graph_route(sess) == (device == "cuda")
    with set_mesh(mesh, shard_sqrt=shard_sqrt):
        assert SlamSession._graph_route(sess) == graphs
        sess._graphs = False
        assert not SlamSession._graph_route(sess)


def test_write_back_copies_a_state_into_the_buffers():
    _write_back = control.write_back
    cfg = SlamConfig(**KW)
    buf = tstate.init_state(cfg, device="cpu")
    new = tstate.replace(control.tree_map(torch.clone, buf),
                         x=buf.x + 1.0, frame=buf.frame + 3)
    # a field that is a view of another buffer is cloned before the copies
    new = tstate.replace(new, n_repairs=buf.n_skipped.view(()))
    _write_back(buf, new)
    assert float(buf.x[-1]) == 1.0 and int(buf.frame) == 4
    with pytest.raises(ValueError, match="does not fit"):
        _write_back(buf, tstate.replace(new, x=new.x[:-1]))
