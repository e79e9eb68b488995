"""The designs of the two recurrence kernels, modelled in numpy.

``csrc/scan_kernels.cu`` runs only on the card, where ``chip_smoke.py``
holds each kernel against its plain version. Here each kernel's algorithm
is modelled step for step in numpy and held, exactly, against the plain
versions (``vision.gftt_greedy_nms_ref``, ``vision.store_slots_ref``) on
seeded inputs of the families that probe the designs' seams:

* ``gftt_greedy_nms``: the clash bitmask (row i, word w: bit b set when
  corner 32w + b comes after i and is within min_dist; only words w >= i/32
  written, rows padded to 32 * nw, every unwritten word poisoned to all
  ones so that a read of one shows), resolved a word at a time (in each
  word, in order, only the alive corners whose row clears another alive
  one; then the kept rows cleared from the later words), ranks from popc
  of the kept words;
* ``store_slots``: the stored records compacted per pass of the block
  (a ballot and a popc prefix per 32 records), then one step per stored
  record: the warp minimum of one priority key per slot, taken as the
  kernel takes it for the table's size (a 32-bit class key and ballots
  for a table in registers, the 64-bit key in two halves for one in
  shared memory).

And the plain versions against the JAX package: the greedy pass through
``gftt_candidates`` (compiled, as the JAX session runs it) at K = 33 and
K = 77, and the slot policy through ``store_features`` on a table that
already holds one landmark id in two slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.filter import lifecycle as jlife
from cv_monoslam_tpu.filter import state as jstate
from cv_monoslam_tpu.frontend import detect as jdetect
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.filter import lifecycle as tlife
from cv_monoslam_tpu_torch.filter import state as tstate
from cv_monoslam_tpu_torch.frontend import detect as tdetect
from cv_monoslam_tpu_torch.ops import vision

FULL = 0xFFFFFFFF
POISON = FULL


# ---------------------------------------------------------------------------
# gftt_greedy_nms: clash bitmask, word-serial resolution, popc ranks
# ---------------------------------------------------------------------------


def clash_bitmask(pix: np.ndarray, k: int, min_dist2: float) -> np.ndarray:
    """Phase A: (32 nw, nw) uint32 words, float32 rounding as the kernel's
    (dx, dy, squares and sum each rounded; no fused multiply-add)."""
    nw = -(-k // 32)
    x, y = pix[:, 0].astype(np.float32), pix[:, 1].astype(np.float32)
    bits = np.zeros((32 * nw, 32 * nw), bool)
    for r0 in range(0, k, 256):                 # rows in slices: K = 4096
        dx = x[r0:r0 + 256, None] - x[None, :]
        dy = y[r0:r0 + 256, None] - y[None, :]
        close = (dx * dx + dy * dy) < np.float32(min_dist2)
        later = np.arange(k)[None, :] > np.arange(r0, r0 + len(dx))[:, None]
        bits[r0:r0 + len(dx), :k] = close & later
    mask = np.packbits(bits, axis=1, bitorder="little").view("<u4").copy()
    row = np.arange(32 * nw)[:, None]
    word = np.arange(nw)[None, :]
    mask[(word < row // 32) | (row >= k)] = POISON   # never written
    return mask


def greedy_model(pix: np.ndarray, cand: np.ndarray, min_dist2: float):
    k = cand.shape[0]
    nw = -(-k // 32)
    mask = clash_bitmask(pix, k, min_dist2)
    padded = np.zeros(32 * nw, bool)
    padded[:k] = cand
    cw = [int(np.dot(padded[32 * w:32 * w + 32].astype(np.uint64),
                     np.uint64(1) << np.arange(32, dtype=np.uint64)))
          for w in range(nw)]
    alive = np.array(cw, np.uint32)     # lane l holds words l + 32 q
    keptw, base, running = [], [], 0
    for w in range(nw):
        a = int(alive[w])               # the owner's word, broadcast
        row = [int(mask[32 * w + b, w]) for b in range(32)]   # lane b's
        c = sum(1 << b for b in range(32) if a >> b & 1 and row[b] & a)
        while c:                        # the corners that clear others
            b = (c & -c).bit_length() - 1
            a &= ~row[b] & FULL
            c &= a & (~1 << b) & FULL
        keptw.append(a)
        base.append(running)
        running += bin(a).count("1")
        rows = [32 * w + b for b in range(32) if a >> b & 1]
        if rows:                        # each lane its own later words
            alive[w + 1:] &= ~np.bitwise_or.reduce(mask[rows, w + 1:],
                                                   axis=0)
    kept = np.zeros(k, bool)
    rank = np.zeros(k, np.int32)
    for i in range(k):
        w, b = divmod(i, 32)
        kept[i] = keptw[w] >> b & 1
        rank[i] = base[w] + bin(keptw[w] & (FULL >> (31 - b))).count("1") - 1
    return kept, rank


def greedy_case(family: str, k: int, seed: int):
    """(pix (K, 2) float32, cand (K,) bool) of one family."""
    rng = np.random.default_rng(seed)
    pix = np.stack([rng.integers(0, 320, k), rng.integers(0, 240, k)],
                   1).astype(np.float32)
    cand = np.arange(k) < k - k // 10
    if family == "identical":
        pix[:] = (17.0, 5.0)
        cand[:] = True
    elif family == "none":
        cand[:] = False
    elif family == "interleaved":
        cand = np.arange(k) % 3 != 1
    elif family == "fractional":
        pix = (pix / 7.0 + rng.normal(0, 0.01, pix.shape)).astype(np.float32)
    return pix, cand


GREEDY_CASES = (
    [("crowded", k) for k in (1, 31, 32, 33, 48, 77, 768, 1025,
                              vision.GREEDY_ONE_BLOCK_MAX_K,
                              vision.GREEDY_ONE_BLOCK_MAX_K + 1,
                              vision.GREEDY_SMEM_MAX_K,
                              vision.GREEDY_SMEM_MAX_K + 1, 4096)]
    + [(fam, k) for fam in ("identical", "none", "interleaved", "fractional")
       for k in (33, 100)])


@pytest.mark.parametrize("family,k", GREEDY_CASES)
def test_greedy_bitmask_model_equals_plain(family, k):
    pix, cand = greedy_case(family, k, seed=k)
    md2 = 100.0 if family != "fractional" else 2.0
    kept, rank = greedy_model(pix, cand, md2)
    want_kept, want_rank = vision.gftt_greedy_nms_ref(
        torch.as_tensor(pix), torch.as_tensor(cand), md2)
    np.testing.assert_array_equal(kept, want_kept.numpy())
    np.testing.assert_array_equal(rank, want_rank.numpy())
    if family == "identical":
        assert kept.tolist() == [True] + [False] * (k - 1)
    if family == "none":
        assert not kept.any() and (rank == -1).all()


def test_greedy_bitmask_is_symmetric_and_padded():
    """close(i, j) == close(j, i) bit for bit, so the rows of the earlier
    corner hold what the plain version's row of the later one tests; and
    the padding rows and lanes stay empty."""
    pix, _ = greedy_case("fractional", 70, seed=3)
    mask = clash_bitmask(pix, 70, 2.0)
    x, y = pix[:, 0], pix[:, 1]
    for i in range(70):
        for j in range(i + 1, 70):
            ji = ((x[j] - x[i]) ** 2 + (y[j] - y[i]) ** 2) < np.float32(2.0)
            assert bool(mask[i, j // 32] >> (j % 32) & 1) == bool(ji)
    assert all(int(mask[i, 2]) >> b & 1 == 0
               for i in range(64, 70) for b in range(70 - 64, 32))


# ---------------------------------------------------------------------------
# store_slots: compaction, one key per slot, one warp minimum per record
# ---------------------------------------------------------------------------


def slot_key(valid: bool, tlid: int, stamp: int, lj: int, slot: int) -> int:
    if not valid:
        return 1 << 62 | slot
    if tlid == lj:
        return slot
    return 2 << 62 | stamp << 31 | slot


def class_key(valid: bool, tlid: int, stamp: int, lj: int) -> int:
    """The same order without the slot, in 32 bits."""
    if not valid:
        return 1
    if tlid == lj:
        return 0
    return stamp + 2


#: the most slots ``store_slots_kernel`` holds in registers (32 a lane)
REG_TABLE_MAX_S = 1024


def pick_slot(valid, tlid, stamp, lj: int) -> int:
    """The slot of record lid ``lj`` as ``store_slots_kernel`` picks it:
    lane l holds slots l + 32 q. A table in registers (S <= 1024): the warp
    minimum of the lanes' smallest 32-bit class keys, then per q in order
    a ballot of the lanes whose slot at q holds it, the first set bit; in
    shared memory: the 64-bit slot keys' minimum in two 32-bit halves (the
    high words, then the low words of the lanes holding the high
    minimum)."""
    s = len(valid)
    if s <= REG_TABLE_MAX_S:
        ck = [class_key(valid[i], int(tlid[i]), int(stamp[i]), lj)
              for i in range(s)]
        lanes = [min([ck[i] for i in range(l, s, 32)] or [FULL])
                 for l in range(32)]
        win = min(lanes)
        assert win < 2 ** 32
        for q in range(-(-s // 32)):
            ballot = [32 * q + l < s and ck[32 * q + l] == win
                      for l in range(32)]
            if any(ballot):
                return 32 * q + ballot.index(True)
        raise AssertionError("no slot holds the minimum")
    keys = [slot_key(valid[i], int(tlid[i]), int(stamp[i]), lj, i)
            for i in range(s)]
    lanes = [min([keys[i] for i in range(l, s, 32)] or [2 ** 64 - 1])
             for l in range(32)]
    hmin = min(k >> 32 for k in lanes)
    lmin = min(k & FULL if k >> 32 == hmin else FULL for k in lanes)
    return (hmin << 32 | lmin) & 0x7FFFFFFF


def store_threads(s: int) -> int:
    """The kernel's block: 1024 threads, 256 where a lane holds 8 to 32
    slots in registers."""
    sq = -(-s // 32)
    return 256 if 4 < sq <= 32 else 1024


def store_model(mask, lid, valid, tlid, stamp, seq):
    m, s = mask.shape[0], valid.shape[0]
    valid, tlid, stamp = valid.copy(), tlid.copy(), stamp.copy()
    src = np.full(s, -1, np.int32)
    slot_out = np.full(m, -7, np.int32)         # -7: never written
    seq = int(seq)
    threads = store_threads(s)
    for start in range(0, m, threads):
        js = np.arange(start, min(start + threads, m))
        stored = mask[js]
        slot_out[js[~stored]] = -1
        # one ballot per 32 records; a record's place = the stored records
        # of the warps before it + popc of its warp's lower lanes
        recs = []
        for w0 in range(0, len(js), 32):
            ballot = stored[w0:w0 + 32]
            for lane in np.flatnonzero(ballot):
                assert len(recs) == (stored[:w0].sum()
                                     + ballot[:lane].sum())
                recs.append(int(js[w0 + lane]))
        for j in recs:
            slot = pick_slot(valid, tlid, stamp, int(lid[j]))
            valid[slot], tlid[slot], stamp[slot] = True, lid[j], seq
            src[slot] = j
            slot_out[j] = slot
            seq += 1
    return slot_out, src, valid, stamp, np.int32(seq)


def store_case(family: str, s: int, seed: int, m: int = 576):
    """(mask, lid, valid, tlid, stamp, seq) of one family."""
    rng = np.random.default_rng(seed)
    valid = np.ones(s, bool)
    tlid = (1000 + np.arange(s)).astype(np.int32)
    stamp = rng.permutation(s).astype(np.int32)
    seq = s
    lid = (2000 + np.arange(m)).astype(np.int32)
    mask = rng.random(m) < 0.1
    if family == "free":
        valid[rng.random(s) < 0.5] = False
    elif family == "lid_thrice":
        pick = rng.choice(m, 3, replace=False)
        lid[pick] = 777
        mask[pick] = True
    elif family == "lid_in_two_slots":
        tlid[[s // 3, s - 1]] = 555
        pick = rng.choice(m, 2, replace=False)
        lid[pick] = 555
        mask[pick] = True
    elif family == "equal_stamps":
        stamp[:] = 5
    elif family == "stamps_near_max":
        stamp = (2 ** 31 - 1 - rng.permutation(s)).astype(np.int32)
        seq = 2 ** 31 - 1 - 2 * m
        stamp[0] = 2 ** 31 - 1
    elif family == "stamps_wide":           # high and low bits disagree
        stamp = rng.integers(0, 2 ** 31 - 1, s).astype(np.int32)
        seq = 2 ** 30
    elif family == "all_stored_empty":
        valid[:] = False
        stamp[:] = 0
        seq = 0
        mask[:] = True
    elif family == "evict":
        mask = rng.random(m) < 0.3
    return mask, lid, valid, tlid, stamp, np.int32(seq)


STORE_CASES = (
    [(fam, s) for fam in ("free", "evict", "lid_thrice", "lid_in_two_slots",
                          "equal_stamps", "stamps_near_max", "stamps_wide",
                          "all_stored_empty")
     for s in (1, 40, 64)]
    + [("evict", 200), ("free", 1100), ("stamps_wide", 1100)])


@pytest.mark.parametrize("family,s", STORE_CASES)
def test_store_key_model_equals_plain(family, s):
    case = store_case(family, s, seed=s)
    want = vision.store_slots_ref(*(torch.as_tensor(a) for a in case))
    got = store_model(*case)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


def test_store_model_passes_of_the_block():
    """More records than the block has threads: several compaction passes,
    the table carried from one to the next."""
    case = store_case("evict", 200, seed=4, m=700)       # 256-thread block
    want = vision.store_slots_ref(*(torch.as_tensor(a) for a in case))
    got = store_model(*case)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


def test_store_key_orders_the_policy():
    """One key decides: dup < free < any valid, stamps then slots; the
    32-bit class key keeps that order but the slot's."""
    dup = slot_key(True, 7, 2 ** 31 - 1, 7, 2 ** 31 - 1)
    free = slot_key(False, 0, 0, 7, 0)
    old = slot_key(True, 8, 0, 7, 0)
    assert dup < free < old
    assert slot_key(True, 8, 3, 7, 9) < slot_key(True, 8, 4, 7, 0)
    assert slot_key(True, 8, 3, 7, 1) < slot_key(True, 8, 3, 7, 2)
    assert slot_key(True, 8, 2 ** 31 - 1, 7, 2 ** 31 - 1) < 1 << 64
    assert (class_key(True, 7, 2 ** 31 - 1, 7) < class_key(False, 0, 0, 7)
            < class_key(True, 8, 0, 7) < class_key(True, 8, 2 ** 31 - 1, 7)
            < 1 << 32)


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [33, 77])
def test_greedy_plain_matches_jax(K):
    """K = 33 takes the JAX package's unrolled chain, K = 77 its blocked
    scan with a padded last block; the port's ``gftt_candidates`` runs the
    plain greedy version on the CPU. Compiled, as the JAX session runs it."""
    rng = np.random.default_rng(K)
    img = np.full((120, 160), 90.0)
    img[30:90, 40:120] = rng.integers(0, 256, (60, 80))
    kw = dict(max_detections=K, min_dist=6.0)
    jp, jk, jr, _ = jax.jit(jdetect.gftt_candidates, static_argnums=1)(
        jnp.asarray(img), JaxConfig(**kw))
    tp, tk, tr, tt = tdetect.gftt_candidates(torch.as_tensor(img),
                                             SlamConfig(**kw))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert 0 < int(tk.sum()) < int((tt > -np.inf).sum())


def test_store_plain_matches_jax_with_a_lid_in_two_slots():
    """The table holds landmark 555 in slots 1 and 4: after two records
    evict the two oldest slots, a record of it goes to slot 1 (the first
    dup) in both packages."""
    S, M, P = 6, 9, 2 * 4 + 1
    rng = np.random.default_rng(12)
    table = dict(
        valid=np.ones(S, bool),
        stamp=np.array([0, 4, 1, 2, 5, 3], np.int32),   # 555's slots newest
        seq=np.int32(S), lid=np.array([200, 555, 202, 203, 555, 205],
                                      np.int32),
        is_loop=rng.random(S) < 0.5,
        n_predict=rng.integers(0, 9, S).astype(np.int32),
        n_match=rng.integers(0, 9, S).astype(np.int32),
        state=rng.normal(size=(S, 6)), sr=rng.normal(size=(S, 6, 6)),
        init_pixel=rng.normal(size=(S, 2)),
        init_trans=rng.normal(size=(S, 3)), init_theta=rng.normal(size=S),
        init_patch=rng.normal(size=(S, P, P)).astype(np.float32),
        xyz=rng.normal(size=(S, 3)))
    rec_lid = 300 + np.arange(M, dtype=np.int32)
    rec_lid[[2, 6]] = 555
    recs = dict(
        lid=rec_lid, is_loop=rng.random(M) < 0.5,
        n_predict=rng.integers(0, 9, M).astype(np.int32),
        n_match=rng.integers(0, 9, M).astype(np.int32),
        state=rng.normal(size=(M, 6)), sr=rng.normal(size=(M, 6, 6)),
        init_pixel=rng.normal(size=(M, 2)),
        init_trans=rng.normal(size=(M, 3)), init_theta=rng.normal(size=M),
        init_patch=rng.normal(size=(M, P, P)).astype(np.float32),
        xyz=rng.normal(size=(M, 3)))
    mask = np.ones(M, bool)
    jt = jstate.StoredTable(**{k: jnp.asarray(v) for k, v in table.items()})
    tt = tstate.StoredTable(**{k: torch.as_tensor(v)
                               for k, v in table.items()})
    want = jlife.store_features(jt, {k: jnp.asarray(v)
                                     for k, v in recs.items()},
                                jnp.asarray(mask))
    got = tlife.store_features(tt, {k: torch.as_tensor(v)
                                    for k, v in recs.items()},
                               torch.as_tensor(mask))
    for k in table:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    slot, *_ = vision.store_slots_ref(
        torch.as_tensor(mask), torch.as_tensor(rec_lid), tt.valid, tt.lid,
        tt.stamp, tt.seq)
    assert int(slot[2]) == 1
