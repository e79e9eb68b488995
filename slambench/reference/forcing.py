"""Knife edges: where the reference may take over the program's decision.

The reference steps a frame from the program's own state with the kernels'
plain versions, whose scores differ from the kernels' by rounding. A
decision whose reading lies within such a step of its threshold can then
go the other way in the two, and a flipped match or corner moves the pose
far more than the arithmetic does. So while :func:`following` holds the
program's decisions of the frame, the reference takes over one of them
where, and only where, its own reading lies within the tolerance below of
the threshold that decides it:

* a match accepted or refused: the NCC peak within ``EPS_SCORE`` of
  ``threshold_match_patch``;
* the peak's offset: the program's integer offset scores within
  ``EPS_SCORE`` of the reference's best;
* a new corner kept or dropped by the proximity filter: its squared
  distance to a landmark's pixel within ``TOL_D2`` (relative) of
  ``min_dist2``; every combination of such flips (at most
  ``MAX_AMBIGUOUS`` corners) is tried, and the program's set of new
  corners is taken where one combination gives it;
* a landmark deleted or kept: a border test within ``TOL_PX`` pixels of
  ``dist_to_border``, or ``rho`` within ``TOL_RHO`` of ``delete_rho_min``.

Every other difference stays the reference's own, and shows in the gaps
that ``slambench/check.py`` compares. :class:`Following` counts what was
taken over.

With ``take_all`` (the frames of a chunk after its first, whose state
before them the program does not show) the reference takes every match
decision, measured pixel and deletion of the program's, knife edge or not,
and counts them as ``adopted``: it then follows the program's map through
the chunk, and what differs is the arithmetic of the filter and of the map
it carries. The matcher's own decisions are judged on the chunk's first
frame.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
from typing import Iterator, Optional

import torch

EPS_SCORE = 1e-3
TOL_D2 = 5e-3
TOL_PX = 1e-2
TOL_RHO = 1e-4
MAX_AMBIGUOUS = 3


@dataclasses.dataclass
class Following:
    """The program's decisions of one frame (its state before the frame
    and its outputs after it) and what the reference took over."""

    lid_before: torch.Tensor          # (M,) int32
    active_before: torch.Tensor       # (M,) bool
    lid_after: torch.Tensor           # (M,) int32
    active_after: torch.Tensor        # (M,) bool
    matched_after: torch.Tensor       # (M,) bool
    match_px_after: torch.Tensor      # (M, 2)
    #: (k, 2) pixels of the corners the program integrated this frame, in
    #: the order of their ids; None where they are not known
    new_corners: Optional[torch.Tensor]
    #: take every decision of the program's, not only those at knife edges
    take_all: bool = False
    taken: dict = dataclasses.field(default_factory=lambda: dict(
        match_flips=0, offset_ties=0, corner_sets=0, deletions=0))
    refused: dict = dataclasses.field(default_factory=lambda: dict(
        match_flips=0, offset_ties=0, corner_sets=0, deletions=0))
    adopted: dict = dataclasses.field(default_factory=lambda: dict(
        match_flips=0, offset_ties=0, corner_sets=0, deletions=0))

    @property
    def kept(self) -> torch.Tensor:
        """Slots that hold the same landmark before and after the frame."""
        return (self.active_before & self.active_after
                & (self.lid_before == self.lid_after))


_FOLLOWING: contextvars.ContextVar = contextvars.ContextVar(
    "following", default=None)


@contextlib.contextmanager
def following(f: Following) -> Iterator[Following]:
    token = _FOLLOWING.set(f)
    try:
        yield f
    finally:
        _FOLLOWING.reset(token)


def association(accepted, best, cfg):
    """The matcher's accept / refuse decisions, with the program's taken
    over at knife edges."""
    f = _FOLLOWING.get()
    if f is None:
        return accepted
    dev = accepted.device
    kept = f.kept.to(dev)
    prog = f.matched_after.to(dev)
    flip = kept & (accepted != prog)
    if f.take_all:
        f.adopted["match_flips"] += int(flip.sum())
        return torch.where(flip, prog, accepted)
    edge = torch.abs(best - cfg.threshold_match_patch) <= EPS_SCORE
    f.taken["match_flips"] += int((flip & edge).sum())
    f.refused["match_flips"] += int((flip & ~edge).sum())
    return torch.where(flip & edge, prog, accepted)


def offset(accepted, mu, mv, masked, base, by, bx, best, parabolic, cfg):
    """The peak's integer offset, the program's where it scores within
    ``EPS_SCORE`` of the reference's best: ``(mu, mv)``."""
    f = _FOLLOWING.get()
    if f is None:
        return mu, mv
    hp = cfg.hp_match
    w1 = masked.shape[-1]
    dev = mu.device
    both = f.kept.to(dev) & f.matched_after.to(dev) & accepted
    ppx = f.match_px_after.to(dev, mu.dtype)
    if f.take_all:
        f.adopted["offset_ties"] += int((both & ((ppx[:, 0] != mu)
                                                 | (ppx[:, 1] != mv))).sum())
        return (torch.where(both, ppx[:, 0], mu),
                torch.where(both, ppx[:, 1], mv))
    pbx = torch.round(ppx[:, 0]).to(torch.int64) - base[:, 0] - hp
    pby = torch.round(ppx[:, 1]).to(torch.int64) - base[:, 1] - hp
    inside = (pbx >= 0) & (pbx < w1) & (pby >= 0) & (pby < w1)
    other = both & inside & ((pbx != bx) | (pby != by))
    far = both & ~inside
    pbx_c = torch.clamp(pbx, 0, w1 - 1)
    pby_c = torch.clamp(pby, 0, w1 - 1)
    ar = torch.arange(masked.shape[0], device=dev)
    s_prog = masked[ar, pby_c, pbx_c]
    tie = other & (s_prog >= best - EPS_SCORE)
    f.taken["offset_ties"] += int(tie.sum())
    f.refused["offset_ties"] += int((other & ~tie).sum() + far.sum())
    if not bool(tie.any()):
        return mu, mv
    tu = (base[:, 0] + pbx_c + hp).to(mu.dtype)
    tv = (base[:, 1] + pby_c + hp).to(mv.dtype)
    if cfg.subpixel_match:
        tu = tu + parabolic(masked, pby_c, pbx_c, axis=1)
        tv = tv + parabolic(masked, pby_c, pbx_c, axis=0)
    return torch.where(tie, tu, mu), torch.where(tie, tv, mv)


def proximity_variants(pix, fok, avoid, avoid_valid, n_matched, cfg):
    """The proximity filter's verdicts to try, the reference's own first:
    one more for each combination of flips of corners whose squared
    distance lies within ``TOL_D2`` of ``min_dist2``."""
    f = _FOLLOWING.get()
    if f is None or f.new_corners is None or not bool(n_matched > 0):
        return [fok]
    nz = avoid_valid & torch.any(avoid != 0.0, dim=-1)
    d2 = torch.sum((pix[:, None, :].to(avoid.dtype) - avoid[None, :, :])
                   ** 2, dim=-1)
    amb = torch.any((torch.abs(d2 - cfg.min_dist2)
                     <= TOL_D2 * cfg.min_dist2) & nz[None, :], dim=1)
    idx = torch.nonzero(amb)[:, 0].tolist()[:MAX_AMBIGUOUS]
    out = [fok]
    for r in range(1, len(idx) + 1):
        for combo in itertools.combinations(idx, r):
            v = fok.clone()
            for i in combo:
                v[i] = ~v[i]
            out.append(v)
    return out


def pick_corners(options):
    """``options``: ``(corners, valid)`` of each verdict, the reference's
    own first. Returns the program's where one of them gives its set of
    new corners, else the reference's own."""
    f = _FOLLOWING.get()
    own = options[0]
    if f is None or f.new_corners is None:
        return own
    want = f.new_corners

    def chosen(opt):
        corners, valid = opt
        return corners[valid].to(want.dtype)

    if _same(chosen(own), want):
        return own
    for opt in options[1:]:
        if _same(chosen(opt), want):
            (f.adopted if f.take_all else f.taken)["corner_sets"] += 1
            return opt
    f.refused["corner_sets"] += 1
    return own


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))


def deletions(delete, store, px, py, mx, my, matched, rho, hlr_z, starved,
              cfg):
    """The deletion pass's verdicts, the program's taken over for slots
    whose border or depth test lies at a knife edge: ``(delete, store)``."""
    f = _FOLLOWING.get()
    if f is None:
        return delete, store
    dev = delete.device
    b = cfg.dist_to_border
    Wd, Hd = cfg.camera.width, cfg.camera.height

    def near(v, edge):
        return torch.abs(v - edge) <= TOL_PX

    border = (near(px, b) | near(py, b) | near(Wd - px, b) | near(Hd - py, b)
              | (matched & (near(mx, b) | near(my, b) | near(Wd - mx, b)
                            | near(Hd - my, b))))
    depth = (torch.abs(rho - cfg.delete_rho_min) <= TOL_RHO) \
        | (torch.abs(hlr_z) <= TOL_RHO)
    prog = f.active_before.to(dev) & ~f.kept.to(dev)
    flip = f.active_before.to(dev) & (delete != prog)
    edge = border | depth
    if f.take_all:
        f.adopted["deletions"] += int(flip.sum())
        edge = torch.ones_like(edge)
    else:
        f.taken["deletions"] += int((flip & edge).sum())
        f.refused["deletions"] += int((flip & ~edge).sum())
    take = flip & edge
    delete = torch.where(take, prog, delete)
    store = torch.where(take, prog & matched & border & ~starved, store)
    return delete, store
