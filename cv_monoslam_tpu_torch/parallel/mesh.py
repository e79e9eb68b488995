"""Device mesh and state layouts for the multi-device paths (the counterpart
of ``cv_monoslam_tpu/parallel/mesh.py``; SURVEY.md §2.3).

JAX names its devices in a ``Mesh`` and lets GSPMD insert the collectives
where a sharded array meets a replicated one. Here a mesh is a
``torch.distributed`` process group with one process (rank) per device, and
the sharded code calls its collectives itself — ``all_reduce``,
``broadcast``, ``all_gather`` — outside every kernel: NCCL on ``cuda``,
``gloo`` on the CPU. A mesh of one rank runs the same collectives.

The natural axis of this workload is the landmark axis ("map"): projection,
patch warp, NCC search and innovation columns are independent per landmark.
Two layouts, as in the JAX package (:func:`state_shardings`):

* the landmark layout: each rank runs the per-landmark stages of a frame on
  its block of M / n landmark slots (front-end scaling);
* ``shard_sqrt``: each rank holds the contribution of its block of rows of
  the sqrt factor S to every Gram over S's rows, summed by one
  ``all_reduce`` (large-state scaling), and the joint factorization can run
  row-sharded (:mod:`.dist_chol`).

In both the port keeps the filter state itself replicated on every rank and
shards the work, not the memory: at M = 512 the landmark table is ~1 MB, and
S is recomputed from the replicated joint factor on every rank (see
:mod:`.spmd`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import SlamConfig
from ..filter.state import resolve_device
from ..ops.linalg import AMBIENT

MAP_AXIS = "map"

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
#: NCCL's support for mixing captured and uncaptured launches on one
#: communicator. On (NCCL's default), a graph with a collective inside a
#: conditional body (``control.if_``: ``dist_chol``'s 1e-3 rung) fails to
#: instantiate ("invalid argument") at more than one rank (four H100s,
#: NCCL 2.28): the synchronization the setting adds is not something a body
#: may hold. Off, NCCL leaves it to the caller that no uncaptured launch
#: follows a graph launch still in flight: :meth:`Mesh._settle`.
NCCL_MIXING = "NCCL_GRAPH_MIXING_SUPPORT"
#: the backends a mesh on each device type may run (gloo on cuda only when
#: the process group was opened with it by name: ``launch.init_process``)
_TAKES = {"cuda": ("nccl", "gloo"), "cpu": ("gloo",)}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The map axis (:data:`MAP_AXIS`) of ``size`` ranks: this process is
    ``rank`` of ``group`` and computes on ``device``."""

    group: Any
    rank: int
    size: int
    device: torch.device
    #: the process group's backend: ``nccl`` or ``gloo``
    backend: str = "gloo"
    #: CUDA graphs captured over this mesh's group, by what they compute
    #: (``dist_ba.ba_solve_sharded``'s iterations, ``spmd.run_frames``'
    #: frame steps), and their memory pools
    graphs: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def captures(self) -> bool:
        """Work over this mesh runs as captured CUDA graphs, collectives
        included: NCCL on ``cuda``. ``gloo`` collectives go through the
        host and cannot be captured, so a ``gloo`` mesh runs eagerly."""
        return self.device.type == "cuda" and self.backend == "nccl"

    def block(self, n: int) -> Tuple[int, int]:
        """This rank's contiguous block ``[lo, hi)`` of ``n`` rows (blocks
        differ in size by at most one; equal when ``size`` divides ``n``)."""
        return n * self.rank // self.size, n * (self.rank + 1) // self.size

    def _settle(self) -> None:
        """Before an uncaptured collective of an NCCL mesh, wait until the
        card has finished what was queued, graph launches included (NCCL
        runs with :data:`NCCL_MIXING` off). Inside a capture this does
        nothing: the graph's launches are ordered by its own edges."""
        if self.captures and not torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize(self.device)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks, in place; returns ``t``."""
        self._settle()
        dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
        self._settle()
        dist.broadcast(t, src=dist.get_global_rank(self.group, src),
                       group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each) stacked along dim 0
        in rank order."""
        t = t.contiguous()
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        self._settle()
        dist.all_gather(list(out.chunk(self.size)), t, group=self.group)
        return out


def make_mesh(n_devices: Optional[int] = None, device=None
              ) -> Optional[Mesh]:
    """A mesh over the first ``n_devices`` ranks (default: all) of the
    initialized default process group, computing on ``device`` (``cuda``
    unless the caller names ``cpu``; without CUDA and without a device this
    raises, as every entry point of the port does).

    The device must suit the group's backend (``cpu`` needs ``gloo``;
    ``cuda`` takes NCCL, or ``gloo`` where the group was opened with it by
    name; NCCL with :data:`NCCL_MIXING` off). A smaller mesh is a new
    group of ranks ``0 .. n - 1``:
    every rank of the default group must make the call, and the ranks
    outside the mesh get ``None``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.launch."
                           "init_process (or init_process_group) first")
    dev = resolve_device(device)
    backend = dist.get_backend()
    if backend not in _TAKES[dev.type]:
        raise ValueError(f"a {dev.type} mesh needs the "
                         f"{_BACKEND[dev.type]} backend; the process group "
                         f"runs {backend}")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"{n} devices requested of a process group of "
                         f"{world}")
    group = (dist.group.WORLD if n == world
             else dist.new_group(list(range(n))))
    if dist.get_rank() >= n:
        return None
    if dist.get_world_size(group) != n:
        raise RuntimeError(f"mesh group has {dist.get_world_size(group)} "
                           f"ranks, wanted {n}")
    if backend == "nccl" and dev.index != torch.cuda.current_device():
        # the group's communicator was opened on the current card
        # (``launch.init_process`` makes it the rank's own)
        raise ValueError(f"an NCCL mesh computes on its rank's card "
                         f"cuda:{torch.cuda.current_device()}, not {dev}")
    if backend == "nccl" and os.environ.get(NCCL_MIXING) != "0":
        raise ValueError(f"an NCCL mesh needs {NCCL_MIXING}=0 in the "
                         f"environment before its process group opens "
                         f"(launch.init_process sets it)")
    return Mesh(group, dist.get_rank(group), n, dev, backend)


# ---------------------------------------------------------------------------
# the ambient mesh (jax.sharding.set_mesh / get_abstract_mesh)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def set_mesh(mesh: Mesh, shard_sqrt: bool = False):
    """Make ``mesh`` ambient for the block (``ops.linalg.AMBIENT``): the
    filter's joint update then factorizes across it when
    ``cfg.dist_chol_panel > 0`` (``filter/update._use_dist_chol``), and
    with ``shard_sqrt`` every Gram over S's rows (``ops.linalg.gram_rows``)
    sums the ranks' row blocks (the ``shard_sqrt`` layout's step)."""
    token = AMBIENT.set((mesh, shard_sqrt))
    try:
        yield mesh
    finally:
        AMBIENT.reset(token)


def get_mesh() -> Optional[Mesh]:
    return AMBIENT.get()[0]


def replicate_hint(x):
    """Identity. In the JAX package this constrains ``x`` to be replicated
    so GSPMD does not propagate the landmark sharding onto small scatter
    values; here no compiler partitions anything — every tensor a rank
    holds is whole unless the code sliced it — so there is nothing to
    steer."""
    return x


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Layout:
    """What :func:`..parallel.spmd.sharded_slam_step` splits over the mesh:
    the per-landmark stages (landmark layout) or the Gram contractions over
    S's rows (``shard_sqrt``)."""

    shard_sqrt: bool = False


def check_layout(cfg: SlamConfig, n: int, shard_sqrt: bool = False) -> None:
    """The layouts' preconditions for ``n`` devices (raises ValueError)."""
    if shard_sqrt:
        if cfg.state_dim % n:
            raise ValueError(
                f"shard_sqrt layout needs state_dim {cfg.state_dim} "
                f"divisible by {n} devices (pick max_landmarks ≡ 2 mod 4 "
                f"for 8 devices)")
    elif cfg.max_landmarks % n:
        raise ValueError(
            f"landmark layout needs max_landmarks {cfg.max_landmarks} "
            f"divisible by {n} devices")


def state_shardings(mesh: Mesh, cfg: SlamConfig,
                    shard_sqrt: bool = False) -> Layout:
    """The layout of ``cfg``'s state over ``mesh``.

    Default (front-end scaling): the per-landmark stages run on M / n slots
    per rank; needs M % n == 0. ``shard_sqrt=True`` (large-state scaling):
    every Gram over S's rows is a sum of per-rank row blocks; needs
    D % n == 0 (M ≡ 2 mod 4 gives D % 8 == 0). The two are exclusive in the
    JAX package because M and 6M + 4 are never both divisible by n >= 8."""
    check_layout(cfg, mesh.size, shard_sqrt)
    return Layout(shard_sqrt)
