"""Start the ranks of a mesh: the counterpart of ``jax.distributed.initialize``
(``scripts/dist_ba_mp.py:41-45``) and of the fake CPU devices that
``tests/conftest.py`` gives the JAX package.

One process per device. The rendezvous is a file (``file://``), so nothing
listens on the network. On ``cuda`` every NCCL rank needs a card of its
own: NCCL refuses two ranks on one card ("Duplicate GPU detected"), so
:func:`init_process` raises when there are more ranks than cards instead of
finding out inside NCCL. Several ranks can share one card only through
``gloo``, asked for by name.

:func:`spawn` starts the ranks with ``torch.multiprocessing`` and hands their
results back as numpy. A spawned rank imports the module that holds the
function it runs, so that function must live in this package (a test module
imports JAX). :func:`run_cases` lets one set of ranks serve many calls on
meshes of several sizes, with numpy arguments moved to each rank's device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..filter.state import resolve_device
from .mesh import _BACKEND, make_mesh


#: seconds a collective may wait before it fails instead of hanging
COLLECTIVE_TIMEOUT_S = 60.0


def init_process(rank: int, world: int, device, init_file: str,
                 backend: str | None = None) -> torch.device:
    """Join the default process group as ``rank`` of ``world``: NCCL for
    ``cuda`` (card ``rank``), ``gloo`` for ``cpu``, rendezvous through the
    file ``init_file`` (the same path on every rank; it must not exist
    yet). A collective that waits longer than :data:`COLLECTIVE_TIMEOUT_S`
    fails instead of hanging. Returns this rank's device.

    ``backend="gloo"`` with ``cuda`` is asked for by name, never chosen:
    ``gloo`` moves CUDA tensors through the host, and every rank then
    computes on card ``rank % cards`` — several ranks may share one card,
    which NCCL refuses."""
    dev = resolve_device(device)
    backend = backend or _BACKEND[dev.type]
    kw = {}
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and world > cards:
            raise RuntimeError(
                f"NCCL needs one card per rank: {world} ranks, {cards} "
                f"card(s)")
        if cards == 0:
            raise RuntimeError("no CUDA device for a cuda rank")
        dev = torch.device("cuda", rank % cards)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=f"file://{os.path.abspath(init_file)}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S), **kw)
    return dev


def spawn(fn: Callable, world: int, device, *args,
          timeout_s: float = 300.0, backend: str | None = None) -> list:
    """Run ``fn(rank_device, *args)`` on ``world`` new processes joined in
    one process group (``backend`` as for :func:`init_process`); returns
    the ranks' results in rank order, tensors converted to numpy (also
    inside tuples, lists, dicts and dataclasses).

    Raises with the rank's traceback as soon as one rank fails, and when
    the ranks have not all finished within ``timeout_s``; either way every
    rank still alive is killed. On ``cuda`` the kernels are built first, so
    the ranks do not race on the build directory."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops import _build

        _build.build()
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout_s
    out = [None] * world
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world, dev.type, init_file,
                                   backend, fn, args, results))
                 for rank in range(world)]
        for p in procs:
            p.start()
        try:
            pending = set(range(world))
            while pending:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(pending)} did not finish within "
                        f"{timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r in pending
                            if procs[r].exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                out[rank] = payload
                pending.discard(rank)
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10.0)
    return out


def _rank_main(rank, world, device, init_file, backend, fn, args, results):
    try:
        if device == "cpu":
            # the ranks are the parallelism: one thread each, so that
            # several ranks do not oversubscribe the host's cores
            torch.set_num_threads(1)
        dev = init_process(rank, world, device, init_file, backend=backend)
        try:
            res = to_numpy(fn(dev, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, res))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise


# ---------------------------------------------------------------------------
# many calls on one set of ranks
#
# The multi-rank tests use this: a spawned rank imports the module of the
# function it runs, and a test module imports JAX, so the driver of their
# cases lives here. No product path calls it.
# ---------------------------------------------------------------------------


class MESH:
    """Placeholder in :func:`run_cases` arguments for the case's mesh (a
    class pickles by name, so ``is`` holds in the spawned rank)."""


@dataclasses.dataclass(frozen=True)
class Rows:
    """:func:`run_cases` argument that each rank receives as its own block
    of rows of ``array`` (``Mesh.block``)."""

    array: np.ndarray


def run_cases(device: torch.device,
              cases: Sequence[tuple]) -> list:
    """Run ``(n_devices, fn, args)`` cases in order, each as ``fn(*args)``
    on a mesh of the first ``n_devices`` ranks, and return their results (a
    rank outside a case's mesh records ``None``). In ``args``, :data:`MESH`
    stands for the mesh, :class:`Rows` for this rank's rows of an array,
    and numpy arrays, also inside tuples, lists, dicts and dataclasses,
    arrive as tensors on ``device``. Every rank must run the same cases:
    a smaller mesh is a new process group, made collectively."""
    meshes, out = {}, []
    for n, fn, args in cases:
        if n not in meshes:
            meshes[n] = make_mesh(n, device)
        mesh = meshes[n]
        if mesh is None:
            out.append(None)
            continue

        def arg(a):
            if a is MESH:
                return mesh
            if isinstance(a, Rows):
                lo, hi = mesh.block(a.array.shape[0])
                return to_device(a.array[lo:hi], mesh.device)
            return to_device(a, mesh.device)

        out.append(fn(*[arg(a) for a in args]))
    return out


def to_device(obj: Any, device: torch.device) -> Any:
    """numpy arrays -> tensors on ``device`` (dtype kept), recursively."""
    if isinstance(obj, np.ndarray):
        return torch.as_tensor(np.array(obj), device=device)
    return _map(obj, lambda v: to_device(v, device))


def to_numpy(obj: Any) -> Any:
    """Tensors -> numpy arrays (host copies), recursively."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return _map(obj, to_numpy)


def _map(obj, f):
    if isinstance(obj, (list, tuple)):
        return type(obj)(f(v) for v in obj)
    if isinstance(obj, dict):
        return {k: f(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            fl.name: f(getattr(obj, fl.name))
            for fl in dataclasses.fields(obj) if fl.init})
    return obj
