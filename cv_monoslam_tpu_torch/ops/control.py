"""Control flow that can stay on the device: the port's ``lax.cond``.

The JAX engine keeps every gate of a frame on the device (``lax.cond``),
so a compiled chunk never reads the host. Here a gate is

* :func:`cond` ``(pred, true_fn, false_fn, operands)`` — the two branches
  return the same structure of tensors;
* :func:`if_` ``(pred, body)`` — a body that writes in place into tensors
  made before it.

What a gate does depends on where it runs:

* **inside the capture of a CUDA graph** (:func:`capture`, used by
  ``api.SlamSession._chunk_fn``): it opens IF conditional nodes on the
  0-d bool device tensor ``pred``. PyTorch 2.11 has no API for them, so
  ``csrc/conditional.cu`` adds them with the CUDA runtime's graph API, the
  way later PyTorch versions do (``CUDAGraph.begin_capture_to_if_node``):
  a kernel sets the node's handle from ``pred`` when the graph runs, and
  the body is captured on a stream of its own (one per nesting depth)
  into the node's body graph, its allocations going to the capture's
  body pool. :func:`cond` takes two nodes, one on ``pred`` and one on
  ``~pred``; the true branch's outputs are made inside its node and the
  false branch copies its outputs into them, because what follows the
  node has fixed addresses. Nothing is read back to the host;
* **in warm-up** (:func:`warmup`, the eager frame run before a capture):
  both branches and every body run, each on the stream its nodes will be
  captured on, so that no library handle, workspace or kernel module is
  first created inside a conditional body; the warm-up's results are
  thrown away;
* **otherwise** (the CPU, or eager on the card): ``pred`` is read on the
  host (:func:`host_bool`, one device sync on the card) and one branch
  runs.

A captured region must make no pageable host-to-device copy either, so the
small constants the frame needs are built once per device and dtype and
cached (:func:`constant`, :func:`cached`). :func:`capture_graph` captures a
region without gates (the backend's solves) the same way.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional

import torch

_CAPTURE: contextvars.ContextVar = contextvars.ContextVar(
    "cuda_graph_capture", default=None)
_WARMUP: contextvars.ContextVar = contextvars.ContextVar(
    "cuda_graph_warmup", default=False)

#: > 0 while :func:`host_bool` reads a predicate: the one sanctioned host
#: read of a gate (the CPU tests' host-read guard lets it through)
host_read_depth = 0

_CACHE: Dict[Any, torch.Tensor] = {}


class Capture:
    """What the capture of one CUDA graph records: the body pool (a
    ``torch.cuda.MemPool`` its conditional bodies allocate from) and how
    deep inside conditional bodies the capture is."""

    def __init__(self, body_pool):
        self.body_pool = body_pool
        self.depth = 0


def capturing() -> Optional[Capture]:
    """The capture in progress on this thread, or None."""
    return _CAPTURE.get()


@contextlib.contextmanager
def capture(body_pool) -> Iterator[Capture]:
    """Mark the region in which a CUDA graph is being captured (the caller
    runs ``torch.cuda.graph(...)`` around it); conditional bodies allocate
    from ``body_pool``, which nothing outside the session's captures
    uses."""
    rec = Capture(body_pool)
    token = _CAPTURE.set(rec)
    try:
        yield rec
    finally:
        _CAPTURE.reset(token)


@contextlib.contextmanager
def warmup() -> Iterator[None]:
    """Run every branch of every gate (see the module docstring)."""
    token = _WARMUP.set(True)
    try:
        yield
    finally:
        _WARMUP.reset(token)


def warming() -> bool:
    """True inside :func:`warmup`."""
    return _WARMUP.get()


def host_bool(pred) -> bool:
    """``bool(pred)``, the host read of an eager gate."""
    global host_read_depth
    host_read_depth += 1
    try:
        return bool(pred)
    finally:
        host_read_depth -= 1


_STREAMS: Dict[Any, "torch.cuda.Stream"] = {}
_warm_depth = 0


def _body_stream(device: torch.device, depth: int) -> "torch.cuda.Stream":
    """The stream conditional bodies at nesting ``depth`` run on."""
    device = torch.device(device)
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), depth)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device)
    return _STREAMS[key]


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream a device's captures (and the warm-ups before them) run
    on: one per device, so that per-stream library state is made once."""
    return _body_stream(device, -1)


def capture_graph(fn: Callable, args: tuple, pool) -> tuple:
    """``fn(*args)`` captured as one CUDA graph on the device of ``args``'
    tensors, with no conditional node: first run eagerly on the device's
    :func:`capture_stream` (thrown away; library handles and workspaces are
    per stream), then captured there into the memory pool ``pool``.
    Returns ``(graph, out)``: ``graph.replay()`` reruns ``fn`` on the
    current stream on whatever ``args``' tensors hold then, and ``out``
    (what the capture returned) holds the latest replay's results. A
    failure raises; nothing falls back to running eagerly."""
    dev = leaves(args)[0].device
    side = capture_stream(dev)
    main = torch.cuda.current_stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn(*args)
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=side):
        out = fn(*args)
    return graph, out


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


@contextlib.contextmanager
def _body(cap: Capture, pred: torch.Tensor) -> Iterator[None]:
    """Capture the enclosed work into an IF node on ``pred``."""
    from . import _build

    if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
        raise ValueError(f"a conditional node needs a one-element bool "
                         f"CUDA tensor, got {pred.dtype} {tuple(pred.shape)} "
                         f"on {pred.device}")
    lib = _build.load(_SIGNATURES, "conditional")
    parent = torch.cuda.current_stream(pred.device)
    body = _body_stream(pred.device, cap.depth)
    _check(lib.cvms_if_begin(parent.cuda_stream, pred.data_ptr(),
                             body.cuda_stream), "cvms_if_begin")
    cap.depth += 1
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.cuda.stream(body))
            if cap.depth == 1:
                stack.enter_context(torch.cuda.use_mem_pool(cap.body_pool))
            yield
    finally:
        cap.depth -= 1
        _check(lib.cvms_if_end(body.cuda_stream), "cvms_if_end")


@contextlib.contextmanager
def _warm_body(pred) -> Iterator[None]:
    """Warm-up: run the enclosed work on the stream its captured body will
    use, ordered after and before the parent stream's work."""
    global _warm_depth
    if not (isinstance(pred, torch.Tensor) and pred.is_cuda):
        yield
        return
    parent = torch.cuda.current_stream(pred.device)
    body = _body_stream(pred.device, _warm_depth)
    body.wait_stream(parent)
    _warm_depth += 1
    try:
        with torch.cuda.stream(body):
            yield
    finally:
        _warm_depth -= 1
        parent.wait_stream(body)


_P = ctypes.c_void_p
_SIGNATURES = {"cvms_if_begin": [_P, _P, _P], "cvms_if_end": [_P]}


def if_(pred, body: Callable[[], Any]) -> Optional[bool]:
    """Run ``body()`` (in-place writes only) when ``pred`` holds.

    Returns the host value of ``pred`` when it was read on the host, else
    None (captured, or in warm-up, where the body always runs)."""
    cap = _CAPTURE.get()
    if cap is not None:
        with _body(cap, pred):
            body()
        return None
    if _WARMUP.get():
        with _warm_body(pred):
            body()
        return None
    taken = host_bool(pred)
    if taken:
        body()
    return taken


def cond(pred, true_fn: Callable, false_fn: Callable,
         operands: tuple = ()):
    """``true_fn(*operands)`` if ``pred`` else ``false_fn(*operands)``.

    Captured, an output of the true branch that shares storage with an
    operand is cloned inside the branch, so the false branch's copy into
    it cannot overwrite that operand; the branches must take the tensors
    they read through ``operands`` for that check to see them."""
    cap = _CAPTURE.get()
    if cap is not None:
        held = {t.untyped_storage().data_ptr() for t in leaves(operands)}
        not_pred = torch.logical_not(pred)
        with _body(cap, pred):
            outs = tree_map(
                lambda t: (t.clone() if t.untyped_storage().data_ptr()
                           in held else t),
                true_fn(*operands))
        with _body(cap, not_pred):
            other = false_fn(*operands)
            out_leaves, other_leaves = leaves(outs), leaves(other)
            if len(out_leaves) != len(other_leaves):
                raise ValueError("cond: the branches return different "
                                 "structures")
            for o, e in zip(out_leaves, other_leaves):
                o.copy_(e)
        return outs
    if _WARMUP.get():
        with _warm_body(pred):
            t = true_fn(*operands)
        with _warm_body(pred):
            f = false_fn(*operands)
        return t if host_bool(pred) else f
    return true_fn(*operands) if host_bool(pred) else false_fn(*operands)


# ---------------------------------------------------------------------------
# pytrees of tensors (tuples, lists, dicts, dataclasses)
# ---------------------------------------------------------------------------


def leaves(obj) -> list:
    """The tensors of ``obj`` in a fixed order; anything else is refused."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in leaves(o)]
    if isinstance(obj, dict):
        return [t for k in obj for t in leaves(obj[k])]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in leaves(getattr(obj, f.name))]
    if obj is None:
        return []
    raise TypeError(f"not a tensor or a structure of tensors: {type(obj)}")


def tree_map(fn: Callable, obj):
    """``obj`` with every tensor ``t`` replaced by ``fn(t)``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_map(fn, o) for o in obj)
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    raise TypeError(f"not a tensor or a structure of tensors: {type(obj)}")


# ---------------------------------------------------------------------------
# constants built once per device and dtype
# ---------------------------------------------------------------------------


def cached(key, build: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The tensor cached under ``key``, built by ``build()`` the first time.
    Callers never write into it. Building inside a capture is refused: the
    warm-up frame before every capture builds all of them."""
    t = _CACHE.get(key)
    if t is None:
        if _CAPTURE.get() is not None:
            raise RuntimeError(f"constant {key!r} first built inside a CUDA "
                               f"graph capture")
        t = _CACHE[key] = build()
    return t


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)`` built once;
    ``values`` is a number or nested tuples of numbers."""
    device = torch.device(device)
    return cached(("tensor", values, dtype, device),
                  lambda: torch.tensor(values, dtype=dtype, device=device))
