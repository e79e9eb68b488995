"""A guard against host reads and host uploads, for tests: the port's
counterpart of ``jax.transfer_guard("disallow")``.

A captured CUDA graph cannot hold a host read (a device sync) or a
pageable host-to-device copy, and on the card such a fault shows only when
the capture fails. :func:`no_host_reads` makes every such call raise
:class:`HostRead` on any device, so a CPU test finds it first. The one
sanctioned host read, :func:`control.host_bool` (an eager gate), passes.
It patches ``torch`` while active, so it is for tests only; it lives in the
package because spawned ranks run only the package's functions
(:func:`guarded`).
"""

from __future__ import annotations

import contextlib
import numbers

import numpy as np
import torch

from . import control


class HostRead(AssertionError):
    pass


def _zero_d_index(index) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and i.dim() == 0 for i in items)


def _device_scalar_write(index, value) -> bool:
    """``t[index] = number`` copies a host scalar to the device when the
    index takes single elements or a tensor picks them."""
    if not isinstance(value, (numbers.Number, np.generic)):
        return False
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) for i in items) or all(
        isinstance(i, int) for i in items)


@contextlib.contextmanager
def no_host_reads():
    """Make every way a tensor's value reaches the host raise (bool, int,
    float and index conversion, item, tolist, cpu, numpy, a 0-d tensor
    index, nonzero, and the ``torch.linalg`` forms that read ``info`` on
    the host: ``solve``, ``inv``, ``cholesky``, ``eigh``), and every upload
    of host data (``torch.tensor`` or ``torch.as_tensor`` of host data onto
    a device, a host scalar written into selected elements), except inside
    ``control.host_bool``."""
    T = torch.Tensor
    saved = {}

    def guard(owner, name, test=None):
        real = getattr(owner, name)
        saved[(owner, name)] = real

        def wrapped(*a, **kw):
            if control.host_read_depth == 0 and (test is None
                                                 or test(*a, **kw)):
                raise HostRead(f"{getattr(owner, '__name__', owner)}."
                               f"{name} outside control.host_bool")
            return real(*a, **kw)

        setattr(owner, name, wrapped)

    try:
        for name in ("__bool__", "__int__", "__float__", "__index__",
                     "item", "tolist", "cpu", "numpy", "nonzero"):
            guard(T, name)
        guard(T, "__getitem__", lambda self, index: _zero_d_index(index))
        guard(T, "__setitem__",
              lambda self, index, value: _zero_d_index(index)
              or _device_scalar_write(index, value))
        guard(torch, "nonzero")
        for name in ("solve", "inv", "cholesky", "eigh"):
            guard(torch.linalg, name)
        guard(torch, "tensor", lambda *a, **kw: "device" in kw)
        guard(torch, "as_tensor", lambda data, *a, **kw: "device" in kw
              and not isinstance(data, torch.Tensor))
        yield
    finally:
        for (owner, name), real in saved.items():
            setattr(owner, name, real)


def guarded(fn, *args, **kw):
    """``fn(*args, **kw)`` under :func:`no_host_reads`."""
    with no_host_reads():
        return fn(*args, **kw)
