"""Multi-device paths over ``torch.distributed`` (NCCL on ``cuda``, ``gloo``
on the CPU): the mesh and its layouts (:mod:`.mesh`), process launch
(:mod:`.launch`), the row-sharded Cholesky (:mod:`.dist_chol`), distributed
bundle adjustment (:mod:`.dist_ba`) and the sharded filter step
(:mod:`.spmd`).

This package sits above the filter: the filter reads the ambient mesh from
``ops.linalg.AMBIENT`` and imports :mod:`.dist_chol` only inside the joint
update that calls it. Only :mod:`.mesh` is imported here.
"""

from .mesh import (MAP_AXIS, Layout, Mesh, get_mesh, make_mesh,
                   replicate_hint, set_mesh, state_shardings)

__all__ = ["MAP_AXIS", "Layout", "Mesh", "get_mesh", "make_mesh",
           "replicate_hint", "set_mesh", "state_shardings"]
