"""A recorded sequence mapped by one session spread over several cards:
``replay``'s chunks with the session's factorizations split across a mesh
of one rank a card (``parallel.mesh.set_mesh``; the configuration's
``dist_chol_panel`` row-shards the joint Cholesky, ``session.shard_sqrt``
also the Grams over S's rows).

``run.py`` starts one process a card for a cell of more than one chip
(``parallel.launch.spawn``, NCCL on the card, ``gloo`` on the CPU); every
rank runs the whole cell, its window ending when rank 0's clock says so,
and rank 0's line is printed, with the ranks' device-busy time averaged and
the fullest card's memory peak.
"""

from __future__ import annotations

import torch

from slambench import driving, harness

_Replay = harness.route("replay").Route


class Route(_Replay):
    def __init__(self, ctx: driving.Ctx):
        import torch.distributed as dist
        from cv_monoslam_tpu_torch.parallel.mesh import make_mesh, set_mesh

        self.mesh = make_mesh(dist.get_world_size(), ctx.device)
        self._ambient = set_mesh(
            self.mesh, shard_sqrt=bool(ctx.session.get("shard_sqrt")))
        self._ambient.__enter__()
        super().__init__(ctx)

    def _decide(self, more: bool, sampled: bool) -> tuple:
        """Rank 0's clock decides for every rank."""
        flag = torch.tensor([int(more), int(sampled)], dtype=torch.int32,
                            device=self.ctx.device)
        more, sampled = self.mesh.broadcast(flag, 0).tolist()
        return bool(more), bool(sampled)

    def release(self) -> None:
        super().release()
        self._ambient.__exit__(None, None, None)
