"""Planar pose-graph optimization (loop closure backend, bench config 4).

Generalizes the reference's redirection/loop mechanism (SLAM.cpp:948-1015,
1354-1428) — which splices saved feature blocks back into the filter — into
a graph optimization over keyframes: nodes are (x, y, theta) poses, edges
are relative-pose constraints between consecutive keyframes and from loop
events (place re-identification).

A fixed-capacity edge table with a validity mask, residuals and Jacobians of
all edges at once, dense (3N, 3N) normal equations assembled with one-hot
incidence products (the summation order of the JAX package, which a
scatter-add would change), solved by ``torch.linalg.solve`` in a Python loop
over Gauss-Newton iterations. Every tensor stays on the graph's device; the
float32 products run in full FP32 (nothing here enables TF32: reduced
precision destabilizes the normal-equation solve).
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import transforms as tf


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    nodes: torch.Tensor      # (N, 3) initial poses
    edges_ij: torch.Tensor   # (E, 2) int32 node indices
    edges_rel: torch.Tensor  # (E, 3) measured relative pose of j in i's frame
    edges_w: torch.Tensor    # (E, 3) per-component information weights
    edge_mask: torch.Tensor  # (E,) bool
    node_mask: torch.Tensor  # (N,) bool


def _edge_residual(pi: torch.Tensor, pj: torch.Tensor,
                   rel: torch.Tensor) -> torch.Tensor:
    """Residual of relative-pose edges, batched over leading dimensions."""
    c, s = torch.cos(pi[..., 2]), torch.sin(pi[..., 2])
    dx = pj[..., 0] - pi[..., 0]
    dy = pj[..., 1] - pi[..., 1]
    return torch.stack([c * dx + s * dy - rel[..., 0],
                        -s * dx + c * dy - rel[..., 1],
                        tf.wrap_angle(pj[..., 2] - pi[..., 2] - rel[..., 2])],
                       dim=-1)


def _edge_jacobians(pi: torch.Tensor, pj: torch.Tensor):
    """Closed-form (d r / d pi, d r / d pj) of :func:`_edge_residual`,
    (..., 3, 3) each (the angle wrap has unit slope)."""
    c, s = torch.cos(pi[..., 2]), torch.sin(pi[..., 2])
    dx = pj[..., 0] - pi[..., 0]
    dy = pj[..., 1] - pi[..., 1]
    z, o = torch.zeros_like(c), torch.ones_like(c)
    ji = torch.stack([
        torch.stack([-c, -s, -s * dx + c * dy], dim=-1),
        torch.stack([s, -c, -c * dx - s * dy], dim=-1),
        torch.stack([z, z, -o], dim=-1)], dim=-2)
    jj = torch.stack([
        torch.stack([c, s, z], dim=-1),
        torch.stack([-s, c, z], dim=-1),
        torch.stack([z, z, o], dim=-1)], dim=-2)
    return ji, jj


def _gn_step(nodes, g: PoseGraph, damping, prior_w):
    N = nodes.shape[0]
    dtype, dev = nodes.dtype, nodes.device
    ei, ej = g.edges_ij[:, 0].long(), g.edges_ij[:, 1].long()

    pi, pj = nodes[ei], nodes[ej]
    r = _edge_residual(pi, pj, g.edges_rel)                 # (E,3)
    Ji, Jj = _edge_jacobians(pi, pj)                        # (E,3,3)
    wm = (g.edge_mask & g.node_mask[ei] & g.node_mask[ej]).to(dtype)
    iw = g.edges_w * wm[:, None]                            # (E,3)

    # one-hot incidence (E, N)
    ar = torch.arange(N, device=dev)
    onehot_i = (ei[:, None] == ar[None, :]).to(dtype)
    onehot_j = (ej[:, None] == ar[None, :]).to(dtype)

    def blocks(Ja, Jb, oa, ob):
        # H[a,b] += sum_e oa[e,a] ob[e,b] Ja_e^T diag(iw_e) Jb_e
        JtWJ = torch.einsum("eki,ek,ekj->eij", Ja, iw, Jb)  # (E,3,3)
        return torch.einsum("ea,eb,eij->abij", oa, ob, JtWJ)

    H = (blocks(Ji, Ji, onehot_i, onehot_i)
         + blocks(Jj, Jj, onehot_j, onehot_j)
         + blocks(Ji, Jj, onehot_i, onehot_j)
         + blocks(Jj, Ji, onehot_j, onehot_i))              # (N,N,3,3)
    JtWr_i = torch.einsum("eki,ek,ek->ei", Ji, iw, r)
    JtWr_j = torch.einsum("eki,ek,ek->ei", Jj, iw, r)
    b = -(torch.einsum("ea,ei->ai", onehot_i, JtWr_i)
          + torch.einsum("ea,ei->ai", onehot_j, JtWr_j))    # (N,3)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    H[ar, ar] += damping * eye3
    # gauge prior on node 0
    H[0, 0] += prior_w * eye3
    # empty nodes: identity rows
    off = ~g.node_mask
    H = torch.where((off[:, None] | off[None, :])[..., None, None],
                    torch.zeros_like(H), H)
    H[ar, ar] += off[:, None, None].to(dtype) * eye3
    b = torch.where(off[:, None], torch.zeros_like(b), b)

    Hd = H.permute(0, 2, 1, 3).reshape(3 * N, 3 * N)
    dx = torch.linalg.solve(Hd, b.reshape(-1)).reshape(N, 3)
    dx = torch.where(g.node_mask[:, None], dx, torch.zeros_like(dx))
    cost = 0.5 * torch.sum(r * r * iw)
    return nodes + dx, cost


def pose_graph_solve(g: PoseGraph, *, iters: int = 10,
                     damping: float = 1e-6, prior_w: float = 1e8):
    """Batched Gauss-Newton. Returns (optimized nodes (N, 3), costs)."""
    nodes = g.nodes
    costs = []
    for _ in range(iters):
        nodes, cost = _gn_step(nodes, g, damping, prior_w)
        costs.append(cost)
    nodes = torch.cat([nodes[:, :2], tf.wrap_angle(nodes[:, 2:])], dim=1)
    costs = (torch.stack(costs) if costs
             else torch.zeros(0, dtype=nodes.dtype, device=nodes.device))
    return nodes, costs
