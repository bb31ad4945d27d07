"""SE(2) pose-graph optimisation for loop closure on long valet loops (port
of conan_slam_tpu.graph.pose_graph; BASELINE config 4).

Static shapes throughout: fixed node and edge capacities with validity
masks.  The sparse Gauss-Newton normal equations are never formed: the
Hessian-vector product is a gather, one 6x6 block product an edge (its
block of J^T Omega J, formed once a Gauss-Newton step) and a segmented sum
onto the nodes, inside a fixed-length block-Jacobi-preconditioned
conjugate gradient; damped (Levenberg) iterations, gauge fixed by an
anchor prior on node 0.

Edge model (the standard SE(2) relative-pose factor):
    T_i^-1 T_j = (R(th_i)^T (t_j - t_i), th_j - th_i)
    r_e = t2v(T_i^-1 T_j) - z_e        (angle component wrapped)

Plain PyTorch (the reference is plain jnp).  Every loop runs its full
fixed length and never waits for the device: the reference's
``where(denom > 0, ...)`` is a ``torch.where``, no residual test stops a
loop early.  The reference's scatter-adds onto the nodes (``.at[i].add``
with repeated indices) are ``scatter_nodes`` on a ``ScatterPlan`` built once
a graph from its edge list: each node's rows summed in one fixed order (its
rows as the i end of an edge in edge order, then as the j end), so a solve
on the card is reproducible bit for bit, where ``index_add_``'s float
atomics are not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.core.linalg import inv3


class PoseGraph(NamedTuple):
    nodes: torch.Tensor       # (T, 3) pose estimates (x, y, theta)
    node_mask: torch.Tensor   # (T,) bool
    edges: torch.Tensor       # (E, 2) int64 (i, j) node indices
    meas: torch.Tensor        # (E, 3) measured relative pose in frame i
    info: torch.Tensor        # (E, 3, 3) information (inverse covariance)
    edge_mask: torch.Tensor   # (E,) bool


def relative_pose(pose_i: torch.Tensor, pose_j: torch.Tensor) -> torch.Tensor:
    """t2v(T_i^-1 T_j) for batched poses (..., 3)."""
    c = torch.cos(pose_i[..., 2])
    s = torch.sin(pose_i[..., 2])
    dx = pose_j[..., 0] - pose_i[..., 0]
    dy = pose_j[..., 1] - pose_i[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy,
                        wrap_angle(pose_j[..., 2] - pose_i[..., 2])], dim=-1)


def _edge_residual_jacobians(nodes, edges, meas):
    """Residuals (E, 3) and Jacobian blocks A = dr/dx_i, B = dr/dx_j (E, 3, 3)."""
    pi = nodes[edges[:, 0]]
    pj = nodes[edges[:, 1]]
    c = torch.cos(pi[:, 2])
    s = torch.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    r = torch.stack([c * dx + s * dy - meas[:, 0], -s * dx + c * dy - meas[:, 1],
                     wrap_angle(pj[:, 2] - pi[:, 2] - meas[:, 2])], dim=-1)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    a = torch.stack([
        torch.stack([-c, -s, -s * dx + c * dy], dim=-1),
        torch.stack([s, -c, -c * dx - s * dy], dim=-1),
        torch.stack([zero, zero, -one], dim=-1),
    ], dim=-2)
    b = torch.stack([
        torch.stack([c, s, zero], dim=-1),
        torch.stack([-s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return r, a, b


def graph_error(g: PoseGraph) -> torch.Tensor:
    """Total chi^2 = sum_e r^T Omega r over valid edges."""
    r, _, _ = _edge_residual_jacobians(g.nodes, g.edges, g.meas)
    chi = torch.einsum("ea,eab,eb->e", r, g.info, r)
    return torch.sum(torch.where(g.edge_mask, chi, 0.0))


class ScatterPlan(NamedTuple):
    """A fixed-order sum of per-edge rows onto the nodes.  The rows come
    interleaved, (E, 2, ...): row (e, 0) goes to node i_e, row (e, 1) to
    node j_e.  ``order`` (2E,) lists the flattened rows by node, each
    node's rows as an i end in edge order, then as a j end in edge order
    (the reference's ``.at[i].add`` then ``.at[j].add``); node n's are
    ``order[offsets[n]:offsets[n + 1]]``."""
    order: torch.Tensor     # (2E,) int64
    offsets: torch.Tensor   # (T + 1,) int64


def scatter_plan(edges: torch.Tensor, t: int) -> ScatterPlan:
    """The ScatterPlan of ``edges`` (E, 2) onto ``t`` nodes, on the edges'
    device (no host sync)."""
    e = edges.shape[0]
    dest = torch.cat([edges[:, 0], edges[:, 1]]).long()
    by_node = torch.argsort(dest, stable=True)       # over cat([i ends, j ends])
    offsets = torch.searchsorted(dest[by_node], torch.arange(t + 1, device=edges.device))
    return ScatterPlan(order=2 * (by_node % e) + by_node // e, offsets=offsets)


def scatter_nodes(plan: ScatterPlan, rows: torch.Tensor) -> torch.Tensor:
    """``zeros(T, ...).at[i].add(rows[:, 0]).at[j].add(rows[:, 1])`` for
    ``rows`` (E, 2, ...), summed in the plan's fixed order."""
    flat = rows.reshape((-1,) + rows.shape[2:])[plan.order]
    return torch.segment_reduce(flat, "sum", offsets=plan.offsets, axis=0, unsafe=True)


def _diag_shift(t: int, damping: float, anchor_weight: float, like: torch.Tensor):
    """(T, 1) the diagonal added to a node system: ``damping`` everywhere,
    plus ``anchor_weight`` at node 0 (the anchor prior)."""
    d = torch.full((t, 1), damping, dtype=like.dtype, device=like.device)
    d[0] += anchor_weight
    return d


def _cg(apply, rhs, prec, cg_iterations: int):
    """``cg_iterations`` steps of preconditioned conjugate gradient on
    ``apply(v) = rhs`` from 0, every step run (no residual test);
    ``prec(r)`` applies the preconditioner (``None``: the identity)."""
    x = torch.zeros_like(rhs)
    res = rhs
    z = rhs if prec is None else prec(rhs)
    p, rz = z, torch.sum(rhs * z)
    for _ in range(cg_iterations):
        ap = apply(p)
        denom = torch.sum(p * ap)
        alpha = torch.where(denom > 0, rz / torch.clamp(denom, min=1e-30), 0.0)
        x = torch.addcmul(x, alpha, p)
        res = torch.addcmul(res, alpha, ap, value=-1.0)
        z = res if prec is None else prec(res)
        rz_new = torch.sum(res * z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = torch.addcmul(z, beta, p)
        rz = rz_new
    return x


def _incidence_cg(plan: ScatterPlan, edges, w, rhs, cg_iterations: int, anchor_weight: float,
                  damping: float = 1e-6):
    """CG solve of the weighted graph-Laplacian system L x = rhs.

    L = sum_e w_e (e_j - e_i)(e_j - e_i)^T + anchor at node 0 + damping.
    ``rhs`` and the result are (N,) or (N, 2); the chordal init's workhorse.
    """
    vec = rhs.dim() == 1
    rhs = rhs[:, None] if vec else rhs
    signed = torch.stack([-w, w], dim=1)[..., None]                 # (E, 2, 1)
    shift = _diag_shift(rhs.shape[0], damping, anchor_weight, rhs)

    def lap(v):
        ve = v[edges]                                               # (E, 2, k)
        rows = (ve[:, 1] - ve[:, 0])[:, None] * signed             # -w dv to i, w dv to j
        return torch.addcmul(scatter_nodes(plan, rows), shift, v)

    x = _cg(lap, rhs, None, cg_iterations)
    return x[:, 0] if vec else x


def chordal_initialize(g: PoseGraph, *, cg_iterations: int | None = None) -> PoseGraph:
    """Two-stage linear initialisation (SE(2) chordal, rotation first).

    Gauss-Newton on a badly drifted chain folds into local minima: the
    nonlinearity lives in the headings.  Stage A solves the linear
    least-squares heading correction over all edges (residuals wrapped at
    the current estimate, which resolves the 2 pi ambiguity while each
    edge's error is under pi); stage B the exactly linear position problem
    given the headings.
    """
    t = g.nodes.shape[0]
    if cg_iterations is None:
        cg_iterations = max(60, t)
    plan = scatter_plan(g.edges, t)
    i, j = g.edges[:, 0], g.edges[:, 1]
    em = g.edge_mask.to(g.nodes.dtype)
    anchor_weight = 1e6

    # Stage A: headings.
    theta = g.nodes[:, 2]
    w_th = g.info[:, 2, 2] * em
    r_th = wrap_angle(theta[j] - theta[i] - g.meas[:, 2]) * em
    rhs = scatter_nodes(plan, torch.stack([w_th * r_th, -w_th * r_th], dim=1))
    theta = theta + _incidence_cg(plan, g.edges, w_th, rhs, cg_iterations, anchor_weight)

    # Stage B: positions (linear given the headings).
    c = torch.cos(theta[i])
    s = torch.sin(theta[i])
    d_e = torch.stack([c * g.meas[:, 0] - s * g.meas[:, 1],
                       s * g.meas[:, 0] + c * g.meas[:, 1]], dim=-1)
    w_xy = g.info[:, 0, 0] * em
    pos = g.nodes[:, :2]
    r_xy = (pos[j] - pos[i] - d_e) * em[:, None]
    wr = w_xy[:, None] * r_xy
    rhs2 = scatter_nodes(plan, torch.stack([wr, -wr], dim=1))
    dpos = _incidence_cg(plan, g.edges, w_xy, rhs2, cg_iterations, anchor_weight)

    nodes = torch.cat([pos + dpos, wrap_angle(theta)[:, None]], dim=-1)
    return g._replace(nodes=torch.where(g.node_mask[:, None], nodes, g.nodes))


def _normal_equations(g: PoseGraph, nodes, plan: ScatterPlan, anchor0, damping: float,
                      anchor_weight: float):
    """One Gauss-Newton step's system at ``nodes``: the edges' Jacobians
    [A B] (E, 3, 6), the right-hand side -(J^T Omega r + anchor) (T, 3) and
    the block-Jacobi preconditioner's blocks, the (3, 3) node-diagonal
    blocks of J^T Omega J + lambda I (+ anchor) (T, 3, 3).  Mixed
    metre/radian information conditions the plain system badly;
    preconditioned, the CG count is set by the chain's length."""
    r, a, b = _edge_residual_jacobians(nodes, g.edges, g.meas)
    n_edges = g.edges.shape[0]
    jac = torch.cat([a, b], dim=-1)
    emask = g.edge_mask[:, None, None]
    omega = g.info
    omega_r = torch.where(emask, omega @ r[..., None], 0.0)           # (E, 3, 1)
    grad = scatter_nodes(plan, (jac.transpose(-1, -2) @ omega_r).reshape(n_edges, 2, 3))
    grad[0] += anchor_weight * (nodes[0] - anchor0)
    em = emask.to(nodes.dtype)
    at = a.transpose(-1, -2)
    bt = b.transpose(-1, -2)
    blocks = torch.stack([em * (at @ omega @ a), em * (bt @ omega @ b)], dim=1)
    eye = torch.eye(3, dtype=nodes.dtype, device=nodes.device)
    diag = scatter_nodes(plan, blocks) + damping * eye
    diag[0] += anchor_weight * eye
    return jac, -grad, diag


def optimize(g: PoseGraph, *, iterations: int = 10, cg_iterations: int = 50,
             damping: float = 1e-3, anchor_weight: float = 1e6,
             chordal_init: bool = False) -> PoseGraph:
    """Damped Gauss-Newton with matrix-free block-Jacobi-preconditioned CG.

    The anchor prior (information ``anchor_weight * I`` on node 0's error
    against its value after the chordal passes) removes the global SE(2)
    gauge freedom.  ``chordal_init`` runs the two-stage linear
    initialisation first, three passes (the heading stage's wrapping
    updates between passes), as the reference: needed for badly drifted
    chains (dead reckoning), harmless otherwise.
    """
    t = g.nodes.shape[0]
    plan = scatter_plan(g.edges, t)
    if chordal_init:
        for _ in range(3):
            g = chordal_initialize(g)
    anchor0 = g.nodes[0]
    edges, n_edges = g.edges, g.edges.shape[0]
    emask = g.edge_mask[:, None, None]
    shift = _diag_shift(t, damping, anchor_weight, g.nodes)

    def gn_step(nodes):
        jac, rhs, diag = _normal_equations(g, nodes, plan, anchor0, damping, anchor_weight)
        minv = inv3(diag)                                    # (T, 3, 3)
        # Each valid edge's (6, 6) block of J^T Omega J over its two nodes:
        # the Hessian-vector product is a gather, one block product an edge
        # and the fixed-order sum.
        hess = torch.where(emask, jac.transpose(-1, -2) @ g.info @ jac, 0.0)

        def hvp(v):
            """(J^T Omega J + lambda I + anchor) v without forming J."""
            hv = hess @ v[edges].reshape(n_edges, 6, 1)
            return torch.addcmul(scatter_nodes(plan, hv.reshape(n_edges, 2, 3)), shift, v)

        dx = _cg(hvp, rhs, lambda r: (minv @ r[..., None])[..., 0], cg_iterations)
        new = nodes + torch.where(g.node_mask[:, None], dx, 0.0)
        return torch.cat([new[:, :2], wrap_angle(new[:, 2:])], dim=-1)

    nodes = g.nodes
    for _ in range(iterations):
        nodes = gn_step(nodes)
    return g._replace(nodes=nodes)


def detect_loop_closures(nodes: torch.Tensor, node_mask: torch.Tensor, *, max_candidates: int,
                         radius: float, min_index_gap: int):
    """Proximity loop-closure candidates on a keyframe trajectory.

    Returns (pairs (C, 2) int64, mask (C,)): node pairs whose positions lie
    within ``radius`` and whose indices are at least ``min_index_gap``
    apart, the closest first (top-k over a dense masked score, T^2 pairs).
    Slots past the valid pairs (score -inf) hold arbitrary pairs, masked.
    """
    t = nodes.shape[0]
    pos = nodes[:, :2]
    d2 = torch.sum((pos[:, None, :] - pos[None, :, :]) ** 2, dim=-1)
    ii = torch.arange(t, device=nodes.device)
    gap = torch.abs(ii[:, None] - ii[None, :])
    valid = ((d2 < radius**2) & (gap >= min_index_gap) & node_mask[:, None]
             & node_mask[None, :] & (ii[:, None] < ii[None, :]))
    score = torch.where(valid, -d2, -torch.inf).reshape(-1)
    top, idx = torch.topk(score, max_candidates)
    pairs = torch.stack([idx // t, idx % t], dim=-1)
    return pairs, torch.isfinite(top)
