"""Pose-graph optimization (the loop-closure back end), in PyTorch.

The port of ``visual_odometry_rs_tpu/parallel/pose_graph.py``: given node
poses ``T_i`` and relative measurements ``Z_ij`` (the odometry chain and the
loop edges), minimize

    E = Σ_edges || log( Z_ij^-1 · T_i^-1 · T_j ) ||²_Λ

over right-multiplied twist updates ``T_i <- T_i exp(xi_i)``, node 0
gauge-fixed.  ``solve`` assembles the dense 6N x 6N normal equations and
factors them by Cholesky; ``solve_sparse`` solves each LM step by
preconditioned conjugate gradients (PCG) with the chain's block-tridiagonal
part as the preconditioner, never forming the matrix.  Both keep the JAX
package's accept/reject rule, damping schedule, stop rules and gauge.

- **Jacobians.** Forward-mode derivatives of the exact se(3) residual
  through the port's ``math.se3`` (``torch.where`` branches only, so forward
  mode is defined everywhere), as the JAX package's ``jax.jacfwd``: one
  pass of dual tensors for all edges and all 12 directions.
- **Fixed order.** Every per-node sum (the gradient, the Hessian blocks and
  diagonal, the PCG matrix-vector product) gathers the node's edge terms
  through an incidence table built on the host and sums them along one
  axis: no scatter-add, no float atomic, so two runs on a GPU are
  bit-equal.
- **Host reads.** The LM loops run on the host and read one flag per
  iteration.  PCG runs masked updates (a step whose residual already meets
  the tolerance leaves the state as it is) and reads its stop flag every
  ``CG_CHECK_EVERY`` iterations: the same iterates as a check after every
  iteration.  Building the incidence tables reads the edge endpoints once
  per solve.
- The block-tridiagonal preconditioner is block Thomas, as in the JAX
  package.  Its factors depend only on the LM step and are computed once
  per step, node by node.  Its two sweeps, which each PCG iteration runs,
  are linear recurrences solved by doubling scans: ceil(log2 N) batched
  steps each, where a loop over the nodes would be N small launches.

``solve_sparse_sharded`` spreads the edges over the ranks of a mesh axis:
every edge sum of ``solve_sparse`` (the energy, the gradient, the damping
diagonal, the PCG matrix-vector product and the preconditioner's blocks)
goes through one fixed-order cross-rank sum (``collectives.psum``), which is
the identity in ``solve_sparse``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import forward_ad

from ..math import pose as pose_mod
from ..math import se3
from ..math.pose import Pose
from ..utils.types import Float
from . import collectives

CG_CHECK_EVERY = 8  # PCG iterations between two reads of its stop flag


class PoseGraph(NamedTuple):
    """Fixed-shape pose graph.

    nodes: Pose with leading (N,).
    edge_i / edge_j: (E,) int64 endpoints.
    edge_z: Pose with leading (E,): measured T_i^-1 T_j.
    edge_weight: (E,) f32: information weight per edge (0 = padding).
    """

    nodes: Pose
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_z: Pose
    edge_weight: torch.Tensor


class PGOResult(NamedTuple):
    nodes: Pose
    energy: torch.Tensor  # 0-d f32
    nb_iter: torch.Tensor  # 0-d int32


def edge_residual(ti: Pose, tj: Pose, z: Pose) -> torch.Tensor:
    """6-dim se3 residual of an edge: log(Z^-1 T_i^-1 T_j); broadcasts."""
    rel = pose_mod.compose(pose_mod.inverse(ti), tj)
    err = pose_mod.compose(pose_mod.inverse(z), rel)
    return se3.log(err)


def _take(p: Pose, idx: torch.Tensor) -> Pose:
    return Pose(p.q[idx], p.t[idx])


def residuals(graph: PoseGraph, nodes: Pose) -> torch.Tensor:
    r = edge_residual(_take(nodes, graph.edge_i), _take(nodes, graph.edge_j), graph.edge_z)
    return r * torch.sqrt(graph.edge_weight)[:, None]


def _r_one(xi_i, xi_j, qi, ti, qj, tj, zq, zt, wgt):
    a = pose_mod.compose(Pose(qi, ti), se3.exp(xi_i))
    b = pose_mod.compose(Pose(qj, tj), se3.exp(xi_j))
    return edge_residual(a, b, Pose(zq, zt)) * torch.sqrt(wgt)[..., None]


def _edge_jacobians(graph: PoseGraph, nodes: Pose):
    """Per-edge residual and Jacobians wrt both endpoint twists at zero,
    (E, 6, 6) each: ``(ji, jj, r)``.  One forward-mode pass of the residual
    (dual tensors, ``torch.autograd.forward_ad``) over a leading axis of 12
    tangent directions, the basis twists of ``xi_i`` then of ``xi_j``, that
    the pose functions broadcast over: the columns of ``jax.jacfwd`` in
    one evaluation."""
    ends = (nodes.q[graph.edge_i], nodes.t[graph.edge_i], nodes.q[graph.edge_j], nodes.t[graph.edge_j],
            graph.edge_z.q, graph.edge_z.t, graph.edge_weight)
    E = graph.edge_i.shape[0]
    device = nodes.q.device
    zeros = torch.zeros((12, E, 6), dtype=Float, device=device)
    eye = torch.eye(6, dtype=Float, device=device)[:, None, :].expand(6, E, 6)
    tangent_i = torch.cat([eye, torch.zeros_like(eye)])
    tangent_j = torch.cat([torch.zeros_like(eye), eye])
    with forward_ad.dual_level():
        out = _r_one(forward_ad.make_dual(zeros, tangent_i), forward_ad.make_dual(zeros, tangent_j), *ends)
        r, dr = forward_ad.unpack_dual(out)
    jac = dr.permute(1, 2, 0)  # (E, 6 residuals, 12 directions)
    return jac[..., :6], jac[..., 6:], r[0]


def _edge_hessian_blocks(ji, jj):
    """Per-edge 6x6 Gauss-Newton blocks (Hii, Hjj, Hij)."""
    Hii = torch.einsum("eab,eac->ebc", ji, ji)
    Hjj = torch.einsum("eab,eac->ebc", jj, jj)
    Hij = torch.einsum("eab,eac->ebc", ji, jj)
    return Hii, Hjj, Hij


# ---------------------------------------------------------------------------
# Sums over the edges of each node, in a fixed order
# ---------------------------------------------------------------------------


def _padded_table(groups, pad: int) -> np.ndarray:
    """Lists of indices → a (len(groups), max length) table padded with ``pad``."""
    width = max(1, max((len(g) for g in groups), default=0))
    table = np.full((len(groups), width), pad, np.int64)
    for k, g in enumerate(groups):
        table[k, : len(g)] = g
    return table


class _Incidence(NamedTuple):
    """Gather tables of a graph's edges, built once per solve on the host.

    ``node`` (N, D) indexes ``cat([terms at edge_i, terms at edge_j, 0])``
    (2E + 1 rows): node n's row lists its edge_i terms in edge order, then
    its edge_j terms, then padding.  ``cell_n``, ``cell_m`` (C,) are the
    node pairs whose 6x6 block of the dense Hessian some edge touches and
    ``cell`` (C, D') indexes ``cat([Hii, Hjj, Hij, Hijᵀ, 0])`` (4E + 1
    rows) for each."""

    node: torch.Tensor
    cell_n: torch.Tensor
    cell_m: torch.Tensor
    cell: torch.Tensor


def _incidence(graph: PoseGraph, nb_nodes: int, cells: bool) -> _Incidence:
    device = graph.nodes.q.device
    ei = graph.edge_i.cpu().numpy()  # the solve's one read of the endpoints
    ej = graph.edge_j.cpu().numpy()
    E = len(ei)
    groups = [[] for _ in range(nb_nodes)]
    for e, n in enumerate(ei):
        groups[n].append(e)
    for e, n in enumerate(ej):
        groups[n].append(E + e)
    node = torch.from_numpy(_padded_table(groups, 2 * E)).to(device)
    if not cells:
        return _Incidence(node, None, None, None)
    by_cell: dict = {}
    for part, (rows, cols) in enumerate(((ei, ei), (ej, ej), (ei, ej), (ej, ei))):
        for e, key in enumerate(zip(rows.tolist(), cols.tolist())):
            by_cell.setdefault(key, []).append(part * E + e)
    keys = list(by_cell)
    cell_n = torch.tensor([k[0] for k in keys], dtype=torch.int64, device=device)
    cell_m = torch.tensor([k[1] for k in keys], dtype=torch.int64, device=device)
    cell = torch.from_numpy(_padded_table([by_cell[k] for k in keys], 4 * E)).to(device)
    return _Incidence(node, cell_n, cell_m, cell)


def _node_sum(inc: _Incidence, at_i: torch.Tensor, at_j: torch.Tensor) -> torch.Tensor:
    """(N, …): per node, its ``at_i`` terms (edges where it is i) and its
    ``at_j`` terms (edges where it is j), (E, …) each, summed."""
    pad = at_i.new_zeros((1, *at_i.shape[1:]))
    return torch.cat([at_i, at_j, pad])[inc.node].sum(dim=1)


# ---------------------------------------------------------------------------
# LM driver shared by both solves
# ---------------------------------------------------------------------------


def _retract(nodes: Pose, delta: torch.Tensor) -> Pose:
    new = pose_mod.compose(nodes, se3.exp(delta))
    return pose_mod.renormalize_first_order(new)


def _identity(x):
    return x


def _lm(graph: PoseGraph, max_iterations: int, step, reduce=_identity) -> PGOResult:
    """The LM loop of both solves: ``step(nodes, lm)`` gives the (N, 6)
    twist update; accept when the energy is finite and not larger, lambda
    times 0.3 on accept and 10 on reject, stop after ``max_iterations`` or
    an accepted step that lowers the energy by less than 1e-9 (E + 1).  One
    host read per iteration.  ``reduce`` sums the energy over the edge
    shards."""

    def energy_of(nodes):
        r = residuals(graph, nodes)
        return reduce(torch.sum(r * r))

    nodes = graph.nodes
    energy = energy_of(nodes)
    lm = torch.tensor(1e-6, dtype=Float, device=nodes.q.device)
    it = 0
    while True:
        new_nodes = _retract(nodes, step(nodes, lm))
        new_energy = energy_of(new_nodes)
        ok = (torch.isfinite(new_energy) & (new_energy <= energy)
              & torch.all(torch.isfinite(new_nodes.q)) & torch.all(torch.isfinite(new_nodes.t)))
        nodes = Pose(torch.where(ok, new_nodes.q, nodes.q), torch.where(ok, new_nodes.t, nodes.t))
        lm = torch.where(ok, lm * 0.3, lm * 10.0)
        converged = ok & (energy - new_energy < 1e-9 * (energy + 1.0))
        energy = torch.where(ok, new_energy, energy)
        it += 1
        if it >= max_iterations or bool(converged):
            break
    return PGOResult(nodes=nodes, energy=energy, nb_iter=torch.tensor(it, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Dense solve
# ---------------------------------------------------------------------------


def solve(graph: PoseGraph, *, max_iterations: int = 20) -> PGOResult:
    """LM pose-graph optimization with the dense 6N x 6N normal equations
    and a Cholesky solve; node 0 gauge-fixed.  Runs on the device of the
    graph's tensors."""
    N = graph.nodes.q.shape[0]
    n = 6 * N
    device = graph.nodes.q.device
    inc = _incidence(graph, N, cells=True)
    eye = torch.eye(n, dtype=Float, device=device)
    free = torch.arange(n, device=device) >= 6  # gauge-fix node 0
    both_free = free[:, None] & free[None, :]

    def normal_equations(nodes):
        ji, jj, r = _edge_jacobians(graph, nodes)
        Hii, Hjj, Hij = _edge_hessian_blocks(ji, jj)
        parts = torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2), Hii.new_zeros((1, 6, 6))])
        H = torch.zeros((N, N, 6, 6), dtype=Float, device=device)
        H[inc.cell_n, inc.cell_m] = parts[inc.cell].sum(dim=1)
        g = _node_sum(inc, -torch.einsum("eab,ea->eb", ji, r), -torch.einsum("eab,ea->eb", jj, r))
        return H.permute(0, 2, 1, 3).reshape(n, n), g.reshape(n)

    def step(nodes, lm):
        H, g = normal_equations(nodes)
        H_damped = H * (1.0 + lm * eye) + 1e-8 * eye
        H_fixed = torch.where(both_free, H_damped, eye)
        H_fixed = 0.5 * (H_fixed + H_fixed.T)  # jnp.linalg.cholesky symmetrizes its input
        g_fixed = torch.where(free, g, torch.zeros_like(g))
        chol, info = torch.linalg.cholesky_ex(H_fixed)
        delta = torch.cholesky_solve(g_fixed[:, None], chol)[:, 0]
        # a failed factorization gives NaN, as JAX's Cholesky does: the step is rejected
        delta = torch.where(info == 0, delta, torch.full_like(delta, float("nan")))
        return delta.reshape(N, 6)

    return _lm(graph, max_iterations, step)


# ---------------------------------------------------------------------------
# Sparse solve: PCG with the chain's block-tridiagonal preconditioner
# ---------------------------------------------------------------------------


def _block_tridiag_factor(D, U):
    """The block Thomas factors of the symmetric block-tridiagonal matrix
    with diagonal blocks ``D`` (N,6,6) and ``U[i]`` the (i, i+1) block
    (``U[N-1]`` ignored), as ``_block_tridiag_apply`` uses them.

    The Riccati part is the JAX package's recurrence, one node at a time:
    ``denom_i = D[i] - U[i-1]ᵀ C[i-1]`` and ``C[i] = denom_i⁻¹ U[i]``.  The
    two sweeps of a solve are linear recurrences, ``y_i = denom_i⁻¹ r_i -
    B_i y_{i-1}`` with ``B_i = denom_i⁻¹ U[i-1]ᵀ``, and ``x_i = y_i - C[i]
    x_{i+1}``; their operators depend on the matrix only, so the matrix
    products of their doubling scans (``_scan_operators``) are formed here,
    once per LM step."""
    N = D.shape[0]
    U = torch.cat([U[:-1], U.new_zeros((1, 6, 6))])
    Upt = torch.cat([U.new_zeros((1, 6, 6)), U[:-1]]).transpose(-1, -2)
    C, Dinv = [], []
    c_prev = U.new_zeros((6, 6))
    for i in range(N):
        inv = torch.linalg.inv_ex(D[i] - Upt[i] @ c_prev)[0]
        c_prev = inv @ U[i]
        C.append(c_prev)
        Dinv.append(inv)
    C, Dinv = torch.stack(C), torch.stack(Dinv)
    return Dinv, _scan_operators(-(Dinv @ Upt)), _scan_operators(-C.flip(0))


def _scan_operators(M):
    """The doubling (Hillis-Steele) scan of ``v_i <- v_i + M_i v_{i-1}``
    (``v_{-1} = 0``): per step of offset d = 1, 2, 4, …, the (N-d, 6, 6)
    operators that rows d.. apply to rows ..N-d of the step before.  They
    are products of the ``M_i`` and do not depend on ``v``."""
    steps, d = [], 1
    while d < M.shape[0]:
        steps.append((d, M[d:]))
        M = torch.cat([M[:d], M[d:] @ M[:-d]])
        d *= 2
    return steps


def _scan(steps, v):
    for d, M in steps:
        v = torch.cat([v[:d], v[d:] + (M @ v[:-d, :, None])[..., 0]])
    return v


def _block_tridiag_apply(factors, r):
    """Solve ``M x = r`` (N, 6) with ``_block_tridiag_factor``'s factors:
    the forward and the backward sweep, each a scan of ceil(log2 N) steps
    (the JAX package runs them as two sequential ``lax.scan``: the same
    linear maps, summed in another order)."""
    Dinv, forward, backward = factors
    y = _scan(forward, (Dinv @ r[:, :, None])[..., 0])
    return _scan(backward, y.flip(0)).flip(0)


def _block_tridiag_solve(D, U, r):
    """Solve the symmetric block-tridiagonal system M x = r (the JAX
    package's ``_block_tridiag_solve``): ``D`` (N,6,6) diagonal blocks,
    ``U`` (N,6,6) with ``U[i]`` the (i, i+1) block (``U[N-1]`` ignored),
    ``r`` (N,6).  Block Thomas."""
    return _block_tridiag_apply(_block_tridiag_factor(D, U), r)


def _pcg(matvec, precond, b, cg_iters: int, cg_tol: float):
    """Preconditioned CG from x = 0 until ``|r| <= cg_tol |b|`` or
    ``cg_iters`` iterations.  Each iteration is masked by the stop test of
    the state it starts from, and the host reads that test every
    ``CG_CHECK_EVERY`` iterations."""
    bnorm = torch.sqrt(torch.sum(b * b))
    x = torch.zeros_like(b)
    r = b
    z = precond(b)
    p = z
    rz = torch.sum(b * z)
    tiny = torch.tensor(1e-30, dtype=Float, device=b.device)
    zero = torch.zeros((), dtype=Float, device=b.device)
    for k in range(cg_iters):
        running = torch.sqrt(torch.sum(r * r)) > cg_tol * bnorm
        if k % CG_CHECK_EVERY == 0 and k and not bool(running):
            break
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        alpha = torch.where(pAp > 0.0, rz / torch.maximum(pAp, tiny), zero)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        rz_new = torch.sum(r_new * z_new)
        beta = torch.where(rz > 0.0, rz_new / torch.maximum(rz, tiny), zero)
        p_new = z_new + beta * p
        x, r, z, p, rz = (torch.where(running, new, old)
                          for new, old in ((x_new, x), (r_new, r), (z_new, z), (p_new, p), (rz_new, rz)))
    return x


def _solve_sparse_impl(graph: PoseGraph, max_iterations: int, cg_iters: int, cg_tol: float,
                       reduce=_identity) -> PGOResult:
    """The body of ``solve_sparse`` and ``solve_sparse_sharded``: ``reduce``
    sums every edge-accumulated quantity over the edge shards (the JAX
    package's ``reduce`` hook), applied before anything replicated is added."""
    N = graph.nodes.q.shape[0]
    device = graph.nodes.q.device
    inc = _incidence(graph, N, cells=False)
    mask = torch.ones((N, 6), dtype=Float, device=device)
    mask[0] = 0.0  # gauge-fix node 0
    chain = (graph.edge_j == graph.edge_i + 1).to(Float)
    eye6 = torch.eye(6, dtype=Float, device=device)
    diag6 = torch.arange(6, device=device)

    def step(nodes, lm):
        ji, jj, r = _edge_jacobians(graph, nodes)
        g, d = reduce((
            _node_sum(inc, -torch.einsum("eab,ea->eb", ji, r), -torch.einsum("eab,ea->eb", jj, r)),
            # the diagonal of H, for the Marquardt damping and its floor
            _node_sum(inc, torch.einsum("eab,eab->eb", ji, ji), torch.einsum("eab,eab->eb", jj, jj)),
        ))
        g = g * mask
        damp = lm * d + 1e-8

        def matvec(v):
            vm = v * mask
            rv = torch.einsum("eab,eb->ea", ji, vm[graph.edge_i]) + torch.einsum("eab,eb->ea", jj, vm[graph.edge_j])
            out = reduce(_node_sum(inc, torch.einsum("eab,ea->eb", ji, rv), torch.einsum("eab,ea->eb", jj, rv)))
            return mask * (out + damp * vm) + (1.0 - mask) * v

        Hii, Hjj, Hij = _edge_hessian_blocks(ji, jj)
        D, U = reduce((_node_sum(inc, Hii, Hjj), _node_sum(inc, Hij * chain[:, None, None], torch.zeros_like(Hij))))
        D[:, diag6, diag6] += damp
        # gauge: node 0's block is the identity, decoupled from node 1
        D[0] = eye6
        U[0] = 0.0
        factors = _block_tridiag_factor(D, U)

        def precond(v):
            return _block_tridiag_apply(factors, v * mask) * mask + (1.0 - mask) * v

        return _pcg(matvec, precond, g, cg_iters, cg_tol)

    return _lm(graph, max_iterations, step, reduce)


def solve_sparse(
    graph: PoseGraph,
    *,
    max_iterations: int = 20,
    cg_iters: int = 100,
    cg_tol: float = 1e-7,
) -> PGOResult:
    """LM pose-graph optimization exploiting chain + loop sparsity: each LM
    step solves the damped normal equations by PCG, the matrix applied edge
    by edge (O(E)), preconditioned by the exact block-tridiagonal chain part
    (damped diagonal and consecutive-edge couplings, block Thomas, O(N)).
    Same gauge (node 0 fixed), damping and accept/reject rule as ``solve``;
    the results match it to the CG tolerance.  Runs on the device of the
    graph's tensors."""
    return _solve_sparse_impl(graph, max_iterations, cg_iters, cg_tol)


def solve_sparse_sharded(
    graph: PoseGraph,
    mesh,
    axis: str = "graph",
    *,
    max_iterations: int = 20,
    cg_iters: int = 100,
    cg_tol: float = 1e-7,
) -> PGOResult:
    """``solve_sparse`` with the edges sharded over the ranks of
    ``mesh[axis]`` (``parallel.mesh``): every rank passes the whole graph,
    works on its ``E/n`` edges on its device, and every edge sum goes
    through one fixed-order cross-rank sum.  The nodes stay replicated; the
    result is the same on every rank and matches ``solve_sparse`` up to the
    f32 order of the sums.  The edges are padded to a multiple of the axis
    size with weight-0 self edges at node 0, which add exactly zero."""
    ag = collectives.axis_group(mesh, axis)
    n, rank = (1, 0) if ag is None else (ag.size, ag.rank)
    device = mesh.device
    E = graph.edge_i.shape[0]
    pad = (-E) % n
    edge_z = graph.edge_z.to(device)
    ident = pose_mod.identity(device)
    graph = PoseGraph(
        nodes=graph.nodes.to(device),
        edge_i=torch.cat([graph.edge_i.to(device), graph.edge_i.new_zeros(pad, device=device)]),
        edge_j=torch.cat([graph.edge_j.to(device), graph.edge_j.new_zeros(pad, device=device)]),
        edge_z=Pose(torch.cat([edge_z.q, ident.q.expand(pad, 4)]), torch.cat([edge_z.t, ident.t.expand(pad, 3)])),
        edge_weight=torch.cat([graph.edge_weight.to(device), graph.edge_weight.new_zeros(pad, device=device)]),
    )
    size = (E + pad) // n
    part = slice(rank * size, (rank + 1) * size)
    local = PoseGraph(nodes=graph.nodes, edge_i=graph.edge_i[part], edge_j=graph.edge_j[part],
                      edge_z=Pose(graph.edge_z.q[part], graph.edge_z.t[part]), edge_weight=graph.edge_weight[part])
    return _solve_sparse_impl(local, max_iterations, cg_iters, cg_tol,
                              reduce=lambda x: collectives.psum(x, mesh, axis))


def odometry_graph(nodes: Pose, loop_edges=(), noise_weight: float = 1.0) -> PoseGraph:
    """A chain pose graph from a trajectory plus optional loop edges.

    ``loop_edges`` is an iterable of ``(i, j, Pose)`` measured relative
    motions; trailing extras per edge are ignored, so
    ``models.loop_closure.detect_loops``'s ``(i, j, Z, energy)`` feed in
    directly.  The chain's measurements are the consecutive node estimates'
    relative motions, so every chain edge starts at zero residual and all
    correction comes from the loop edges.  The graph lives on the nodes'
    device."""
    N = nodes.q.shape[0]
    device = nodes.q.device
    chain_z = pose_mod.compose(pose_mod.inverse(Pose(nodes.q[:-1], nodes.t[:-1])), Pose(nodes.q[1:], nodes.t[1:]))
    loops = [tuple(edge[:3]) for edge in loop_edges]
    ii = list(range(N - 1)) + [int(i) for i, _, _ in loops]
    jj = list(range(1, N)) + [int(j) for _, j, _ in loops]
    zq = torch.cat([chain_z.q, *(z.q.to(device)[None] for _, _, z in loops)])
    zt = torch.cat([chain_z.t, *(z.t.to(device)[None] for _, _, z in loops)])
    return PoseGraph(
        nodes=nodes,
        edge_i=torch.tensor(ii, dtype=torch.int64, device=device),
        edge_j=torch.tensor(jj, dtype=torch.int64, device=device),
        edge_z=Pose(zq, zt),
        edge_weight=torch.full((len(ii),), noise_weight, dtype=Float, device=device),
    )
