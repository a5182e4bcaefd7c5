"""The port's pose graph (``parallel/pose_graph.py``) against the JAX package.

The pose-graph tests of ``tests/test_ba.py`` (chain with a loop, an exact
chain, sparse against dense, 320 nodes, the 4-tuple edges), run by the port,
and the same numpy graphs through both packages.  Tolerances, with the
values measured on the CPU beside them:

- Per-edge residuals and Jacobians: ``atol=2e-6`` (measured 6.2e-7 on the
  320-node graph).  The chain's measurements: ``atol=1e-6`` (4.8e-7).
- The block-tridiagonal solve against JAX's: ``atol=1e-6`` on solutions of
  size 0.3 (measured 6.0e-8; the port's sweeps are doubling scans, JAX's
  sequential scans).
- Solves: energy ``rtol=1e-3`` (the ``test_ba`` tolerance); the port's dense
  nodes against JAX's dense nodes ``atol=1e-5`` (measured 1.6e-7).  The
  sparse solve's nodes against the dense solve's ``atol=5e-5`` (measured
  1.4e-5): the LM stops in a flat tail where the last polishing step (1.8e-5
  on this graph) is accepted or rejected on f32 rounding of the energy
  (about 3e-9 on E = 1.25e-3), which decides differently with another
  summation order (ROADMAP C2).  ``test_ba`` holds the JAX package's pair at
  1e-5; the port's pair lands one polishing step apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.math import pose as jpose
from visual_odometry_rs_tpu.math import se3 as jse3
from visual_odometry_rs_tpu.math.pose import Pose as JPose
from visual_odometry_rs_tpu.parallel import pose_graph as jpg
from visual_odometry_rs_tpu_torch.eval import ate as tate
from visual_odometry_rs_tpu_torch.math import pose as tpose
from visual_odometry_rs_tpu_torch.math import se3 as tse3
from visual_odometry_rs_tpu_torch.math.pose import Pose as TPose
from visual_odometry_rs_tpu_torch.parallel import mesh as tmesh
from visual_odometry_rs_tpu_torch.parallel import pose_graph as tpg

torch.set_num_threads(1)


def _loopy_graph(N, nloops, seed=0, drift_scale=0.01):
    """``tests/test_ba.py::_loopy_graph``: chain + random long-range loop
    edges with ground-truth measurements (JAX)."""
    rng = np.random.default_rng(seed)
    gt = [jpose.identity()]
    for _ in range(1, N):
        gt.append(jpose.compose(gt[-1], jse3.exp(jnp.asarray(rng.normal(size=6) * 0.05, jnp.float32))))
    drift = [jpose.identity()]
    for _ in range(1, N):
        drift.append(jpose.compose(drift[-1], jse3.exp(jnp.asarray(rng.normal(size=6) * drift_scale, jnp.float32))))
    nodes = JPose(
        jnp.stack([jpose.compose(p, d).q for p, d in zip(gt, drift)]),
        jnp.stack([jpose.compose(p, d).t for p, d in zip(gt, drift)]),
    )
    loops = []
    for _ in range(nloops):
        i = int(rng.integers(N // 2, N))
        j = int(rng.integers(0, N // 4))
        loops.append((i, j, jpose.compose(jpose.inverse(gt[i]), gt[j])))
    return jpg.odometry_graph(nodes, loop_edges=loops), gt


def _port_loopy_graph(N, nloops, seed=0, drift_scale=0.01):
    """``_loopy_graph`` in the port's math (the same draws)."""
    rng = np.random.default_rng(seed)

    def exp(scale):
        return tse3.exp(torch.tensor(rng.normal(size=6) * scale, dtype=torch.float32))

    gt = [tpose.identity()]
    for _ in range(1, N):
        gt.append(tpose.compose(gt[-1], exp(0.05)))
    drift = [tpose.identity()]
    for _ in range(1, N):
        drift.append(tpose.compose(drift[-1], exp(drift_scale)))
    est = [tpose.compose(p, d) for p, d in zip(gt, drift)]
    loops = []
    for _ in range(nloops):
        i = int(rng.integers(N // 2, N))
        j = int(rng.integers(0, N // 4))
        loops.append((i, j, tpose.compose(tpose.inverse(gt[i]), gt[j])))
    return tpg.odometry_graph(TPose(torch.stack([p.q for p in est]), torch.stack([p.t for p in est])), loops)


def _tensor(x):
    return torch.from_numpy(np.array(x))


def _port_graph(g) -> tpg.PoseGraph:
    return tpg.PoseGraph(
        nodes=TPose(_tensor(g.nodes.q), _tensor(g.nodes.t)),
        edge_i=_tensor(g.edge_i).long(), edge_j=_tensor(g.edge_j).long(),
        edge_z=TPose(_tensor(g.edge_z.q), _tensor(g.edge_z.t)), edge_weight=_tensor(g.edge_weight),
    )


@pytest.fixture(scope="module")
def graph60():
    """The 60-node, 4-loop graph, and the JAX package's dense solve of it."""
    g, _ = _loopy_graph(60, 4)
    return g, _port_graph(g), jpg.solve(g, max_iterations=20)


def test_edge_jacobians_and_chain_match(graph60):
    g, tg, _ = graph60
    ji, jj, r = (np.asarray(x) for x in jax.jit(lambda g: jpg._edge_jacobians(g, g.nodes))(g))
    ti, tj, tr = tpg._edge_jacobians(tg, tg.nodes)
    assert ti.dtype == tj.dtype == torch.float32
    np.testing.assert_allclose(ti.numpy(), ji, atol=2e-6)
    np.testing.assert_allclose(tj.numpy(), jj, atol=2e-6)
    np.testing.assert_allclose(tr.numpy(), r, atol=2e-6)
    np.testing.assert_allclose(tpg.residuals(tg, tg.nodes).numpy(), r, atol=2e-6)
    # the chain measurements from the node estimates, then the loop edges
    loops = [(int(i), int(j), TPose(tg.edge_z.q[e], tg.edge_z.t[e]))
             for e, (i, j) in enumerate(zip(tg.edge_i.tolist(), tg.edge_j.tolist())) if e >= 59]
    built = tpg.odometry_graph(tg.nodes, loop_edges=loops)
    assert torch.equal(built.edge_i, tg.edge_i) and torch.equal(built.edge_j, tg.edge_j)
    np.testing.assert_allclose(built.edge_z.q.numpy(), tg.edge_z.q.numpy(), atol=1e-6)
    np.testing.assert_allclose(built.edge_z.t.numpy(), tg.edge_z.t.numpy(), atol=1e-6)
    assert torch.equal(built.edge_weight, tg.edge_weight)


@pytest.mark.parametrize("N", [1, 2, 7, 320])
def test_block_tridiag_solve_matches(N):
    rng = np.random.default_rng(N)
    J = rng.normal(size=(N, 6, 6)).astype(np.float32)
    D = (np.einsum("nab,nac->nbc", J, J) + 12 * np.eye(6)).astype(np.float32)
    U = (1.5 * rng.normal(size=(N, 6, 6))).astype(np.float32)
    r = rng.normal(size=(N, 6)).astype(np.float32)
    ref = np.asarray(jpg._block_tridiag_solve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(r)))
    out = tpg._block_tridiag_solve(torch.from_numpy(D), torch.from_numpy(U), torch.from_numpy(r))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def test_pose_graph_chain_noise_with_loop_closure():
    """``test_ba.py::test_pose_graph_chain_noise_with_loop_closure`` by the
    port: the loop edge pulls the chain's far end halfway back at least."""
    rng = np.random.default_rng(3)
    N = 12
    gt = [tpose.identity()]
    step = tse3.exp(torch.tensor([0.5, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / N]))
    for _ in range(N - 1):
        gt.append(tpose.compose(gt[-1], step))
    drifted = [gt[0]]
    for i in range(N - 1):
        z = tpose.compose(tpose.inverse(gt[i]), gt[i + 1])
        noise = tse3.exp(torch.tensor(0.02 * rng.normal(size=6), dtype=torch.float32))
        drifted.append(tpose.compose(drifted[-1], tpose.compose(z, noise)))
    nodes = TPose(torch.stack([p.q for p in drifted]), torch.stack([p.t for p in drifted]))
    z_loop = tpose.compose(tpose.inverse(gt[0]), gt[-1])
    graph = tpg.odometry_graph(nodes, loop_edges=[(0, N - 1, z_loop)])
    result = tpg.solve(graph)
    optimized = [TPose(result.nodes.q[i], result.nodes.t[i]) for i in range(N)]
    end_before = float(torch.linalg.norm(drifted[-1].t - gt[-1].t))
    end_after = float(torch.linalg.norm(optimized[-1].t - gt[-1].t))
    assert end_after < 0.5 * end_before, (end_before, end_after)
    assert tate.ate_rmse(optimized, gt) <= tate.ate_rmse(drifted, gt) * 1.05


def test_pose_graph_exact_chain_stays_put():
    gt = [tpose.identity()]
    step = tse3.exp(torch.tensor([0.1, 0.02, 0.0, 0.01, 0.0, 0.05]))
    for _ in range(5):
        gt.append(tpose.compose(gt[-1], step))
    nodes = TPose(torch.stack([p.q for p in gt]), torch.stack([p.t for p in gt]))
    for solver in (tpg.solve, tpg.solve_sparse):
        result = solver(tpg.odometry_graph(nodes))
        assert float(result.energy) < 1e-8
        np.testing.assert_allclose(result.nodes.t.numpy(), nodes.t.numpy(), atol=1e-5)


def test_pose_graph_sparse_matches_dense(graph60):
    """Both solves of the port against the JAX package's dense solve, and
    against each other (tolerances in the module docstring)."""
    _, tg, ref = graph60
    dense = tpg.solve(tg, max_iterations=20)
    sparse = tpg.solve_sparse(tg, max_iterations=20)
    for res in (dense, sparse):
        assert res.nb_iter.dtype == torch.int32 and 1 <= int(res.nb_iter) <= 20
        np.testing.assert_allclose(float(res.energy), float(ref.energy), rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(dense.nodes.t.numpy(), np.asarray(ref.nodes.t), atol=1e-5)
    np.testing.assert_allclose(dense.nodes.q.numpy(), np.asarray(ref.nodes.q), atol=1e-5)
    np.testing.assert_allclose(sparse.nodes.t.numpy(), dense.nodes.t.numpy(), atol=5e-5)
    np.testing.assert_allclose(sparse.nodes.q.numpy(), dense.nodes.q.numpy(), atol=5e-5)
    # two runs are bit-equal (every sum over a node's edges in a fixed order)
    again = tpg.solve_sparse(tg, max_iterations=20)
    assert torch.equal(again.nodes.q, sparse.nodes.q) and torch.equal(again.nodes.t, sparse.nodes.t)


def test_pose_graph_sparse_scales_to_hundreds_of_nodes():
    """``test_ba.py::test_pose_graph_sparse_scales_to_hundreds_of_nodes`` by
    the port: the energy falls under 1% of its start, and every loop edge's
    relative pose snaps to its measurement."""
    tg = _port_loopy_graph(320, 8)
    e0 = float(torch.sum(tpg.residuals(tg, tg.nodes) ** 2))
    result = tpg.solve_sparse(tg, max_iterations=20)
    assert float(result.energy) < 0.01 * e0, (e0, float(result.energy))
    for e in range(319, 327):
        i, j = int(tg.edge_i[e]), int(tg.edge_j[e])
        z = TPose(tg.edge_z.q[e], tg.edge_z.t[e])
        rel = tpose.compose(tpose.inverse(TPose(result.nodes.q[i], result.nodes.t[i])),
                            TPose(result.nodes.q[j], result.nodes.t[j]))
        before = tpose.compose(tpose.inverse(TPose(tg.nodes.q[i], tg.nodes.t[i])), TPose(tg.nodes.q[j], tg.nodes.t[j]))
        err, err_before = float(torch.linalg.norm(rel.t - z.t)), float(torch.linalg.norm(before.t - z.t))
        assert err < 0.1 * max(err_before, 1e-6) or err < 1e-3, (e, err_before, err)


def test_odometry_graph_accepts_detect_loops_tuples():
    gt = [tpose.identity()]
    step = tse3.exp(torch.tensor([0.1, 0.0, 0.0, 0.0, 0.0, 0.02]))
    for _ in range(4):
        gt.append(tpose.compose(gt[-1], step))
    nodes = TPose(torch.stack([p.q for p in gt]), torch.stack([p.t for p in gt]))
    z = tpose.compose(tpose.inverse(gt[3]), gt[0])
    g3 = tpg.odometry_graph(nodes, loop_edges=[(3, 0, z)])
    g4 = tpg.odometry_graph(nodes, loop_edges=[(3, 0, z, 42.0)])
    assert torch.equal(g3.edge_i, g4.edge_i) and torch.equal(g3.edge_z.t, g4.edge_z.t)
    assert g3.edge_i.tolist() == [0, 1, 2, 3, 3] and g3.edge_j.tolist() == [1, 2, 3, 4, 0]


def test_sharded_solve_names_the_multi_gpu_item(graph60):
    """On a mesh axis of one device the edge-sharded solve is
    ``solve_sparse`` bit for bit; an axis of several local devices is
    refused (``tests/test_torch_sharded.py`` runs it on 4 ranks)."""
    one = tmesh.make_mesh((1,), ("graph",), devices=["cpu"])
    got = tpg.solve_sparse_sharded(graph60[1], one, max_iterations=3)
    ref = tpg.solve_sparse(graph60[1], max_iterations=3)
    for a, b in zip(got, ref):
        assert all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) else torch.equal(a, b)
    with pytest.raises(ValueError, match="process group"):
        tpg.solve_sparse_sharded(graph60[1], tmesh.make_mesh((2,), ("graph",), devices=["cpu"] * 2))
