"""The port's loop closure (``models/loop_closure.py``) against the JAX package.

``tests/test_loop_closure.py``'s setup (an out-and-back sequence of 15
frames at 120x160 with seed 41, 3 levels, cap 1024, and a drifted
trajectory), the same numpy poses and images through both packages:

- proposal: the same pairs in the same order, and the same note on stderr
  when the cap drops some; the grid equal to the all-pairs oracle;
- verification (the port on the CPU: the lane-axis solve's plain version,
  lane by lane): the same six verified pairs; ``Z_ij`` within ``atol=1e-4``
  of JAX's (measured 2.1e-7 in t, 5.3e-8 in q; the solves differ only in
  the order of their sums) and within ``test_loop_closure.py``'s
  ground-truth tolerances (t 8e-3, q 4e-3); energies within ``rtol=1e-2,
  atol=1e-2`` (mean squared intensities of 0.004-2; measured 2.7e-5
  absolute);
- the chain to the pose graph cuts the drifted ATE below 0.3x.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.core.camera import Intrinsics as JIntrinsics
from visual_odometry_rs_tpu.math.pose import Pose as JPose
from visual_odometry_rs_tpu.models import loop_closure as jlc
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.eval import ate as tate
from visual_odometry_rs_tpu_torch.math import pose as tpose
from visual_odometry_rs_tpu_torch.math import se3 as tse3
from visual_odometry_rs_tpu_torch.math.pose import Pose as TPose
from visual_odometry_rs_tpu_torch.models import loop_closure as tlc
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.parallel import pose_graph as tpg

torch.set_num_threads(1)

H, W = 120, 160
LC = dict(radius=0.25, min_gap=8, max_candidates=6, energy_accept=300.0)


def _jax_poses(poses):
    return [JPose(jnp.asarray(p.q.numpy()), jnp.asarray(p.t.numpy())) for p in poses]


@pytest.fixture(scope="module")
def loop_setup():
    """``tests/test_loop_closure.py::loop_setup`` in the port's math: 7
    frames out, 7 back, a systematic drift plus noise."""
    out = [[0.04, 0.004, 0.002, 0.002, -0.001, 0.001]] * 7
    back = [[-0.04, -0.004, -0.002, -0.002, 0.001, -0.001]] * 7
    seq = tsyn.generate_sequence(nb_frames=15, height=H, width=W, seed=41,
                                 twist_per_frame=np.asarray(out + back, np.float32))
    rng = np.random.default_rng(8)
    bias = np.asarray([0.004, -0.002, 0.001, 0.0008, 0.0005, -0.0004], np.float32)
    drift = [tpose.identity()]
    for _ in range(1, len(seq.poses)):
        step = tse3.exp(torch.as_tensor(bias + rng.normal(size=6) * 0.001, dtype=torch.float32))
        drift.append(tpose.compose(drift[-1], step))
    drifted = [tpose.compose(p, d) for p, d in zip(seq.poses, drift)]
    return seq, drifted


@pytest.fixture(scope="module")
def jax_edges(loop_setup):
    seq, drifted = loop_setup
    config = jtracker.TrackerConfig(height=H, width=W, nb_levels=3, candidate_cap=1024, interp_method="gather")
    intr = JIntrinsics(*(jnp.asarray(v.numpy()) for v in seq.intrinsics))
    return jlc.detect_loops(config, intr, _jax_poses(drifted), seq.depths, seq.grays, jlc.LoopClosureConfig(**LC))


def _proposals(module, poses, lc, node_ids=None):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        pairs = module.propose_candidates(poses, lc, node_ids=node_ids)
    return pairs, err.getvalue()


@pytest.mark.parametrize("max_candidates", [64, 3])
def test_proposals_equal_jax(loop_setup, max_candidates):
    _, drifted = loop_setup
    kw = dict(radius=0.25, min_gap=8, max_candidates=max_candidates)
    ids = [3 * k for k in range(len(drifted))]  # keyframe-like frame ids: the gap in frames
    for node_ids, gap in ((None, 8), (ids, 24)):
        kw["min_gap"] = gap
        out, out_err = _proposals(tlc, drifted, tlc.LoopClosureConfig(**kw), node_ids)
        ref, ref_err = _proposals(jlc, _jax_poses(drifted), jlc.LoopClosureConfig(**kw), node_ids)
        assert out == ref and out, (out, ref)
        assert out_err == ref_err
        assert ("dropping" in out_err) == (max_candidates == 3)
        for i, j in out:
            assert j <= 5 and i >= 9, (i, j)
    with pytest.raises(ValueError, match="min_gap"):
        tlc.propose_candidates(drifted, tlc.LoopClosureConfig(min_gap=-1))


def test_propose_grid_matches_bruteforce():
    """``test_loop_closure.py::test_propose_grid_matches_bruteforce`` by the
    port, and the port's pairs equal to the JAX package's."""
    rng = np.random.default_rng(5)
    poses = []
    for _ in range(120):
        t = rng.normal(scale=0.8, size=3).astype(np.float32)
        xi = np.concatenate([t * 0.0, rng.normal(scale=0.1, size=3)])
        poses.append(TPose(tse3.exp(torch.as_tensor(xi, dtype=torch.float32)).q, torch.from_numpy(t)))
    for lc in (dict(radius=0.5, min_gap=10, max_candidates=1000),
               dict(radius=1.2, max_angle=0.4, min_gap=5, max_candidates=7)):
        for ids in (None, list(rng.permutation(120))):
            got, _ = _proposals(tlc, poses, tlc.LoopClosureConfig(**lc), ids)
            assert got == tlc._propose_bruteforce(poses, tlc.LoopClosureConfig(**lc), node_ids=ids)
            assert got == _proposals(jlc, _jax_poses(poses), jlc.LoopClosureConfig(**lc), ids)[0]


def test_detect_loops_matches_jax(loop_setup, jax_edges):
    seq, drifted = loop_setup
    config = ttracker.TrackerConfig(height=H, width=W, nb_levels=3, candidate_cap=1024)
    edges = tlc.detect_loops(config, seq.intrinsics, drifted, seq.depths, seq.grays, tlc.LoopClosureConfig(**LC),
                             device="cpu")
    assert edges and [(i, j) for i, j, _, _ in edges] == [(i, j) for i, j, _, _ in jax_edges]
    for (i, j, z, energy), (_, _, jz, jenergy) in zip(edges, jax_edges):
        assert z.q.device.type == "cpu" and energy <= 300.0
        np.testing.assert_allclose(z.t.numpy(), np.asarray(jz.t), atol=1e-4)
        np.testing.assert_allclose(z.q.numpy(), np.asarray(jz.q), atol=1e-4)
        np.testing.assert_allclose(energy, float(jenergy), rtol=1e-2, atol=1e-2)
        gt = tpose.compose(tpose.inverse(seq.poses[i]), seq.poses[j])
        np.testing.assert_allclose(z.t.numpy(), gt.t.numpy(), atol=8e-3)
        np.testing.assert_allclose(z.q.numpy(), gt.q.numpy(), atol=4e-3)


def test_verify_pairs_lane_axis(loop_setup):
    """The verification lanes: one lane a pair, the per-lane gathered
    keyframe and image index equal to one-lane solves of each pair."""
    seq, drifted = loop_setup
    config = ttracker.TrackerConfig(height=H, width=W, nb_levels=3, candidate_cap=1024)
    pairs = [(12, 2), (13, 1), (12, 1)]  # keyframe 12 twice, frame 1 twice
    ver = tlc.verify_pairs(config, seq.intrinsics, drifted, seq.depths, seq.grays, pairs, device="cpu")
    assert ver.model.q.shape == (3, 4) and ver.energy.shape == ver.inside_frac.shape == ver.failed.shape == (3,)
    for k, pair in enumerate(pairs):
        one = tlc.verify_pairs(config, seq.intrinsics, drifted, seq.depths, seq.grays, [pair], device="cpu")
        assert torch.equal(one.model.q[0], ver.model.q[k]) and torch.equal(one.model.t[0], ver.model.t[k])
        assert torch.equal(one.energy[0], ver.energy[k]) and torch.equal(one.inside_frac[0], ver.inside_frac[k])
        assert 0.3 <= float(ver.inside_frac[k]) <= 1.0


def test_loop_closure_pgo_reduces_ate(loop_setup):
    """The front end to the back end, by the port: drift in, loops out,
    the ATE down by more than 3x."""
    seq, drifted = loop_setup
    config = ttracker.TrackerConfig(height=H, width=W, nb_levels=3, candidate_cap=1024)
    edges = tlc.detect_loops(config, seq.intrinsics, drifted, seq.depths, seq.grays, tlc.LoopClosureConfig(**LC),
                             device="cpu")
    nodes = TPose(torch.stack([p.q for p in drifted]), torch.stack([p.t for p in drifted]))
    result = tpg.solve(tpg.odometry_graph(nodes, loop_edges=edges), max_iterations=30)
    optimized = [TPose(result.nodes.q[k], result.nodes.t[k]) for k in range(len(drifted))]
    before, after = tate.ate_rmse(drifted, seq.poses), tate.ate_rmse(optimized, seq.poses)
    assert after < 0.3 * before, (before, after)


def test_detect_loops_needs_cuda_by_default(loop_setup):
    seq, drifted = loop_setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    config = ttracker.TrackerConfig(height=H, width=W, nb_levels=3, candidate_cap=1024)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlc.detect_loops(config, seq.intrinsics, drifted, seq.depths, seq.grays, tlc.LoopClosureConfig(**LC))
