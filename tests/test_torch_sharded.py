"""The port's sharded solves on 4 gloo ranks (one process a rank, torch and
the port only), against the JAX package and the port's single-device
solves: the mirror of the JAX tests that set each tolerance.  Beside each
tolerance, the value measured on the CPU.

- ``sharded.solve_level_point_sharded`` (``tests/test_parallel.py:109``):
  level 0 of ``test_parallel.py``'s 48x64 keyframe (cap 256, 64 candidates a
  rank), frame 1 against it.  Against JAX's sharded solve on 4 devices, the
  port's unsharded ``solve_level`` (the Python LM loop on the CPU) and
  JAX's: ``t`` within 1e-5 (measured 1.5e-8, 3.9e-8 and 1.1e-8), ``q``
  within 1e-6 (2.2e-9, 3.7e-9 and 2.7e-9), not failed, the same iteration count
  (4 in all four).  The two-process solve of
  ``tests/test_multiprocess.py:117`` runs on a subgroup of ranks 0 and 1: a
  token summed across them, then level 1 within 5e-5 of the local solve
  (2.8e-8).  A candidate count that the ranks do not divide raises
  ``ValueError``.
- ``ba.solve_point_sharded`` (``tests/test_ba.py:100``, ``:176``,
  ``tests/test_collectives.py:74``, ``:99``), each problem also through
  JAX's ``solve_point_sharded`` on 4 devices: ``psum`` at K=3, P=64 against
  the port's ``solve`` and JAX's (poses ``atol=5e-4``: 7.5e-8 and 9.9e-7;
  energy ``rtol=0.3, atol=1e-6``, all about 1e-8); ``psum`` and ``ring`` at
  K=8 against each other and against JAX's (poses ``atol=5e-4``: 5.4e-7,
  1.9e-6, 1.7e-6; energy ``rtol=0.1, atol=1e-6``: all about 3e-8, 14-17%
  apart at that floor); ``ring`` at K=16, P=256 to the ground truth (energy
  below 1e-4: 2.6e-7; ATE below 1e-3: 6.3e-5) and to JAX's poses
  (``atol=5e-4``: 4.2e-6); ``ring`` with K=3 raises JAX's ``ValueError``.
- ``photometric_ba.solve_window_sharded`` (``tests/test_photometric_ba.py:157``,
  ``:228``, ``:279``) against the port's ``solve_window`` and JAX's
  ``solve_window_sharded`` on 4 devices, on a 4-frame 64x80 window (cap
  256): plain (poses ``atol=1e-4``: 9.2e-7 and 2.7e-7; depths
  ``atol=1e-4``: 2.3e-6 and 2.1e-6; energy ``rtol=1e-3``: 1.5e-6 and
  2.4e-6), brightness on an exposure drift (poses ``atol=2e-4``: 2.3e-7 and
  1.7e-7; gain and bias ``atol=1e-2``: 5.9e-5 and 5.3e-5), a pose prior
  (poses ``atol=5e-5``: 2.0e-6 and 6.4e-7; energy ``rtol=1e-4``: 7.0e-7 and
  1.2e-6).
- ``pose_graph.solve_sparse_sharded`` (``tests/test_ba.py:291``): the
  60-node graph with 8 loops (67 edges, padded to 68) against the port's
  ``solve_sparse`` and JAX's ``solve_sparse_sharded`` on 4 devices: energy
  ``rtol=1e-4`` (1.3e-6 and 8.2e-7), nodes ``atol=1e-5`` (3.4e-6 and
  3.2e-6).  The iteration counts differ (12 against 3 and 4: ROADMAP C2,
  the last accept decided on f32 noise of the energy), as JAX's test
  allows.

The JAX solves run in this process while the ranks run (``run_ranks``'s
``meanwhile``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ba import make_problem
from test_torch_collectives import run_ranks
from test_torch_pose_graph import _port_loopy_graph

from visual_odometry_rs_tpu.core import camera as jcamera
from visual_odometry_rs_tpu.dataset import synthetic as jsyn
from visual_odometry_rs_tpu.math import pose as jpose
from visual_odometry_rs_tpu.models import photometric_ba as jpba
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu.ops import pyramid as jpyramid
from visual_odometry_rs_tpu.parallel import ba as jba
from visual_odometry_rs_tpu.parallel import mesh as jmesh
from visual_odometry_rs_tpu.parallel import pose_graph as jpg
from visual_odometry_rs_tpu.parallel import sharded as jsharded
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.eval import ate
from visual_odometry_rs_tpu_torch.math import pose as tpose
from visual_odometry_rs_tpu_torch.math import se3 as tse3
from visual_odometry_rs_tpu_torch.math.pose import Pose
from visual_odometry_rs_tpu_torch.models import photometric_ba as tpba
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.ops import pyramid as tpyramid
from visual_odometry_rs_tpu_torch.parallel import ba as tba
from visual_odometry_rs_tpu_torch.parallel import pose_graph as tpg

torch.set_num_threads(1)

N = 4
WIN_H, WIN_W, WIN_F = 64, 80, 4
GAINS, BIASES = [1.0, 1.2, 0.85, 1.15], [0.0, 12.0, -10.0, 8.0]
LEVEL_FIELDS = ("xs", "ys", "idepth", "valid", "tmpl_vals", "jacobians")
# the BA problems of the ranks: make_problem's arguments, solve_point_sharded's options
BA_CASES = {
    "ba_psum": (dict(K=3, P=64, seed=2), dict()),
    "ba8_psum": (dict(K=8, P=64, seed=3), dict(assembly="psum")),
    "ba8_ring": (dict(K=8, P=64, seed=3), dict(assembly="ring")),
    "ba16_ring": (dict(K=16, P=256, seed=5, perturb=0.01), dict(assembly="ring", max_iterations=20)),
}

PROGRAM = r'''
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.core.camera import Intrinsics
from visual_odometry_rs_tpu_torch.math import pose as pose_mod
from visual_odometry_rs_tpu_torch.math.pose import Pose
from visual_odometry_rs_tpu_torch.models import photometric_ba, tracker
from visual_odometry_rs_tpu_torch.parallel import ba, pose_graph, sharded

def level(prefix):
    k = Intrinsics(*(torch.tensor(v) for v in inputs[prefix + "k"]))
    return tracker.LevelObs(intrinsics=k, template=torch.from_numpy(inputs[prefix + "template"]),
                            **{f: torch.from_numpy(inputs[prefix + f]) for f in LEVEL_FIELDS})

def save_pose(name, p):
    out[name + "_q"], out[name + "_t"] = p.q.numpy(), p.t.numpy()

# the level solve, 64 candidates a rank
model, failed, nb_iter = sharded.solve_level_point_sharded(
    level("l0_"), torch.from_numpy(inputs["img1"]), pose_mod.identity(), mesh, "x")
save_pose("level", model)
out["level_failed"], out["level_iters"] = np.array(failed), np.array(nb_iter)
try:
    cut = level("l0_")._replace(**{f: torch.from_numpy(inputs["l0_" + f][:254]) for f in LEVEL_FIELDS})
    sharded.solve_level_point_sharded(cut, torch.from_numpy(inputs["img1"]), pose_mod.identity(), mesh, "x")
    out["level_ragged_raised"] = np.array(False)
except ValueError:
    out["level_ragged_raised"] = np.array(True)

# the two-process solve on ranks 0 and 1
pair = dist.new_group([0, 1])
if rank < 2:
    two = mesh_mod.make_mesh((2,), ("points",), devices=["cpu"], groups={"points": pair})
    out["token"] = collectives.psum(torch.arange(3, dtype=torch.float32) + 3 * rank, two, "points").numpy()
    model, failed, nb_iter = sharded.solve_level_point_sharded(
        level("l1_"), torch.from_numpy(inputs["img1_l1"]), pose_mod.identity(), two, "points")
    save_pose("pair", model)
    out["pair_failed"] = np.array(failed)

# the geometric BA, its problems drawn from their seeds
def by_point(problem, n):
    order = torch.argsort(problem.obs_pt, stable=True)
    shard = problem.points.shape[0] // n
    return problem._replace(obs_kf=problem.obs_kf[order], obs_pt=problem.obs_pt[order] % shard,
                            obs_uv=problem.obs_uv[order], obs_mask=problem.obs_mask[order])

def save_ba(name, res):
    save_pose(name, res.poses)
    out[name + "_points"], out[name + "_energy"] = res.points.numpy(), res.energy.numpy()

p3 = by_point(ba.synthetic_problem(K=3, P=64, seed=2)[0], world)
save_ba("ba_psum", ba.solve_point_sharded(p3, mesh, "x"))
p8 = by_point(ba.synthetic_problem(K=8, P=64, seed=3)[0], world)
save_ba("ba8_psum", ba.solve_point_sharded(p8, mesh, "x", assembly="psum"))
save_ba("ba8_ring", ba.solve_point_sharded(p8, mesh, "x", assembly="ring"))
p16 = by_point(ba.synthetic_problem(K=16, P=256, seed=5, perturb=0.01)[0], world)
save_ba("ba16_ring", ba.solve_point_sharded(p16, mesh, "x", assembly="ring", max_iterations=20))
try:
    ba.solve_point_sharded(p3, mesh, "x", assembly="ring")
    out["ba_ring_k3"] = np.array("")
except ValueError as e:
    out["ba_ring_k3"] = np.array(str(e))

# the photometric window
def window(images, poses):
    return photometric_ba.Window(
        tmpl_xs=torch.from_numpy(inputs["w_xs"]), tmpl_ys=torch.from_numpy(inputs["w_ys"]),
        tmpl_vals=torch.from_numpy(inputs["w_tmpl"]), valid=torch.from_numpy(inputs["w_valid"]),
        idepth=torch.from_numpy(inputs["w_idepth"]), poses=poses, images=torch.from_numpy(images),
        intrinsics=Intrinsics(*(torch.tensor(v) for v in inputs["w_k"])))

def save_window(name, res):
    save_pose(name, res.poses)
    out[name + "_idepth"], out[name + "_energy"], out[name + "_ab"] = (
        res.idepth.numpy(), res.energy.numpy(), res.ab.numpy())

init = Pose(torch.from_numpy(inputs["w_init_q"]), torch.from_numpy(inputs["w_init_t"]))
save_window("win", photometric_ba.solve_window_sharded(window(inputs["w_images"], init), mesh, "x",
                                                       max_iterations=10))
bright = Pose(torch.from_numpy(inputs["w_bright_q"]), torch.from_numpy(inputs["w_bright_t"]))
save_window("win_bright", photometric_ba.solve_window_sharded(window(inputs["w_drifted"], bright), mesh, "x",
                                                              max_iterations=8, brightness=True))
prior = (torch.from_numpy(inputs["w_Hp"]), init)
save_window("win_prior", photometric_ba.solve_window_sharded(window(inputs["w_images"], init), mesh, "x",
                                                             pose_prior=prior, max_iterations=8))

# the pose graph, 67 edges padded to 68
graph = pose_graph.PoseGraph(
    nodes=Pose(torch.from_numpy(inputs["g_q"]), torch.from_numpy(inputs["g_t"])),
    edge_i=torch.from_numpy(inputs["g_i"]), edge_j=torch.from_numpy(inputs["g_j"]),
    edge_z=Pose(torch.from_numpy(inputs["g_zq"]), torch.from_numpy(inputs["g_zt"])),
    edge_weight=torch.from_numpy(inputs["g_w"]))
res = pose_graph.solve_sparse_sharded(graph, mesh, "x", max_iterations=15)
save_pose("pgo", res.nodes)
out["pgo_energy"], out["pgo_iters"] = res.energy.numpy(), res.nb_iter.numpy()
'''.replace("LEVEL_FIELDS", repr(LEVEL_FIELDS))


def _level_inputs(prefix, obs):
    arrays = {prefix + f: np.asarray(getattr(obs, f)) for f in LEVEL_FIELDS}
    arrays[prefix + "template"] = np.asarray(obs.template)
    arrays[prefix + "k"] = np.array([np.asarray(v) for v in obs.intrinsics], np.float32)
    return arrays


def _drifted(images):
    out = images.copy()
    for f, (g, b) in enumerate(zip(GAINS, BIASES)):
        out[f] = np.clip(g * out[f] + b, 0, 255)
    return out


def _perturbed(gt: Pose, scale, seed) -> Pose:
    rng = np.random.default_rng(seed)
    xis = (rng.normal(size=(gt.q.shape[0], 6)) * scale).astype(np.float32)
    xis[0] = 0.0
    return tpose.compose(gt, tse3.exp(torch.from_numpy(xis)))


def _window_inputs():
    seq = tsyn.generate_sequence(nb_frames=WIN_F, height=WIN_H, width=WIN_W, seed=3, motion_scale=0.02)
    config = ttracker.TrackerConfig(height=WIN_H, width=WIN_W, nb_levels=2, candidate_cap=256)
    kf = ttracker.precompute_keyframe(config, seq.intrinsics, torch.from_numpy(seq.depths[0].astype(np.int32)),
                                      tpyramid.mean_pyramid(2, torch.from_numpy(seq.grays[0])))
    rel = [tpose.compose(tpose.inverse(p), seq.poses[0]) for p in seq.poses]
    gt = Pose(torch.stack([p.q for p in rel]), torch.stack([p.t for p in rel]))
    images = np.stack(seq.grays).astype(np.float32)
    init, bright = _perturbed(gt, 3e-3, seed=2), _perturbed(gt, 2e-3, seed=6)
    Hp = np.zeros((WIN_F, 6, WIN_F, 6), np.float32)
    for f in range(1, WIN_F):
        Hp[f, :, f, :] = 50.0 * np.eye(6)
    obs = kf.levels[0]
    arrays = {
        "w_xs": obs.xs.numpy(), "w_ys": obs.ys.numpy(), "w_tmpl": obs.tmpl_vals.numpy(),
        "w_valid": obs.valid.numpy(), "w_idepth": obs.idepth.numpy(),
        "w_k": np.array([v.item() for v in obs.intrinsics], np.float32), "w_images": images,
        "w_drifted": _drifted(images), "w_Hp": Hp,
        "w_init_q": init.q.numpy(), "w_init_t": init.t.numpy(), "w_bright_q": bright.q.numpy(),
        "w_bright_t": bright.t.numpy(),
    }

    def win(images, poses):
        return tpba.window_from_tracking(config, seq.intrinsics, kf.levels, torch.from_numpy(images), poses)

    single = {
        "win": tpba.solve_window(win(images, init), max_iterations=10),
        "win_bright": tpba.solve_window(win(arrays["w_drifted"], bright), max_iterations=8, brightness=True),
        "win_prior": tpba.solve_window(win(images, init), pose_prior=(torch.from_numpy(Hp), init), max_iterations=8),
    }
    return arrays, single


def _ba_single():
    out = {}
    for name, kw in (("ba_psum", dict(K=3, P=64, seed=2)), ("ba16_ring", dict(K=16, P=256, seed=5, perturb=0.01))):
        problem, gt_poses, _ = tba.synthetic_problem(**kw)
        out[name] = (tba.solve(problem), problem, gt_poses)
    return out


def _jax_by_point(problem):
    """``problem``'s observations ordered by point, each indexing its shard."""
    order = jnp.argsort(problem.obs_pt, stable=True)
    shard = problem.points.shape[0] // N
    return problem._replace(obs_kf=problem.obs_kf[order], obs_pt=problem.obs_pt[order] % shard,
                            obs_uv=problem.obs_uv[order], obs_mask=problem.obs_mask[order])


def _jax_sharded(inputs, kf, img1) -> dict:
    """JAX's own solves of the ranks' problems, the sharded ones on 4 of the
    8 virtual CPU devices, each under ``jax.jit`` (a ``shard_map`` called
    outside one dispatches op by op: 100 s for a window)."""
    devices = jax.devices()[:N]
    points, graph_axis = (jmesh.make_mesh((N,), (axis,), devices=devices) for axis in ("points", "graph"))
    out = {
        "level_ref": jax.jit(lambda o, i: jtracker.solve_level(o, i, jpose.identity()))(kf.levels[0], img1),
        "level": jax.jit(lambda o, i: jsharded.solve_level_point_sharded(o, i, jpose.identity(), points))(
            kf.levels[0], img1),
    }
    for name, (kw, opts) in BA_CASES.items():
        out[name] = jax.jit(lambda p, o=opts: jba.solve_point_sharded(p, points, **o))(
            _jax_by_point(make_problem(**kw)[0]))

    def window(images, prefix):
        return jpba.Window(
            tmpl_xs=jnp.asarray(inputs["w_xs"]), tmpl_ys=jnp.asarray(inputs["w_ys"]),
            tmpl_vals=jnp.asarray(inputs["w_tmpl"]), valid=jnp.asarray(inputs["w_valid"]),
            idepth=jnp.asarray(inputs["w_idepth"]), images=jnp.asarray(images),
            poses=jpose.Pose(jnp.asarray(inputs[prefix + "_q"]), jnp.asarray(inputs[prefix + "_t"])),
            intrinsics=jcamera.Intrinsics.make(*inputs["w_k"]))

    def solve_window(win, *prior, **opts):
        return jax.jit(lambda w, *p: jpba.solve_window_sharded(w, points, pose_prior=p or None, **opts))(win, *prior)

    init = jpose.Pose(jnp.asarray(inputs["w_init_q"]), jnp.asarray(inputs["w_init_t"]))
    out["win"] = solve_window(window(inputs["w_images"], "w_init"), max_iterations=10)
    out["win_bright"] = solve_window(window(inputs["w_drifted"], "w_bright"), max_iterations=8, brightness=True)
    out["win_prior"] = solve_window(window(inputs["w_images"], "w_init"), jnp.asarray(inputs["w_Hp"]), init,
                                    max_iterations=8)
    graph = jpg.PoseGraph(
        nodes=jpose.Pose(jnp.asarray(inputs["g_q"]), jnp.asarray(inputs["g_t"])),
        edge_i=jnp.asarray(inputs["g_i"]), edge_j=jnp.asarray(inputs["g_j"]),
        edge_z=jpose.Pose(jnp.asarray(inputs["g_zq"]), jnp.asarray(inputs["g_zt"])),
        edge_weight=jnp.asarray(inputs["g_w"]))
    out["pgo"] = jax.jit(lambda g: jpg.solve_sparse_sharded(g, graph_axis, max_iterations=15))(graph)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    seq = jsyn.generate_sequence(nb_frames=3, height=48, width=64, seed=0)
    config = jtracker.TrackerConfig(height=48, width=64, nb_levels=3, candidate_cap=256)
    kf = jax.jit(lambda d, p: jtracker.precompute_keyframe(config, seq.intrinsics, d, p))(
        jnp.asarray(seq.depths[0]), jpyramid.mean_pyramid(3, jnp.asarray(seq.grays[0])))
    img1 = jnp.asarray(seq.grays[1])
    img1_l1 = jpyramid.mean_pyramid(3, img1)[1]
    inputs = {**_level_inputs("l0_", kf.levels[0]), **_level_inputs("l1_", kf.levels[1]),
              "img1": np.asarray(img1), "img1_l1": np.asarray(img1_l1)}
    port = {
        "level": ttracker.solve_level(interop.level_from_numpy(kf.levels[0]), torch.from_numpy(np.array(img1)),
                                      tpose.identity()),
        "pair": ttracker.solve_level(interop.level_from_numpy(kf.levels[1]), torch.from_numpy(np.array(img1_l1)),
                                     tpose.identity()),
    }
    win_arrays, port_windows = _window_inputs()
    inputs.update(win_arrays)
    graph = _port_loopy_graph(60, 8)
    inputs.update(g_q=graph.nodes.q.numpy(), g_t=graph.nodes.t.numpy(), g_i=graph.edge_i.numpy(),
                  g_j=graph.edge_j.numpy(), g_zq=graph.edge_z.q.numpy(), g_zt=graph.edge_z.t.numpy(),
                  g_w=graph.edge_weight.numpy())
    jax_runs = {}
    ranks = run_ranks(PROGRAM, inputs, tmp_path_factory.mktemp("sharded"),
                      meanwhile=lambda: jax_runs.update(_jax_sharded(inputs, kf, img1)))
    return dict(ranks=ranks, jax=jax_runs, port=port, windows=port_windows, graph=graph, ba=_ba_single())


def _same_on_every_rank(ranks, *names):
    for name in names:
        for r in range(1, len(ranks)):
            np.testing.assert_array_equal(ranks[r][name], ranks[0][name])


def test_level_solve_matches_jax_sharded_and_unsharded(runs):
    ranks, port, jax_ref = runs["ranks"], runs["port"]["level"], runs["jax"]["level_ref"]
    _same_on_every_rank(ranks, "level_q", "level_t", "level_iters")
    got_q, got_t = ranks[0]["level_q"], ranks[0]["level_t"]
    model, failed, nb_iter = runs["jax"]["level"]
    assert not bool(ranks[0]["level_failed"]) and not bool(failed)
    assert int(ranks[0]["level_iters"]) == int(nb_iter) == int(port.nb_iter) == int(jax_ref.nb_iter)
    for want_q, want_t in ((model.q, model.t), (port.state.model.q.numpy(), port.state.model.t.numpy()),
                           (jax_ref.state.model.q, jax_ref.state.model.t)):
        np.testing.assert_allclose(got_t, want_t, atol=1e-5)
        np.testing.assert_allclose(got_q, want_q, atol=1e-6)


def test_level_solve_refuses_a_ragged_split(runs):
    assert all(bool(r["level_ragged_raised"]) for r in runs["ranks"])


def test_two_process_solve_on_a_subgroup(runs):
    ranks, port = runs["ranks"][:2], runs["port"]["pair"]
    for r in ranks:
        np.testing.assert_array_equal(r["token"], [3.0, 5.0, 7.0])
        assert not bool(r["pair_failed"])
        np.testing.assert_allclose(r["pair_q"], port.state.model.q.numpy(), atol=5e-5)
        np.testing.assert_allclose(r["pair_t"], port.state.model.t.numpy(), atol=5e-5)
    assert "token" not in runs["ranks"][2]


def _points(ranks, name):
    """The rank shards of a sharded BA's points, in order."""
    assert all(r[f"{name}_points"].shape == (ranks[0][f"{name}_points"].shape[0], 3) for r in ranks)
    return np.concatenate([r[f"{name}_points"] for r in ranks])


def test_ba_psum_matches_single(runs):
    ranks, jax_run = runs["ranks"], runs["jax"]["ba_psum"]
    ref = runs["ba"]["ba_psum"][0]
    _same_on_every_rank(ranks, "ba_psum_t", "ba_psum_energy")
    assert _points(ranks, "ba_psum").shape == jax_run.points.shape == (64, 3)
    for want_t, want_energy in ((ref.poses.t.numpy(), float(ref.energy)), (jax_run.poses.t, float(jax_run.energy))):
        np.testing.assert_allclose(ranks[0]["ba_psum_t"], want_t, atol=5e-4)
        np.testing.assert_allclose(float(ranks[0]["ba_psum_energy"]), want_energy, rtol=0.3, atol=1e-6)


def test_ba_ring_assembly_matches_psum(runs):
    ranks, jax_runs = runs["ranks"], runs["jax"]
    _same_on_every_rank(ranks, "ba8_ring_t", "ba8_ring_energy", "ba8_psum_t")
    for got, want in (("ba8_ring", ranks[0]["ba8_psum_t"]), ("ba8_ring", jax_runs["ba8_ring"].poses.t),
                      ("ba8_psum", jax_runs["ba8_psum"].poses.t)):
        np.testing.assert_allclose(ranks[0][f"{got}_t"], want, atol=5e-4)
    for got, want in (("ba8_ring", ranks[0]["ba8_psum_energy"]), ("ba8_ring", jax_runs["ba8_ring"].energy),
                      ("ba8_psum", jax_runs["ba8_psum"].energy)):
        np.testing.assert_allclose(float(ranks[0][f"{got}_energy"]), float(want), rtol=0.1, atol=1e-6)


def test_ba_long_window_ring_assembly(runs):
    r0, jax_run = runs["ranks"][0], runs["jax"]["ba16_ring"]
    _, _, gt = runs["ba"]["ba16_ring"]
    assert float(r0["ba16_ring_energy"]) < 1e-4, float(r0["ba16_ring_energy"])
    poses = [Pose(torch.from_numpy(r0["ba16_ring_q"][k]), torch.from_numpy(r0["ba16_ring_t"][k])) for k in range(16)]
    err = ate.ate_rmse(poses, [Pose(gt.q[k], gt.t[k]) for k in range(16)])
    assert err < 1e-3, err
    np.testing.assert_allclose(r0["ba16_ring_t"], jax_run.poses.t, atol=5e-4)


def test_ba_ring_requires_divisible_K(runs):
    for r in runs["ranks"]:
        assert str(r["ba_ring_k3"]) == f"ring assembly needs K (3) divisible by mesh axis ({N})"


@pytest.mark.parametrize("case", ["win", "win_bright", "win_prior"])
def test_window_sharded_matches_single(runs, case):
    ranks = runs["ranks"]
    _same_on_every_rank(ranks, f"{case}_t", f"{case}_q", f"{case}_energy", f"{case}_ab")
    got_t, got_q = ranks[0][f"{case}_t"], ranks[0][f"{case}_q"]
    idepth = np.concatenate([r[f"{case}_idepth"] for r in ranks])
    energy = float(ranks[0][f"{case}_energy"])
    port, jax_run = runs["windows"][case], runs["jax"][case]
    for ref in ((port.poses.t.numpy(), port.poses.q.numpy(), port.idepth.numpy(), float(port.energy), port.ab.numpy()),
                (jax_run.poses.t, jax_run.poses.q, jax_run.idepth, float(jax_run.energy), jax_run.ab)):
        want_t, want_q, want_idepth, want_energy, want_ab = ref
        if case == "win":
            np.testing.assert_allclose(got_t, want_t, atol=1e-4)
            np.testing.assert_allclose(idepth, want_idepth, atol=1e-4)
            np.testing.assert_allclose(energy, want_energy, rtol=1e-3)
        elif case == "win_bright":
            np.testing.assert_allclose(got_t, want_t, atol=2e-4)
            np.testing.assert_allclose(ranks[0][f"{case}_ab"], want_ab, atol=1e-2)
        else:
            np.testing.assert_allclose(got_t, want_t, atol=5e-5)
            np.testing.assert_allclose(got_q, want_q, atol=5e-5)
            np.testing.assert_allclose(energy, want_energy, rtol=1e-4)


def test_pose_graph_sparse_sharded_matches_unsharded(runs):
    ranks, graph, jax_run = runs["ranks"], runs["graph"], runs["jax"]["pgo"]
    assert graph.edge_i.shape[0] % N != 0  # the weight-0 padding runs
    _same_on_every_rank(ranks, "pgo_t", "pgo_q", "pgo_energy")
    local = tpg.solve_sparse(graph, max_iterations=15)
    assert int(ranks[0]["pgo_iters"]) >= 1 and int(local.nb_iter) >= 1
    for want_energy, want_t, want_q in ((float(local.energy), local.nodes.t.numpy(), local.nodes.q.numpy()),
                                        (float(jax_run.energy), jax_run.nodes.t, jax_run.nodes.q)):
        np.testing.assert_allclose(float(ranks[0]["pgo_energy"]), want_energy, rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(ranks[0]["pgo_t"], want_t, atol=1e-5)
        np.testing.assert_allclose(ranks[0]["pgo_q"], want_q, atol=1e-5)
