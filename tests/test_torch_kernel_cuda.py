"""The CUDA kernels against their plain versions, on the card: the fused LM
evaluation (``csrc/residual_reduce.cu``) against its torch twin, and the
per-level LM solver (``csrc/lm_solve.cu``) against the Python LM loop.  Every
test here needs a CUDA device and skips without one; the file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_kernel_cuda.py -q

Tolerances.  Evaluation, as for the twin against the JAX package: energy
``rtol=1e-5``; g and H ``rtol=1e-4, atol=1e-5`` after scaling by their max;
the inside count equal.  Solver against the loop, whose evaluations are the
same kernel code: the scalar step differs by ulps (FMA contraction, another
Cholesky), so ``t`` to ``atol=1e-5`` m, ``q`` to ``atol=1e-6``, the energy
to ``rtol=1e-3``, ``failed`` equal and ``nb_iter`` within 1 (one
accept/continue decision may flip within an ulp of ``energy_tol``).
``track_frame`` on the card against the CPU within the LM stopping basin
(``t`` to ``atol=5e-3``).
"""

import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu_torch.dataset import synthetic
from visual_odometry_rs_tpu_torch.math import pose, se3
from visual_odometry_rs_tpu_torch.models import tracker
from visual_odometry_rs_tpu_torch.ops import lm_solve, pyramid, residual

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

H, W, LEVELS, CAP = 120, 160, 3, 1024
FIELDS = ("xs", "ys", "idepth", "valid", "tmpl_vals", "jacobians")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the twin's matmul in full f32
    return torch.device("cuda")


def _keyframe(device, height=H, width=W, levels=LEVELS, cap=CAP):
    seq = synthetic.generate_sequence(nb_frames=2, height=height, width=width, seed=0)
    config = tracker.TrackerConfig(height=height, width=width, nb_levels=levels, candidate_cap=cap)
    kf = tracker.precompute_keyframe(
        config, seq.intrinsics.to(device),
        torch.from_numpy(seq.depths[0].astype(np.int32)).to(device),
        pyramid.mean_pyramid(levels, torch.from_numpy(seq.grays[0]).to(device)),
    )
    return config, kf, pyramid.mean_pyramid(levels, torch.from_numpy(seq.grays[1]).to(device))


def _args(obs, img, xi):
    model = se3.exp(torch.tensor(xi, device=img.device))
    params = torch.cat([model.q, model.t, obs.intrinsics.vector()])
    return (img, obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians, params)


SMALL = [0.005, -0.003, 0.002, 0.001, 0.002, -0.001]
CASES = [
    (0, "plain", SMALL), (1, "plain", SMALL), (2, "plain", SMALL),
    (0, "ragged", SMALL), (1, "invalid", SMALL), (0, "outside", [0.8, 0.4, 0.0, 0.0, 0.05, 0.0]),
]


@pytest.mark.parametrize("lvl,case,xi", CASES)
def test_kernel_matches_twin(cuda_device, lvl, case, xi):
    _, kf, pyr1 = _keyframe(cuda_device)
    obs = kf.levels[lvl]
    if case == "ragged":  # not a multiple of the 256-thread block
        obs = obs._replace(**{f: getattr(obs, f)[:1000] for f in FIELDS})
    elif case == "invalid":
        obs = obs._replace(valid=torch.zeros_like(obs.valid))
    args = _args(obs, pyr1[lvl], xi)
    before = residual.residual_reduce.launches
    m, rsq, cnt = residual.residual_reduce(*args)
    m_ref, rsq_ref, cnt_ref = residual.residual_reduce_reference(*args)
    torch.cuda.synchronize()
    assert residual.residual_reduce.launches == before + 1
    assert float(cnt) == float(cnt_ref)
    if case == "invalid":
        assert float(cnt) == 0.0 and torch.isnan(rsq / cnt)
        return
    np.testing.assert_allclose(float(rsq / cnt), float(rsq_ref / cnt_ref), rtol=1e-5)
    for part, ref in ((m[:, 6], m_ref[:, 6]), (m[:, :6], m_ref[:, :6])):
        scale = float(ref.abs().max()) + 1.0
        np.testing.assert_allclose((part / scale).cpu().numpy(), (ref / scale).cpu().numpy(), rtol=1e-4, atol=1e-5)


def test_wrapper_raises_on_bad_inputs(cuda_device):
    _, kf, pyr1 = _keyframe(cuda_device)
    args = list(_args(kf.levels[0], pyr1[0], SMALL))
    bad = [
        (1, args[1].double()),  # dtype
        (6, args[6].t().contiguous().t()),  # not contiguous
        (7, args[7][:11]),  # shape
        (2, args[2].cpu()),  # device
    ]
    for i, value in bad:
        wrong = list(args)
        wrong[i] = value
        with pytest.raises((TypeError, ValueError)):
            residual.residual_reduce(*wrong)


def test_track_frame_through_kernel_matches_twin(cuda_device):
    config, kf, pyr1 = _keyframe(cuda_device)
    evals_before = residual.residual_reduce.launches
    before = lm_solve.lm_solve_level.launches
    out = tracker.track_frame(config, kf, pyr1, pose.identity(device=cuda_device))
    assert lm_solve.lm_solve_level.launches - before == LEVELS  # one launch per level
    assert residual.residual_reduce.launches == evals_before  # and no Python LM loop
    _, kf_cpu, pyr1_cpu = _keyframe("cpu")
    ref = tracker.track_frame(config, kf_cpu, pyr1_cpu, pose.identity())
    assert bool(out.failed) == bool(ref.failed) is False
    np.testing.assert_allclose(out.model.t.cpu().numpy(), ref.model.t.numpy(), atol=5e-3)
    np.testing.assert_allclose(float(out.flow), float(ref.flow), rtol=0.15, atol=2e-2)
    assert (out.nb_evals > 0).all() and (out.nb_evals >= out.nb_iters).all()


def _assert_solves_match(out, ref):
    assert bool(out.failed) == bool(ref.failed)
    assert abs(int(out.nb_iter) - int(ref.nb_iter)) <= 1
    np.testing.assert_allclose(out.state.model.t.cpu().numpy(), ref.state.model.t.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(out.state.model.q.cpu().numpy(), ref.state.model.q.cpu().numpy(), atol=1e-6)
    np.testing.assert_allclose(float(out.state.energy), float(ref.state.energy), rtol=1e-3, equal_nan=True)


@pytest.mark.parametrize("lvl", range(6))
def test_lm_solve_matches_reference_at_640x480(cuda_device, lvl):
    """The six level shapes of the main path: 480x640 ... 15x20, caps 8192,
    8192, 8192, 4800, 1200, 300."""
    _, kf, pyr1 = _keyframe(cuda_device, 480, 640, 6, 8192)
    obs, image = kf.levels[lvl], pyr1[lvl]
    evals_before = residual.residual_reduce.launches
    before = lm_solve.lm_solve_level.launches
    out = tracker.solve_level(obs, image, pose.identity(device=cuda_device))
    assert lm_solve.lm_solve_level.launches == before + 1
    assert residual.residual_reduce.launches == evals_before
    ref = tracker.solve_level_reference(obs, image, pose.identity(device=cuda_device))
    assert residual.residual_reduce.launches == evals_before + ref.nb_iter + 1
    torch.cuda.synchronize()
    _assert_solves_match(out, ref)
    # [H | g] and the damping of the accepted state come back too
    scale = float(ref.state.hessian.abs().max()) + 1.0
    np.testing.assert_allclose(
        (out.state.hessian / scale).cpu().numpy(), (ref.state.hessian / scale).cpu().numpy(), rtol=1e-3, atol=1e-5
    )
    assert out.state.gradient.shape == (6,) and float(out.state.lm_coef) > 0.0


@pytest.mark.parametrize("case", ["invalid", "one_iteration", "ragged", "cluster_1"])
def test_lm_solve_edge_cases(cuda_device, case):
    _, kf, pyr1 = _keyframe(cuda_device)
    obs, image, kwargs = kf.levels[0], pyr1[0], {}
    start = se3.exp(torch.tensor(SMALL, device=cuda_device))
    if case == "invalid":  # NaN energy, zero normal equations: failed at iteration 1
        obs = obs._replace(valid=torch.zeros_like(obs.valid))
    elif case == "one_iteration":  # the nb_iter > max_iterations stop
        kwargs = dict(max_iterations=1)
    elif case == "ragged":
        obs = obs._replace(**{f: getattr(obs, f)[:1000] for f in FIELDS})
    out = tracker.solve_level(obs, image, start, **kwargs)
    ref = tracker.solve_level_reference(obs, image, start, **kwargs)
    _assert_solves_match(out, ref)
    if case == "invalid":
        assert bool(out.failed) and int(out.nb_iter) == 1 and bool(torch.isnan(out.state.energy))
        assert torch.equal(out.state.model.t, start.t) and torch.equal(out.state.model.q, start.q)
    elif case == "one_iteration":
        assert int(out.nb_iter) == 2 and not bool(out.failed)
    elif case == "cluster_1":  # candidates beyond a thread's registers come from global memory
        record = torch.empty(lm_solve.RECORD_SIZE, device=cuda_device)
        lm_solve.lm_solve_level(
            image, obs.xs[:1500], obs.ys[:1500], obs.idepth[:1500], obs.tmpl_vals[:1500], obs.valid[:1500],
            obs.jacobians[:1500], obs.intrinsics.vector(), tracker._start_state(start), record,
            lm_coef_init=0.1, max_iterations=20, energy_tol=1.0, cluster=1,
        )
        cut = obs._replace(**{f: getattr(obs, f)[:1500] for f in FIELDS})
        ref = tracker.solve_level_reference(cut, image, start)
        np.testing.assert_allclose(record[lm_solve.POSE][4:7].cpu().numpy(), ref.state.model.t.cpu().numpy(), atol=1e-5)
        assert abs(int(record[lm_solve.NB_ITER]) - ref.nb_iter) <= 1


def test_frame_matches_reference_frame_on_the_card(cuda_device):
    """Six chained launches, the flow from the last, against the Python loop
    and torch's flow on the same device.  The flow follows the pose: rtol 1e-4."""
    config, kf, pyr1 = _keyframe(cuda_device, 480, 640, 6, 8192)
    start = pose.identity(device=cuda_device)
    out = tracker.track_frame(config, kf, pyr1, start)
    ref = tracker.track_frame_reference(config, kf, pyr1, start)
    assert not bool(out.failed) and not bool(ref.failed)
    np.testing.assert_allclose(out.model.t.cpu().numpy(), ref.model.t.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(out.model.q.cpu().numpy(), ref.model.q.cpu().numpy(), atol=1e-6)
    np.testing.assert_allclose(float(out.flow), float(ref.flow), rtol=1e-4)
    assert all(abs(a - b) <= 1 for a, b in zip(out.nb_iters.tolist(), ref.nb_iters.tolist()))


def test_failed_coarsest_level_freezes_the_frame(cuda_device):
    config, kf, pyr1 = _keyframe(cuda_device)
    levels = list(kf.levels)
    levels[-1] = levels[-1]._replace(valid=torch.zeros_like(levels[-1].valid))
    broken = tracker.KeyframeData(levels=tuple(levels))
    start = se3.exp(torch.tensor(SMALL, device=cuda_device))
    out = tracker.track_frame(config, broken, pyr1, start)
    ref = tracker.track_frame_reference(config, broken, pyr1, start)
    assert bool(out.failed) and bool(ref.failed)
    assert torch.equal(out.model.t, start.t) and torch.equal(out.model.q, start.q)
    iters, ref_iters = out.nb_iters.tolist(), ref.nb_iters.tolist()
    assert iters[-1] == 1 and min(iters) >= 1  # later levels still run and report
    assert all(abs(a - b) <= 1 for a, b in zip(iters, ref_iters))
    # no candidate at the coarsest level: the mean flow is 0 / 0 in both
    assert bool(torch.isnan(out.flow)) and bool(torch.isnan(ref.flow))


def test_lm_part_makes_no_host_read(cuda_device):
    """``track_frame`` (six launches and the flow) never waits for the device."""
    config, kf, pyr1 = _keyframe(cuda_device)
    start = pose.identity(device=cuda_device)
    tracker.track_frame(config, kf, pyr1, start)  # builds and loads the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tracker.track_frame(config, kf, pyr1, start)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not bool(out.failed)


def test_two_runs_are_bit_equal(cuda_device):
    config, kf, pyr1 = _keyframe(cuda_device, 480, 640, 6, 8192)
    start = pose.identity(device=cuda_device)
    a = tracker.track_frame(config, kf, pyr1, start)
    b = tracker.track_frame(config, kf, pyr1, start)
    assert torch.equal(a.model.q, b.model.q) and torch.equal(a.model.t, b.model.t)
    assert torch.equal(a.nb_iters, b.nb_iters) and torch.equal(a.flow, b.flow)


def test_lm_solve_raises_on_bad_inputs(cuda_device):
    _, kf, pyr1 = _keyframe(cuda_device)
    obs = kf.levels[0]
    with pytest.raises(ValueError):  # a CPU pose with CUDA candidates
        tracker.solve_level(obs, pyr1[0], pose.identity())
    record = torch.empty(lm_solve.RECORD_SIZE, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):  # a cluster size the launch refuses
        lm_solve.lm_solve_level(
            pyr1[0], obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians,
            obs.intrinsics.vector(), tracker._start_state(pose.identity(device=cuda_device)), record,
            lm_coef_init=0.1, max_iterations=20, energy_tol=1.0, cluster=3,
        )
