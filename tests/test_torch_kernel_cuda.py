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
(``t`` to ``atol=5e-3``).  The native PNG loader and a resumed ``Tracker``
on the card: bit-equal.
"""

import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu_torch.core import camera
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


def test_track_frame_stacks_no_intrinsics_a_launch(cuda_device, monkeypatch):
    """A frame's launches take the rows of one (L, 5) intrinsics table: no
    ``Intrinsics.vector`` call, still one solver launch a level."""
    config, kf, pyr1 = _keyframe(cuda_device)
    vector, calls = camera.Intrinsics.vector, []
    monkeypatch.setattr(camera.Intrinsics, "vector", lambda k: calls.append(k) or vector(k))
    before = lm_solve.lm_solve_level.launches
    out = tracker.track_frame(config, kf, pyr1, pose.identity(device=cuda_device))
    assert lm_solve.lm_solve_level.launches - before == LEVELS
    assert calls == [] and not bool(out.failed)


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


def _three_lanes(device):
    """Three lanes of keyframe, next-frame pyramid and start pose: a normal
    lane, a lane with no valid candidate at any level, and a lane whose
    coarsest level has none (so that level fails)."""
    lanes = []
    for seed in range(3):
        seq = synthetic.generate_sequence(nb_frames=2, height=H, width=W, seed=seed)
        config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP)
        kf = tracker.precompute_keyframe(
            config, seq.intrinsics.to(device), torch.from_numpy(seq.depths[0].astype(np.int32)).to(device),
            pyramid.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[0]).to(device)),
        )
        levels = list(kf.levels)
        if seed == 1:
            levels = [obs._replace(valid=torch.zeros_like(obs.valid)) for obs in levels]
        elif seed == 2:
            levels[-1] = levels[-1]._replace(valid=torch.zeros_like(levels[-1].valid))
        pyr1 = pyramid.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[1]).to(device))
        lanes.append((tracker.KeyframeData(levels=tuple(levels)), pyr1, se3.exp(torch.tensor(SMALL, device=device))))
    kf = tracker.map_keyframe(lambda *xs: torch.stack(xs), *(kf for kf, _, _ in lanes))
    pyr = [torch.stack(ps) for ps in zip(*(p for _, p, _ in lanes))]
    start = pose.Pose(torch.stack([s.q for _, _, s in lanes]), torch.stack([s.t for _, _, s in lanes]))
    return config, lanes, kf, pyr, start


def test_lane_axis_launch_is_single_launches_bit_for_bit(cuda_device):
    """A frame of three lanes is six launches, each lane's result bit-equal
    to its own one-lane frame."""
    config, lanes, kf, pyr, start = _three_lanes(cuda_device)
    before = lm_solve.lm_solve_level.launches
    out = tracker.track_frame(config, kf, pyr, start)
    assert lm_solve.lm_solve_level.launches - before == LEVELS
    assert out.model.q.shape == (3, 4) and out.nb_iters.shape == (3, LEVELS)
    for b, (lane_kf, lane_pyr, lane_start) in enumerate(lanes):
        one = tracker.track_frame(config, lane_kf, lane_pyr, lane_start)
        assert torch.equal(out.model.q[b], one.model.q) and torch.equal(out.model.t[b], one.model.t)
        assert torch.equal(out.failed[b], one.failed)
        assert torch.equal(out.nb_iters[b], one.nb_iters) and torch.equal(out.nb_evals[b], one.nb_evals)
        assert torch.equal(out.flow[b], one.flow) or (bool(out.flow[b].isnan()) and bool(one.flow.isnan()))
    assert out.failed.tolist() == [False, True, True]
    assert torch.equal(out.model.t[1], start.t[1]) and torch.equal(out.model.t[2], start.t[2])
    assert out.nb_iters[1].tolist() == [1] * LEVELS and out.nb_iters[2, -1] == 1


def test_lane_axis_launch_matches_reference_per_lane(cuda_device):
    """The lane-axis frame against ``track_frame_reference`` lane by lane
    (the Python loop), with the solver's tolerances."""
    config, _, kf, pyr, start = _three_lanes(cuda_device)
    out = tracker.track_frame(config, kf, pyr, start)
    ref = tracker.track_frame_reference(config, kf, pyr, start)
    assert out.failed.tolist() == ref.failed.tolist()
    np.testing.assert_allclose(out.model.t.cpu().numpy(), ref.model.t.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(out.model.q.cpu().numpy(), ref.model.q.cpu().numpy(), atol=1e-6)
    assert (out.nb_iters - ref.nb_iters).abs().max() <= 1
    np.testing.assert_allclose(float(out.flow[0]), float(ref.flow[0]), rtol=1e-4)
    assert out.flow[1:].isnan().all() and ref.flow[1:].isnan().all()


def test_lane_axis_launch_raises_on_mismatched_lanes(cuda_device):
    config, _, kf, pyr, start = _three_lanes(cuda_device)
    obs = kf.levels[0]
    state = tracker._start_state(start)
    args = (pyr[0], obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians, obs.intrinsics.vector())
    kwargs = dict(lm_coef_init=0.1, max_iterations=20, energy_tol=1.0)
    with pytest.raises(ValueError):  # a record for two lanes
        lm_solve.lm_solve_level(*args, state, torch.empty((2, lm_solve.RECORD_SIZE), device=cuda_device), **kwargs)
    with pytest.raises(ValueError):  # a state whose rows are not contiguous
        lm_solve.lm_solve_level(*args, state.t().contiguous().t(), torch.empty((3, lm_solve.RECORD_SIZE), device=cuda_device), **kwargs)
    assert lm_solve.max_active_clusters(residual.cluster_size(obs.xs.shape[-1])) >= 1


def test_batched_tracking_is_the_streaming_tracker_on_the_card(cuda_device):
    """Three lanes, cadence 1, four frames: per lane bit-equal to the
    streaming ``Tracker`` on the card (bucketing off); one solver launch per
    level and frame for all lanes."""
    from visual_odometry_rs_tpu_torch.parallel import batch

    seqs = [synthetic.generate_sequence(nb_frames=5, height=H, width=W, seed=s,
                                        twist_per_frame=[0.02 * (s + 1), 0.0, 0.0, 0.0, 0.0, 0.0])
            for s in range(3)]
    config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP)
    intr = seqs[0].intrinsics
    state = batch.batched_init_state(config, intr, np.stack([s.depths[0] for s in seqs]),
                                     np.stack([s.grays[0] for s in seqs]), device=cuda_device)
    clip_d = np.stack([np.stack([s.depths[f] for s in seqs]) for f in range(1, 5)])
    clip_g = np.stack([np.stack([s.grays[f] for s in seqs]) for f in range(1, 5)])
    before = lm_solve.lm_solve_level.launches
    _, (poses, diags) = batch.batched_track_sequence(config, intr, state, clip_d, clip_g)
    assert lm_solve.lm_solve_level.launches - before == 4 * LEVELS
    assert diags.switched.any()
    for b, s in enumerate(seqs):
        trk = tracker.init_tracker(config, intr, 0.0, s.depths[0], 0.0, s.grays[0], device=cuda_device)
        for f in range(4):
            trk.track(float(f + 1), s.depths[f + 1], float(f + 1), s.grays[f + 1])
            p = trk.current_frame()[1]
            assert torch.equal(p.q, poses.q[f, b].cpu()) and torch.equal(p.t, poses.t[f, b].cpu()), (f, b)
            assert list(trk.last_nb_iters) == diags.nb_iters[f, b].tolist()


UPLOAD_LAYOUTS = {"contiguous": lambda x: x, "lane_slice": lambda x: x[:, 1:3]}  # shard_batch's view


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("layout", sorted(UPLOAD_LAYOUTS))
def test_staged_clip_upload_is_the_pageable_upload(cuda_device, layout, kind):
    """``upload_clip`` stages a host clip's images through a page-locked
    block and leaves its depth maps on the host, on the caller's memory;
    ``upload_lanes`` sends a frame's picked lanes through a page-locked block
    and widens them on the card.  The u8 images and the int32 rows that
    cross (every u16 value) equal ``image_tensor``/``depth_tensor``'s
    pageable upload, no other row is written, and a second clip allocates
    no page-locked memory.  Inputs on the card, and negative strides, go
    whole through the pageable converters."""
    from visual_odometry_rs_tpu_torch.utils.types import depth_tensor, image_tensor, upload_clip, upload_lanes

    rng = np.random.default_rng(13)
    depths = rng.integers(0, 1 << 16, (2, 4, 256, 256), dtype=np.uint16)
    depths[0, 1] = np.arange(1 << 16, dtype=np.uint16).reshape(256, 256)
    imgs = rng.integers(0, 1 << 8, depths.shape, dtype=np.uint8)
    depths, imgs = UPLOAD_LAYOUTS[layout](depths), UPLOAD_LAYOUTS[layout](imgs)
    address = depths.ctypes.data
    if kind == "tensor":
        depths, imgs = torch.from_numpy(depths), torch.from_numpy(imgs)
    frame = depths.shape[1:]
    row_bytes = 2 * frame[1] * frame[2]
    allocs = []
    for _ in range(2):
        got_d, got_i, staged = upload_clip(depths, imgs, cuda_device)
        assert staged == imgs.nbytes
        assert (got_d.dtype, got_d.device.type, got_d.data_ptr()) == (torch.uint16, "cpu", address)
        assert (got_i.dtype, got_i.device.type) == (torch.uint8, "cuda")
        assert torch.equal(got_i, image_tensor(imgs, cuda_device))
        block = torch.empty(frame, dtype=torch.uint16, pin_memory=True)
        rows = torch.full(frame, -1, dtype=torch.int32, device=cuda_device)
        every = torch.arange(frame[0] - 1, -1, -1)  # every lane, in reverse
        assert upload_lanes(got_d[0], every, rows, block) == frame[0] * row_bytes
        assert torch.equal(rows, depth_tensor(depths[0], cuda_device))
        assert rows.unique().numel() == 1 << 16  # every u16 value, lane 1 in both layouts
        one = torch.full(frame, -1, dtype=torch.int32, device=cuda_device)
        assert upload_lanes(got_d[1], torch.tensor([1]), one, block) == row_bytes  # the same block again
        assert torch.equal(one[1], depth_tensor(depths[1, 1], cuda_device))
        assert bool((one[0] == -1).all()) and bool((one[2:] == -1).all())
        del block  # freed, as batched_track_sequence frees its block at the end of a clip
        torch.cuda.synchronize()
        allocs.append(torch.cuda.host_memory_stats()["num_host_alloc"])
    assert allocs[1] == allocs[0]  # the second clip reused the first one's page-locked blocks
    on_card = upload_clip(depth_tensor(depths, cuda_device), got_i, cuda_device)  # already there: nothing staged
    assert on_card[2] == 0 and torch.equal(on_card[0], depth_tensor(depths, cuda_device))
    assert on_card[0].dtype == torch.int32 and torch.equal(on_card[1], got_i)
    if kind == "numpy":  # negative strides: the whole clip, pageable
        rev_d, rev_i, rev_staged = upload_clip(depths[::-1], imgs[::-1], cuda_device)
        assert rev_staged == 0 and torch.equal(rev_d, depth_tensor(depths[::-1], cuda_device))
        assert torch.equal(rev_i, image_tensor(imgs[::-1], cuda_device))


STAGED_CASES = {  # (TrackerConfig options, batched_track_sequence options)
    "cadence1": ({}, {}),
    "cadence4": ({}, dict(switch_cadence=4, frame_offset=2)),  # check frames 1 (no switch) and 5
    "ring": (dict(relocalize_window=3), dict(switch_cadence=2)),
}


def _staged_clip_lanes(frames=9):
    """Four synthetic lanes at four speeds, (F, 4, H, W) host stacks."""
    seqs = [synthetic.generate_sequence(nb_frames=frames, height=H, width=W, seed=s,
                                        twist_per_frame=[speed, 0.0, 0.0, 0.0, 0.0, 0.0])
            for s, speed in enumerate((0.02, 0.01, 0.03, 0.04))]
    depths = np.stack([np.stack([s.depths[f] for s in seqs]) for f in range(frames)])
    grays = np.stack([np.stack([s.grays[f] for s in seqs]) for f in range(frames)])
    return seqs[0].intrinsics, depths, grays


def _same_bits(a, b) -> bool:
    """Equal bit for bit, NaNs included (every float of the port is f32)."""
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _assert_keyframes_equal(kf, ref):
    for level, ref_level in zip(kf.levels, ref.levels):
        for f in tracker.LANE_FIELDS:
            assert _same_bits(getattr(level, f), getattr(ref_level, f)), f


def _assert_clip_outputs_equal(got, ref):
    """Final state, poses, diagnostics and (third, if there) ring, bit for bit."""
    assert len(got) == len(ref)
    (poses, diags), (ref_poses, ref_diags) = got[1], ref[1]
    for a, b in zip((*poses, *diags, *got[0].current_pose, *got[0].keyframe_pose),
                    (*ref_poses, *ref_diags, *ref[0].current_pose, *ref[0].keyframe_pose)):
        assert _same_bits(a, b)
    _assert_keyframes_equal(got[0].kf, ref[0].kf)
    if len(got) > 2:
        _assert_keyframes_equal(got[2].kf, ref[2].kf)
        assert all(_same_bits(a, b) for a, b in zip(got[2][1:], ref[2][1:]))


@pytest.mark.parametrize("case", sorted(STAGED_CASES))
def test_staged_clip_tracks_as_the_pageable_clip(cuda_device, case):
    """A lane-sliced host clip through ``batched_track_sequence`` (images
    staged, each check frame's switching lanes' depth sent then) gives the
    poses, diagnostics and ring of the same clip uploaded first by the
    pageable converters, bit for bit.  Its ``vors.upload`` spans stage the
    images' bytes and one depth row a switched lane-frame, each check frame's
    between the switch mask's read and the precompute; a check frame with no
    switch sends nothing; a second clip allocates no page-locked memory."""
    from visual_odometry_rs_tpu_torch.parallel import batch
    from visual_odometry_rs_tpu_torch.utils import profiling
    from visual_odometry_rs_tpu_torch.utils.types import depth_tensor, image_tensor

    config_kw, kwargs = STAGED_CASES[case]
    intr, depths, grays = _staged_clip_lanes()
    clip_d, clip_g = depths[:, 1:3], grays[:, 1:3]  # shard_batch's view for the second of two devices
    config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP, **config_kw)
    state = batch.batched_init_state(config, intr, clip_d[0], clip_g[0], device=cuda_device)
    if config.relocalize_window:
        kwargs = dict(kwargs, reloc_ring=batch.batched_init_ring(config, state))
    pageable = batch.batched_track_sequence(config, intr, state, depth_tensor(clip_d[1:], cuda_device),
                                            image_tensor(clip_g[1:], cuda_device), **kwargs)
    allocs = []
    profiling.clear()
    try:
        for _ in range(2):
            with profiling.recording():
                staged = batch.batched_track_sequence(config, intr, state, clip_d[1:], clip_g[1:], **kwargs)
            torch.cuda.synchronize()
            allocs.append(torch.cuda.host_memory_stats()["num_host_alloc"])
            _assert_clip_outputs_equal(staged, pageable)
        records = profiling.spans()
    finally:
        profiling.clear()
    assert allocs[1] == allocs[0]
    switched = staged[1][1].switched.cpu()
    cadence, offset = kwargs.get("switch_cadence", 1), kwargs.get("frame_offset", 0)
    checks = [t for t in range(switched.shape[0]) if (offset + t + 1) % cadence == 0]
    assert bool(switched.any()) and not all(bool(switched[t].any()) for t in checks)
    kids = {}
    for s in records:
        kids.setdefault(s.parent, []).append(s)
    clip = kids[None][-1]  # the second clip's root span
    first, *steps = kids[clip.serial]
    assert first.name == "vors.upload" and first.counts == {"bytes": clip_g[1:].nbytes, "staged": clip_g[1:].nbytes}
    uploads = [first] + [s for step in steps for s in kids[step.serial] if s.name == "vors.upload"]
    row_bytes = 2 * H * W
    assert sum(s.counts["staged"] for s in uploads) == clip_g[1:].nbytes + row_bytes * int(switched.sum())
    for t, step in enumerate(steps):
        names = [s.name for s in kids[step.serial]]
        k = int(switched[t].sum())
        if k:
            assert names == ["vors.solve", "vors.read.switch_mask", "vors.upload", "vors.precompute"], (t, names)
            assert kids[step.serial][2].counts == {"lanes": k, "bytes": k * row_bytes, "staged": k * row_bytes}
        else:
            assert "vors.upload" not in names and "vors.precompute" not in names, (t, names)


def test_staged_clip_over_a_mesh_is_the_pageable_clip(cuda_device):
    """``batched_track_sequence(mesh=)`` over the card twice hands each
    thread a lane-sliced host view, which stages its own lanes' depth rows:
    bit-equal to the clip uploaded first, without a mesh."""
    from visual_odometry_rs_tpu_torch.parallel import batch
    from visual_odometry_rs_tpu_torch.parallel import mesh as mesh_mod
    from visual_odometry_rs_tpu_torch.utils.types import depth_tensor, image_tensor

    intr, depths, grays = _staged_clip_lanes()
    config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP)
    state = batch.batched_init_state(config, intr, depths[0], grays[0], device=cuda_device)
    pageable = batch.batched_track_sequence(config, intr, state, depth_tensor(depths[1:], cuda_device),
                                            image_tensor(grays[1:], cuda_device))
    lanes = mesh_mod.make_mesh((2,), ("data",), devices=[cuda_device, cuda_device])
    spread = batch.batched_track_sequence(config, intr, state, depths[1:], grays[1:], mesh=lanes)
    _assert_clip_outputs_equal(spread, pageable)
    assert bool(spread[1][1].switched[:, :2].any()) and bool(spread[1][1].switched[:, 2:].any())


# --- the tracker options: Huber weights, brightness, detector, lanes ---------

OPTION_CASES = {
    "huber": dict(robust_delta=10.0),
    "brightness": dict(ab=(1.1, -6.0)),
    "huber+brightness": dict(robust_delta=10.0, ab=(1.1, -6.0)),
}


@pytest.mark.parametrize("lvl", range(LEVELS))
@pytest.mark.parametrize("option", sorted(OPTION_CASES))
def test_option_kernels_match_twin(cuda_device, option, lvl):
    """Each instantiation of ``residual_reduce`` against the twin with the
    same option, with the evaluation's tolerances."""
    _, kf, pyr1 = _keyframe(cuda_device)
    opts = dict(OPTION_CASES[option])
    if "ab" in opts:
        opts["ab"] = torch.tensor(opts["ab"], device=cuda_device)
    args = _args(kf.levels[lvl], pyr1[lvl], SMALL)
    m, rsq, cnt = residual.residual_reduce(*args, **opts)
    m_ref, rsq_ref, cnt_ref = residual.residual_reduce_reference(*args, **opts)
    nparam = 8 if "ab" in opts else 6
    assert m.shape == m_ref.shape == (nparam, nparam + 1)
    assert float(cnt) == float(cnt_ref) > 0
    np.testing.assert_allclose(float(rsq / cnt), float(rsq_ref / cnt_ref), rtol=1e-5)
    scale = float(m_ref.abs().max()) + 1.0
    np.testing.assert_allclose((m / scale).cpu().numpy(), (m_ref / scale).cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("option", sorted(OPTION_CASES))
def test_option_solves_match_reference(cuda_device, option):
    _, kf, pyr1 = _keyframe(cuda_device)
    opts = OPTION_CASES[option]
    delta = opts.get("robust_delta", 0.0)
    start = pose.identity(device=cuda_device)
    for lvl in range(LEVELS):
        obs, image = kf.levels[lvl], pyr1[lvl]
        if "ab" not in opts:
            out = tracker.solve_level(obs, image, start, robust_delta=delta)
            ref = tracker.solve_level_reference(obs, image, start, robust_delta=delta)
            _assert_solves_match(out, ref)
            continue
        bst = tracker.BrightnessState(start, torch.tensor(opts["ab"], device=cuda_device))
        out = tracker.solve_level_brightness(obs, image, bst, robust_delta=delta)
        ref = tracker.solve_level_brightness_reference(obs, image, bst, robust_delta=delta)
        assert bool(out.failed) == bool(ref.failed)
        assert abs(int(out.nb_iter) - int(ref.nb_iter)) <= 1
        np.testing.assert_allclose(out.state.model.pose.t.cpu().numpy(), ref.state.model.pose.t.cpu().numpy(), atol=1e-5)
        np.testing.assert_allclose(out.state.model.ab.cpu().numpy(), ref.state.model.ab.cpu().numpy(), rtol=1e-4, atol=1e-3)
        assert out.state.hessian.shape == (8, 8)


@pytest.mark.parametrize("option", ["huber", "brightness", "huber+brightness"])
def test_option_frame_matches_reference_with_detector(cuda_device, option):
    """Six launches of the option's instantiation, the detector from the
    last, against the Python loop and ``_eval_energy``."""
    config, kf, pyr1 = _keyframe(cuda_device)
    opts = OPTION_CASES[option]
    config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP,
                                   robust_delta=opts.get("robust_delta", 0.0), brightness_model="ab" in opts)
    start = pose.identity(device=cuda_device)
    evals_before, before = residual.residual_reduce.launches, lm_solve.lm_solve_level.launches
    out = tracker.track_frame(config, kf, pyr1, start, detector=True)
    assert lm_solve.lm_solve_level.launches - before == LEVELS
    assert residual.residual_reduce.launches == evals_before
    ref = tracker.track_frame_reference(config, kf, pyr1, start, detector=True)
    assert bool(out.failed) == bool(ref.failed) is False
    np.testing.assert_allclose(out.model.t.cpu().numpy(), ref.model.t.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(out.model.q.cpu().numpy(), ref.model.q.cpu().numpy(), atol=1e-6)
    energy, _, inside = tracker._eval_energy(kf.levels[0], pyr1[0], out.model)
    np.testing.assert_allclose(float(out.detector[0]), float(energy), rtol=1e-4)
    assert float(out.detector[1]) == float(inside.sum()) and float(out.detector[2]) == float(kf.levels[0].valid.sum())


def test_image_index_and_active_lanes(cuda_device):
    """Three keyframes tracking one shared frame through the image index,
    the middle lane inactive: the active lanes bit-equal to one-lane frames,
    the inactive one a pass-through, as ``track_frame_reference`` says."""
    config, lanes, kf, pyr, start = _three_lanes(cuda_device)
    shared = [p[:1] for p in pyr]
    index = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    active = torch.tensor([True, False, True], device=cuda_device)
    out = tracker.track_frame(config, kf, shared, start, detector=True, image_index=index, active=active)
    for b in (0, 2):
        one = tracker.track_frame(config, lanes[b][0], [p[0] for p in pyr], pose.Pose(start.q[b], start.t[b]),
                                  detector=True)
        assert torch.equal(out.model.t[b], one.model.t) and torch.equal(out.nb_iters[b], one.nb_iters)
        assert torch.equal(out.detector[b], one.detector)
    assert torch.equal(out.model.t[1], start.t[1]) and torch.equal(out.model.q[1], start.q[1])
    assert not bool(out.failed[1]) and out.nb_iters[1].tolist() == [0] * LEVELS
    assert bool(out.detector[1, 0].isnan()) and out.detector[1, 1:].tolist() == [0.0, 0.0]
    ref = tracker.track_frame_reference(config, kf, shared, start, detector=True, image_index=index, active=active)
    assert out.failed.tolist() == ref.failed.tolist()
    np.testing.assert_allclose(out.model.t.cpu().numpy(), ref.model.t.cpu().numpy(), atol=1e-5)
    for name, brightness, robust in (("plain", False, False), ("brightness", True, True)):
        regs, local = lm_solve.resources(brightness=brightness, robust=robust)
        assert 0 < regs <= 255 and local >= 0, name


def test_ring_recovery_makes_no_host_read(cuda_device):
    """With a ring, a steady batched frame (no check) still never waits for
    the device: the recovery runs as inactive lanes."""
    from visual_odometry_rs_tpu_torch.parallel import batch

    seqs = [synthetic.generate_sequence(nb_frames=3, height=H, width=W, seed=s) for s in range(2)]
    config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP, relocalize_window=3)
    intr = seqs[0].intrinsics.to(cuda_device)  # a copy from the host would wait
    state = batch.batched_init_state(config, intr, np.stack([s.depths[0] for s in seqs]),
                                     np.stack([s.grays[0] for s in seqs]), device=cuda_device)
    ring = batch.batched_init_ring(config, state)
    clip_d = torch.from_numpy(np.stack([np.stack([s.depths[f] for s in seqs]) for f in (1, 2)]).astype(np.int32)).to(cuda_device)
    clip_g = torch.from_numpy(np.stack([np.stack([s.grays[f] for s in seqs]) for f in (1, 2)])).to(cuda_device)
    kwargs = dict(switch_cadence=4, reloc_ring=ring)
    batch.batched_track_sequence(config, intr, state, clip_d[:1], clip_g[:1], **kwargs)  # loads the kernels
    torch.cuda.synchronize()
    before = lm_solve.lm_solve_level.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, (_, diags), ring_out = batch.batched_track_sequence(config, intr, state, clip_d[1:], clip_g[1:], **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert lm_solve.lm_solve_level.launches - before == 2 * LEVELS  # the frame's and the recovery's
    assert not diags.relocalized.any() and torch.equal(ring_out.count, ring.count)


def test_native_loader_on_the_card_machine(cuda_device, tmp_path):
    """The port's PNG library builds where the card is, and a written
    sequence comes back bit-equal through the readers and the prefetching
    loader; the frames feed the tracker on the card."""
    from visual_odometry_rs_tpu_torch import native
    from visual_odometry_rs_tpu_torch.dataset import tum_rgbd

    assert native.available()
    seq = synthetic.generate_sequence(nb_frames=4, height=H, width=W, seed=2)
    assocs = tum_rgbd.load_associations(
        tum_rgbd.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)
    )
    frames = list(tum_rgbd.frame_loader(assocs, num_threads=4))
    for (depth, gray), d, g in zip(frames, seq.depths, seq.grays):
        np.testing.assert_array_equal(depth, d)
        np.testing.assert_array_equal(gray, g)
    trk = tracker.init_tracker(tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP),
                               seq.intrinsics, 0.0, frames[0][0], 0.0, frames[0][1], device=cuda_device)
    trk.track(1.0, frames[1][0], 1.0, frames[1][1])
    assert not trk.last_failed


@pytest.mark.parametrize("warm_start", ["constant_position", "constant_velocity"])
def test_resumed_cuda_tracker_is_bit_equal(cuda_device, tmp_path, warm_start):
    """A CUDA ``Tracker`` saved after 3 frames and restored into a new one
    tracks the next 3 frames bit-equal to the uninterrupted tracker: the
    keyframe comes back to the card, the poses to the host."""
    from visual_odometry_rs_tpu_torch.utils import checkpoint

    seq = synthetic.generate_sequence(nb_frames=7, height=H, width=W, seed=1,
                                      twist_per_frame=[0.03, 0.0, 0.0, 0.0, 0.003, 0.0])
    config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP,
                                   bucket_candidates=True, warm_start=warm_start)

    def new():
        return tracker.init_tracker(config, seq.intrinsics, 0.0, seq.depths[0], 0.0, seq.grays[0],
                                    device=cuda_device)

    def track(trk, frames):
        out = []
        for f in frames:
            trk.track(float(f), seq.depths[f], float(f), seq.grays[f])
            out.append(torch.cat(trk.current_frame()[1]))
        return torch.stack(out)

    trk = new()
    track(trk, range(1, 4))
    path = str(tmp_path / "tracker.npz")
    checkpoint.save_tracker(path, trk)
    ref = track(trk, range(4, 7))
    resumed = new()
    checkpoint.load_tracker(path, resumed)
    assert resumed.keyframe_data.levels[0].xs.device.type == "cuda"
    assert resumed.current_pose.q.device.type == "cpu"
    assert torch.equal(track(resumed, range(4, 7)), ref)
    assert resumed.keyframe_switches == trk.keyframe_switches >= 1


def test_flow_leaves_padding_out_on_the_card(cuda_device):
    """A coarsest level with padding: the kernel's flow leaves it out, as
    ``track_frame_reference`` does (finite, ``rtol=1e-4``)."""
    config, kf, pyr1 = _keyframe(cuda_device)
    levels = list(kf.levels)
    coarse = levels[-1]
    levels[-1] = coarse._replace(valid=coarse.valid & (torch.arange(coarse.valid.shape[0], device=cuda_device) % 3 > 0),
                                 idepth=torch.where(torch.arange(coarse.valid.shape[0], device=cuda_device) % 3 > 0,
                                                    coarse.idepth, torch.zeros_like(coarse.idepth)))
    padded = tracker.KeyframeData(levels=tuple(levels))
    start = se3.exp(torch.tensor(SMALL, device=cuda_device))
    out = tracker.track_frame(config, padded, pyr1, start)
    ref = tracker.track_frame_reference(config, padded, pyr1, start)
    assert bool(torch.isfinite(out.flow)) and bool(torch.isfinite(ref.flow))
    np.testing.assert_allclose(float(out.flow), float(ref.flow), rtol=1e-4)


def test_loop_verification_lanes_on_the_card(cuda_device):
    """``loop_closure.verify_pairs``: six launches for every pair, each lane
    bit-equal to a one-lane solve of its pair, within the solver's
    tolerances of the CPU's lane-by-lane plain version."""
    from visual_odometry_rs_tpu_torch.models import loop_closure

    seq = synthetic.generate_sequence(nb_frames=6, height=H, width=W, seed=41,
                                      twist_per_frame=[0.02, 0.002, 0.001, 0.001, 0.0, 0.0])
    config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP)
    pairs = [(5, 0), (4, 1), (5, 1)]
    before = lm_solve.lm_solve_level.launches
    ver = loop_closure.verify_pairs(config, seq.intrinsics, seq.poses, seq.depths, seq.grays, pairs, cuda_device)
    assert lm_solve.lm_solve_level.launches - before == LEVELS
    ref = loop_closure.verify_pairs(config, seq.intrinsics, seq.poses, seq.depths, seq.grays, pairs, "cpu")
    np.testing.assert_allclose(ver.model.t.cpu().numpy(), ref.model.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(ver.model.q.cpu().numpy(), ref.model.q.numpy(), atol=1e-6)
    for k, pair in enumerate(pairs):
        one = loop_closure.verify_pairs(config, seq.intrinsics, seq.poses, seq.depths, seq.grays, [pair], cuda_device)
        assert torch.equal(one.model.q[0], ver.model.q[k]) and torch.equal(one.model.t[0], ver.model.t[k])


def test_pose_graph_on_the_card(cuda_device):
    """Both solves on the card: two runs bit-equal, the CPU's result within
    the energy ``rtol=1e-3`` and nodes ``atol=5e-5`` (the LM's flat tail)."""
    from visual_odometry_rs_tpu_torch.parallel import pose_graph

    rng = np.random.default_rng(0)
    gt = [pose.identity()]
    for _ in range(1, 30):
        gt.append(pose.compose(gt[-1], se3.exp(torch.tensor(rng.normal(size=6) * 0.05, dtype=torch.float32))))
    est = [pose.compose(p, se3.exp(torch.tensor(rng.normal(size=6) * 0.01, dtype=torch.float32))) for p in gt]
    nodes = pose.Pose(torch.stack([p.q for p in est]), torch.stack([p.t for p in est]))
    loops = [(25, 2, pose.compose(pose.inverse(gt[25]), gt[2])), (29, 0, pose.compose(pose.inverse(gt[29]), gt[0]))]
    for solver in (pose_graph.solve, pose_graph.solve_sparse):
        graph = pose_graph.odometry_graph(nodes.to(cuda_device), loop_edges=loops)
        a, b = solver(graph), solver(graph)
        assert a.nodes.q.device.type == "cuda"
        assert torch.equal(a.nodes.q, b.nodes.q) and torch.equal(a.nodes.t, b.nodes.t)
        ref = solver(pose_graph.odometry_graph(nodes, loop_edges=loops))
        np.testing.assert_allclose(float(a.energy), float(ref.energy), rtol=1e-3, atol=1e-8)
        np.testing.assert_allclose(a.nodes.t.cpu().numpy(), ref.nodes.t.numpy(), atol=5e-5)


def _window(device, frames=4):
    """A window of ``frames`` frames of a 120x160 sequence, the poses
    perturbed by 3e-3 twists (frame 0 the keyframe)."""
    from visual_odometry_rs_tpu_torch.models import photometric_ba

    seq = synthetic.generate_sequence(nb_frames=frames, height=H, width=W, seed=12)
    config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP)
    kf = tracker.precompute_keyframe(
        config, seq.intrinsics.to(device), torch.from_numpy(seq.depths[0].astype(np.int32)).to(device),
        pyramid.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[0]).to(device)),
    )
    rng = np.random.default_rng(1)
    rel = []
    for f, p in enumerate(seq.poses):
        xi = torch.tensor(rng.normal(size=6) * 3e-3 * (f > 0), dtype=torch.float32)
        rel.append(pose.compose(pose.compose(pose.inverse(p), seq.poses[0]), se3.exp(xi)))
    poses = pose.Pose(torch.stack([p.q for p in rel]).to(device), torch.stack([p.t for p in rel]).to(device))
    images = torch.from_numpy(np.stack(seq.grays).astype(np.float32)).to(device)
    return photometric_ba.window_from_tracking(config, seq.intrinsics.to(device), kf.levels, images, poses)


@pytest.mark.parametrize("options", [{}, {"brightness": True, "robust_delta": 10.0}], ids=["plain", "options"])
def test_window_solve_on_the_card(cuda_device, options):
    """``solve_window`` on the card: two runs bit-equal, the CPU's poses
    within 1e-4 (the LM's accept/reject in a flat tail, ROADMAP C2)."""
    from visual_odometry_rs_tpu_torch.models import photometric_ba

    win = _window(cuda_device)
    a = photometric_ba.solve_window(win, max_iterations=8, **options)
    b = photometric_ba.solve_window(win, max_iterations=8, **options)
    assert a.poses.q.device.type == "cuda"
    for x, y in zip((a.poses.q, a.poses.t, a.idepth, a.energy, a.ab), (b.poses.q, b.poses.t, b.idepth, b.energy, b.ab)):
        assert torch.equal(x, y)
    cpu = photometric_ba.solve_window(_window(torch.device("cpu")), max_iterations=8, **options)
    np.testing.assert_allclose(a.poses.t.cpu().numpy(), cpu.poses.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(a.poses.q.cpu().numpy(), cpu.poses.q.numpy(), atol=1e-4)
    np.testing.assert_allclose(float(a.energy), float(cpu.energy), rtol=1e-3)


def test_sliding_window_on_the_card(cuda_device):
    """A ``SlidingWindow`` through keyframe switches and marginalizations on
    the card: two runs bit-equal, the CPU's frame ids and poses within the
    LM basin (5e-3)."""
    from visual_odometry_rs_tpu_torch.models import sliding_window

    seq = synthetic.generate_sequence(nb_frames=6, height=H, width=W, seed=21,
                                      twist_per_frame=[0.03, 0.01, 0.0, 0.0, 0.01, 0.0])
    config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP)

    def run(device):
        sw = sliding_window.SlidingWindow(config, seq.intrinsics, window_size=3, max_iterations=6, device=device)
        sw.start(seq.depths[0], seq.grays[0], seq.poses[0])
        out = [sw.add_frame(seq.depths[f], seq.grays[f], seq.poses[f]) for f in range(1, len(seq.poses))]
        return out, sw.keyframe_switches

    (a, switches), (b, _), (cpu, cpu_switches) = run(cuda_device), run(cuda_device), run("cpu")
    assert switches == cpu_switches >= 1
    for (ids, poses), (ids_b, poses_b), (ids_c, poses_c) in zip(a, b, cpu):
        assert ids == ids_b == ids_c
        for p, q, c in zip(poses, poses_b, poses_c):
            assert torch.equal(p.t, q.t) and torch.equal(p.q, q.q)
            np.testing.assert_allclose(p.t.numpy(), c.t.numpy(), atol=5e-3)


def test_integer_gradients_on_the_card(cuda_device):
    """The reference's integer gradients (int16, uint16) on the card equal the CPU's."""
    from visual_odometry_rs_tpu_torch.ops import gradient

    img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (37, 53), dtype=np.uint8))
    pyr_c, pyr_g = pyramid.mean_pyramid(4, img), pyramid.mean_pyramid(4, img.to(cuda_device))
    out_c = [*gradient.centered(img), gradient.squared_norm(*gradient.centered(img)),
             *(g for pair in gradient.gradients_xy(pyr_c) for g in pair), *gradient.gradients_squared_norm(pyr_c)]
    out_g = [*gradient.centered(pyr_g[0]), gradient.squared_norm(*gradient.centered(pyr_g[0])),
             *(g for pair in gradient.gradients_xy(pyr_g) for g in pair), *gradient.gradients_squared_norm(pyr_g)]
    for c, g in zip(out_c, out_g):
        assert g.device.type == "cuda" and g.dtype == c.dtype
        assert torch.equal(g.cpu(), c)


def test_affine_align_on_the_card(cuda_device):
    """``affine2d.align`` at 128x160 on the card: two runs bit-equal, the
    CPU's parameters within ``atol=1e-4``, the ground truth within
    ``tests/test_affine2d.py``'s bounds."""
    from visual_odometry_rs_tpu_torch.models import affine2d

    img = synthetic.smooth_image(128, 160, seed=1)
    template, affine_gt = affine2d.random_template(img, seed=2)
    n = affine2d.default_nb_levels(*img.shape)
    t_g, i_g = torch.from_numpy(template).to(cuda_device), torch.from_numpy(img).to(cuda_device)
    (a, failed_a), (b, failed_b) = affine2d.align(t_g, i_g, n), affine2d.align(t_g, i_g, n)
    assert a.device.type == "cuda" and not failed_a and not failed_b and torch.equal(a, b)
    cpu, _ = affine2d.align(torch.from_numpy(template), torch.from_numpy(img), n)
    np.testing.assert_allclose(a.cpu().numpy(), cpu.numpy(), atol=1e-4)
    w = affine2d.warp_matrix(a).cpu().numpy()[:2]
    np.testing.assert_allclose(w[:, :2], affine_gt[:, :2], atol=5e-3)
    np.testing.assert_allclose(w[:, 2], affine_gt[:, 2], atol=0.5)


def test_ba_solve_on_the_card(cuda_device):
    """Window BA (K=16, P=256) on the card: two runs bit-equal, the CPU's
    poses within ``atol=1e-5`` m.  LM iterations within 2: without noise the
    stop rule ``d_energy < 1e-6 (E + 1)`` is met on f32 noise of an energy
    near 2.5e-7 px², so the order of summation decides it (ROADMAP C2;
    measured 4 on the card against 6 on the CPU)."""
    from visual_odometry_rs_tpu_torch.parallel import ba

    problem, _, _ = ba.synthetic_problem(K=16, P=256, seed=5, perturb=0.01, device=cuda_device)
    a, b = ba.solve(problem), ba.solve(problem)
    assert a.points.device.type == "cuda"
    for x, y in zip((a.poses.q, a.poses.t, a.points, a.energy), (b.poses.q, b.poses.t, b.points, b.energy)):
        assert torch.equal(x, y)
    cpu = ba.solve(ba.synthetic_problem(K=16, P=256, seed=5, perturb=0.01)[0])
    assert abs(int(a.nb_iter) - int(cpu.nb_iter)) <= 2
    np.testing.assert_allclose(a.poses.t.cpu().numpy(), cpu.poses.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(a.points.cpu().numpy(), cpu.points.numpy(), atol=1e-4)


def test_track_synthetic_example_on_the_card(cuda_device):
    """The ``track_synthetic`` example on the card: one solver launch a
    level and frame (5 levels x 7 frames), the CPU's ATE within 5%."""
    import contextlib
    import io

    from visual_odometry_rs_tpu_torch.examples import track_synthetic

    before = lm_solve.lm_solve_level.launches
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        err = track_synthetic.main([])
        err_cpu = track_synthetic.main(["--cpu"])
    assert lm_solve.lm_solve_level.launches - before == 5 * 7
    assert abs(err - err_cpu) <= 0.05 * err_cpu
