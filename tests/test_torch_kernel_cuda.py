"""The CUDA kernel K1 (``csrc/residual_reduce.cu``) against its plain torch
twin, on the card.  Every test here needs a CUDA device and skips without
one; the file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_kernel_cuda.py -q

Tolerances, as for the twin against the JAX package: energy ``rtol=1e-5``;
g and H ``rtol=1e-4, atol=1e-5`` after scaling by their max; the inside
count equal; ``track_frame`` through the kernel within the LM stopping basin
of the twin's (``t`` to ``atol=5e-3``).
"""

import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu_torch.dataset import synthetic
from visual_odometry_rs_tpu_torch.math import pose, se3
from visual_odometry_rs_tpu_torch.models import tracker
from visual_odometry_rs_tpu_torch.ops import pyramid, residual

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


def _keyframe(device):
    seq = synthetic.generate_sequence(nb_frames=2, height=H, width=W, seed=0)
    config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP)
    kf = tracker.precompute_keyframe(
        config, seq.intrinsics.to(device),
        torch.from_numpy(seq.depths[0].astype(np.int32)).to(device),
        pyramid.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[0]).to(device)),
    )
    return config, kf, pyramid.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[1]).to(device))


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
    before = residual.residual_reduce.launches
    out = tracker.track_frame(config, kf, pyr1, pose.identity(device=cuda_device))
    launches = residual.residual_reduce.launches - before
    assert launches == sum(n + 1 for n in out.nb_iters)  # one per _eval_full
    _, kf_cpu, pyr1_cpu = _keyframe("cpu")
    ref = tracker.track_frame(config, kf_cpu, pyr1_cpu, pose.identity())
    assert out.failed == ref.failed is False
    np.testing.assert_allclose(out.model.t.cpu().numpy(), ref.model.t.numpy(), atol=5e-3)
    np.testing.assert_allclose(float(out.flow), float(ref.flow), rtol=0.15, atol=2e-2)
