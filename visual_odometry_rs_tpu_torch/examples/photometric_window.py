"""Windowed photometric bundle adjustment: multi-frame depth refinement.

The port of ``examples/photometric_window.py``: jointly refine a keyframe
window's poses and the keyframe candidates' inverse depths by minimizing
the photometric residuals of every (frame, candidate) pair with a
Schur-reduced LM solve (``models.photometric_ba.solve_window``).  A noisy
depth sensor is simulated (5% inverse-depth noise); the window consolidates
the frames' photometric evidence and cuts the depth error, with the
sensor's prior weighted by its variance.

    python -m visual_odometry_rs_tpu_torch.examples.photometric_window [--cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..dataset import synthetic
from ..math import pose as pose_mod
from ..math.pose import Pose
from ..models import photometric_ba
from ..models import tracker as tracker_mod
from ..ops import pyramid as pyramid_ops
from ..utils.types import depth_tensor, image_tensor, to_numpy
from ._common import device_of, parser


def main(argv=None):
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    device = device_of(args)
    h, w, F = 120, 160, 6
    seq = synthetic.generate_sequence(nb_frames=F, height=h, width=w, seed=3, motion_scale=0.02)
    config = tracker_mod.TrackerConfig(height=h, width=w, nb_levels=3, candidate_cap=1024)
    intrinsics = seq.intrinsics.to(device)
    pyr0 = pyramid_ops.mean_pyramid(config.nb_levels, image_tensor(seq.grays[0], device))
    kf = tracker_mod.precompute_keyframe(config, intrinsics, depth_tensor(seq.depths[0], device), pyr0)
    images = torch.from_numpy(np.stack(seq.grays).astype(np.float32)).to(device)

    gt_rel = [pose_mod.compose(pose_mod.inverse(p), seq.poses[0]) for p in seq.poses]
    gt_poses = Pose(torch.stack([p.q for p in gt_rel]).to(device), torch.stack([p.t for p in gt_rel]).to(device))

    win = photometric_ba.window_from_tracking(config, intrinsics, kf.levels, images, gt_poses)
    # a noisy depth sensor: 5% multiplicative inverse-depth noise
    rng = np.random.default_rng(0)
    true_idepth = win.idepth
    noise = torch.from_numpy((1.0 + 0.05 * rng.normal(size=tuple(true_idepth.shape))).astype(np.float32))
    win = win._replace(idepth=torch.where(win.valid, true_idepth * noise.to(device), true_idepth))

    # the prior's weight matches the simulated sensor: sigma_d ~ 5% of an
    # inverse depth of ~0.02 -> 1/0.02^2 over the intensity noise, a few hundred
    result = photometric_ba.solve_window(win, max_iterations=30, idepth_prior_weight=400.0)

    valid = to_numpy(win.valid)
    err_before = np.abs(to_numpy(win.idepth) - to_numpy(true_idepth))[valid]
    err_after = np.abs(to_numpy(result.idepth) - to_numpy(true_idepth))[valid]
    pose_err = np.abs(to_numpy(result.poses.t) - to_numpy(gt_poses.t)).max()
    print(f"window of {F} frames, {int(valid.sum())} candidates")
    print(f"LM iterations: {int(result.nb_iter)}, final energy {float(result.energy):.1f}")
    print(f"inverse-depth mean |error|: {err_before.mean():.4f} -> {err_after.mean():.4f}")
    print(f"pose max |t error|: {1e3 * pose_err:.2f} mm (photometric bias floor)")
    return err_before.mean(), err_after.mean(), pose_err


if __name__ == "__main__":
    main()
