"""The system under test, built from a configuration file: the port's
``TrackerConfig`` and intrinsics, as ``cli/vors_track.py`` and
``cli/vors_batch.py`` build them from their flags."""

from __future__ import annotations

from visual_odometry_rs_tpu_torch.core.camera import Intrinsics
from visual_odometry_rs_tpu_torch.models.tracker import TrackerConfig

TRACKER_KEYS = (
    "nb_levels", "candidates_diff_threshold", "depth_scale", "idepth_variance", "lm_coef_init",
    "max_iterations", "energy_tol", "warm_start", "flow_threshold", "candidate_cap",
    "bucket_candidates", "robust_delta", "brightness_model", "candidate_selector",
)


def tracker_config(cfg: dict) -> TrackerConfig:
    return TrackerConfig(height=int(cfg["height"]), width=int(cfg["width"]),
                         **{k: cfg[k] for k in TRACKER_KEYS})


def intrinsics(cfg: dict, device) -> Intrinsics:
    cx, cy, fx, fy = cfg["intrinsics"]
    return Intrinsics.make(cx, cy, fx, fy, 0.0, device=device)
