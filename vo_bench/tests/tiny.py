"""A cell cut to a CPU test's size: 60x80, 3 levels, cap 512, 3 lanes, a
24-frame loop at six times the speed (so that keyframes switch)."""

import copy

import harness

TINY_LIMITS = {"samples": 6, "start_samples": 3, "pose_t_gap_m.median": 1e-4, "pose_t_gap_m.q75": 1e-4, "start_t_gap_m": 1e-4,
               "pose_r_gap_rad.median": 1e-4, "decision_flips": 0, "flow_band_px": 0.05}


def tiny_cell(cell_name: str, height: int = 60, width: int = 80):
    cell = harness.find_cell(harness.load_manifest(), cell_name)
    cfg = copy.deepcopy(harness.load_json("configs", cell["config"]))
    traffic = copy.deepcopy(harness.load_json("traffic", cell["traffic"]))
    s = width / cfg["width"]
    cx, cy, fx, fy = cfg["intrinsics"]
    cfg.update(height=height, width=width, intrinsics=[(cx + 0.5) * s - 0.5, (cy + 0.5) * s - 0.5, fx * s, fy * s],
               nb_levels=3, candidate_cap=512, lanes=min(int(cfg["lanes"]), 3))
    traffic["loop_frames"] = 24
    traffic["motion"] = {k: 6 * v for k, v in traffic["motion"].items()}
    traffic.update(warmup_frames=12, trace_frames=4, warmup_clips=1, trace_clips=1)
    return cell, cfg, traffic
